"""The benchmark's inputs, drawn from ``--seed``: frames and hand crops.

Frames are uniform uint8 noise drawn on the device with one
``torch.Generator`` call and brought to the host once, where the detectors
take them.  Crop geometry comes from numpy's ``default_rng(seed)``, which
takes any non-negative seed: every seed gets the same multiset of crop
sides in another order, so the work of a run does not depend on the seed.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

FRAME_STREAM = 1      # seed offsets of the independent draws
CROP_STREAM = 2


def seeded_frames(seed: int, n: int, hw: Tuple[int, int], device
                  ) -> np.ndarray:
    """(n, H, W, 3) uint8 noise frames (BGR, as a camera gives them)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + FRAME_STREAM) % 2**63)
    frames = torch.randint(0, 256, (n, *hw, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    return frames.cpu().numpy()


def crop_requests(seed: int, frames: np.ndarray, requests: int,
                  per_request: int, side_range: Tuple[int, int],
                  left_share: float, calib: int):
    """``requests`` lists of ``per_request`` square crops and their hand
    types, and ``calib`` calibration crops.  The sides are the same
    multiset for every seed: ``requests * per_request`` values evenly over
    ``side_range``, shuffled; each crop's centre and source frame are
    drawn uniformly (the crop lies inside its frame); each request holds
    ``left_share`` left hands."""
    rng = np.random.default_rng((int(seed) + CROP_STREAM) % 2**63)
    n = requests * per_request + calib
    lo, hi = side_range
    sides = np.round(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(int)
    sides = rng.permutation(sides)
    h, w = frames.shape[1:3]
    crops: List[np.ndarray] = []
    for side in sides:
        f = frames[rng.integers(len(frames))]
        top = int(rng.integers(0, h - side + 1))
        left = int(rng.integers(0, w - side + 1))
        crops.append(f[top:top + side, left:left + side].copy())
    n_left = int(round(per_request * left_share))
    out = []
    for r in range(requests):
        types = ["left"] * n_left + ["right"] * (per_request - n_left)
        types = [types[i] for i in rng.permutation(per_request)]
        out.append((crops[r * per_request:(r + 1) * per_request], types))
    return out, crops[requests * per_request:]


class PhaseClock:
    """Seconds of each phase of a set-up, the device drained at each mark
    (the set-up's end drains it anyway)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.parts = {}
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.parts[name] = now - self._last
        self._last = now
