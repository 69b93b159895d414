"""Synthetic labeled-crop dataset for smoke-training any of the three nets
(a copy of ``tpupose/data/synthetic.py``: the same samples, bit for bit).

No face or hand keypoint dataset exists, and COCO is not in the
repository: deterministic random crops with bright Gaussian blobs painted
at the keypoint locations give a net real signal to fit (the loss falls),
and every keypoint count (18 pose, 70 face, 21 hand) runs the same
``BatchLoader`` -> GT render -> loss path as real data.

Samples follow the ``CocoPoseDataset.sample`` protocol:
``(img u8 (S, S, 3), poses (P, K, 3) f32, ignore_mask (S, S) bool)``.
"""

from __future__ import annotations

import numpy as np


class SyntheticCropDataset:
    """Deterministic synthetic keypoint crops.

    num_keypoints: 18 (pose), 70 (face) or 21 (hand) — anything the GT
    renderer supports.  Each sample has one "person" whose keypoints are
    uniform-random in the central 80% of the crop, marked v=2 (labeled,
    like COCO's visible flag)."""

    def __init__(self, num_keypoints: int, insize: int = 368,
                 n_samples: int = 64, seed: int = 0,
                 blob_sigma: float = 4.0):
        self.num_keypoints = num_keypoints
        self.insize = insize
        self.n_samples = n_samples
        self.seed = seed
        self.blob_sigma = blob_sigma
        # per-worker reseeding hook used by BatchLoader._worker_init;
        # sampling itself is index-keyed so it is unused here, but the
        # attribute must exist for the process-pool path.
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self.n_samples

    def sample(self, index: int):
        rng = np.random.RandomState(
            (self.seed * 1000003 + index * 9176 + 11) % (2 ** 31))
        s = self.insize
        img = rng.randint(0, 48, (s, s, 3)).astype(np.float32)

        lo, hi = 0.1 * s, 0.9 * s
        xy = rng.uniform(lo, hi, (self.num_keypoints, 2)).astype(np.float32)
        poses = np.concatenate(
            [xy, np.full((self.num_keypoints, 1), 2.0, np.float32)],
            axis=1)[None]  # (1, K, 3)

        # bright blob per keypoint: the learnable signal
        gx = np.arange(s, dtype=np.float32)[None, :]
        gy = np.arange(s, dtype=np.float32)[:, None]
        amp = np.zeros((s, s), np.float32)
        for x, y in xy:
            d2 = (gx - x) ** 2 + (gy - y) ** 2
            amp = np.maximum(amp,
                             np.exp(-0.5 * d2 / self.blob_sigma ** 2))
        img += 200.0 * amp[:, :, None]
        img = np.clip(img, 0, 255).astype(np.uint8)

        ignore_mask = np.zeros((s, s), bool)
        return img, poses, ignore_mask
