"""Geometry-bucketed detection over a fixed canvas palette (port of
``tpupose/detectors/bucketed.py``).

``BucketedPoseDetector`` wraps any detector with the ``submit`` /
``collect`` protocol (live fast or precise, quantized, serving bundles):

1. pick the palette canvas that the aspect-preserving fit fills best;
2. resize the frame to fit with ``resize_u8_linear`` (cv2's uint8
   INTER_LINEAR, emulated), place it top-left, and fill the rest with
   ``cfg.pad_value``;
3. run the wrapped detector on the canvas;
4. drop keypoints that landed in the pad band and rescale the rest back to
   original pixels.

A bundle serves only the sizes it was exported for, so a palette of its
``image_sizes`` lets it take frames of any size.  ``detect_batch`` groups
the frames by canvas and hands each group to the wrapped detector's batched
path in one call.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpupose_torch.ops.resize import resize_u8_linear

# Aspect ratios (w:h) from portrait 1:2 to landscape 2:1.
DEFAULT_ASPECTS: Tuple[float, ...] = (
    0.5, 9 / 16, 2 / 3, 3 / 4, 1.0, 4 / 3, 3 / 2, 16 / 9, 2.0)


def canvas_palette(base_long: int = 640,
                   aspects: Sequence[float] = DEFAULT_ASPECTS,
                   stride: int = 8) -> List[Tuple[int, int]]:
    """(H, W) canvases: long side ``base_long``, short side set by each
    aspect ratio, both rounded up to ``stride`` multiples."""
    out = []
    for a in aspects:
        if a >= 1.0:
            h, w = base_long / a, base_long
        else:
            h, w = base_long, base_long * a
        rounded = (stride * math.ceil(h / stride),
                   stride * math.ceil(w / stride))
        if rounded not in out:
            out.append(rounded)
    return out


def best_canvas(h: int, w: int,
                canvases: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """The canvas the aspect-preserving fit fills best (max image-area
    fraction after scaling by ``min(ch/h, cw/w)``)."""
    def fill(c):
        s = min(c[0] / h, c[1] / w)
        return (s * h) * (s * w) / (c[0] * c[1])

    return max(canvases, key=fill)


class BucketedPoseDetector:
    """Wraps a pose detector so frames of any size run on a fixed canvas
    palette: the wrapped detector only ever sees ``len(canvases)``
    geometries."""

    def __init__(self, detector,
                 canvases: Optional[Sequence[Tuple[int, int]]] = None,
                 edge_margin: float = 2.0):
        """``edge_margin``: canvas pixels past the placed image's edge a
        keypoint may land (map-resolution rounding) and still be kept;
        anything deeper in the pad band is pad content and dropped."""
        self.detector = detector
        if canvases is None:
            canvases = canvas_palette()
        self.canvases = [tuple(int(t) for t in c) for c in canvases]
        if not self.canvases:
            raise ValueError("need at least one canvas")
        self.edge_margin = float(edge_margin)
        # serving layers key their geometry policy off this: every size is
        # absorbed into the palette
        self.absorbs_geometry = True

    def _place(self, orig_img: np.ndarray):
        """The frame on its canvas; returns (canvas, placed (s_h, s_w),
        original (h, w))."""
        orig_img = np.asarray(orig_img)
        h, w = orig_img.shape[:2]
        c_h, c_w = best_canvas(h, w, self.canvases)
        s = min(c_h / h, c_w / w)
        s_h = min(c_h, max(1, round(h * s)))
        s_w = min(c_w, max(1, round(w * s)))
        cfg = getattr(self.detector, "cfg", None)
        pad_value = cfg.pad_value if cfg is not None else (104, 117, 123)
        canvas = np.empty((c_h, c_w, 3), np.uint8)
        canvas[...] = np.asarray(pad_value, np.uint8)
        canvas[:s_h, :s_w] = (
            orig_img if (s_h, s_w) == (h, w)
            else resize_u8_linear(orig_img, (s_w, s_h)))
        return canvas, (s_h, s_w), (h, w)

    def _to_original(self, poses, scores, placed, orig):
        """A canvas result -> the original frame's: pad-band keypoints
        dropped, the rest rescaled (clamped to the open image bound)."""
        (s_h, s_w), (h, w) = placed, orig
        if len(poses) == 0:
            return poses, scores
        poses = np.array(poses, copy=True)
        present = poses[:, :, 2] > 0
        in_img = (present
                  & (poses[:, :, 0] <= s_w - 1 + self.edge_margin)
                  & (poses[:, :, 1] <= s_h - 1 + self.edge_margin))
        poses[~in_img] = 0.0
        poses[:, :, 0] = np.clip(poses[:, :, 0] * (w / s_w), 0, w - 1e-3)
        poses[:, :, 1] = np.clip(poses[:, :, 1] * (h / s_h), 0, h - 1e-3)
        keep = in_img.any(axis=1)
        return poses[keep], np.asarray(scores)[keep]

    # -- the submit/collect protocol -------------------------------------

    def submit(self, orig_img: np.ndarray):
        canvas, placed, orig = self._place(orig_img)
        return self.detector.submit(canvas), placed, orig

    def collect(self, pending):
        handle, placed, orig = pending
        poses, scores = self.detector.collect(handle)
        return self._to_original(poses, scores, placed, orig)

    def __call__(self, orig_img: np.ndarray):
        return self.collect(self.submit(orig_img))

    def _batches(self, canvas_hw) -> bool:
        """Whether the wrapped detector has a batched path at this canvas:
        a live ``detect_batch``, or a bundle's batched programs."""
        if not hasattr(self.detector, "detect_batch"):
            return False
        sizes = getattr(self.detector, "batch_sizes", None)
        return not callable(sizes) or bool(sizes(canvas_hw))

    def detect_batch(self, imgs) -> list:
        """Frames of any sizes: those that share a canvas go to the wrapped
        detector's ``detect_batch`` in one call per canvas (frame by frame
        through ``submit`` / ``collect`` where it has no batched path);
        results come back in input order."""
        placed = [self._place(img) for img in imgs]
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, (canvas, _, _) in enumerate(placed):
            groups.setdefault(canvas.shape[:2], []).append(i)
        out: list = [None] * len(placed)
        for canvas_hw, idx in groups.items():
            canvases = np.stack([placed[i][0] for i in idx])
            if self._batches(canvas_hw):
                results = self.detector.detect_batch(canvases)
            else:
                results = [self.detector.collect(self.detector.submit(c))
                           for c in canvases]
            for i, (poses, scores) in zip(idx, results):
                out[i] = self._to_original(poses, scores, *placed[i][1:])
        return out

    # -- passthroughs the serving layer reads ------------------------------

    @property
    def cfg(self):
        return getattr(self.detector, "cfg", None)

    @property
    def arch(self):
        return getattr(self.detector, "arch", "posenet")

    @property
    def precise(self):
        return getattr(self.detector, "precise", False)

    @property
    def quantized(self):
        return getattr(self.detector, "quantized", False)

    @property
    def image_sizes(self):
        """Servable sizes: any; the palette absorbs every geometry."""
        return [list(c) for c in self.canvases]

    def warm(self, verbose: bool = False) -> None:
        """Run every canvas once at startup, so that no request pays a
        first sight (cuDNN's heuristics, kernel builds)."""
        for c_h, c_w in self.canvases:
            if verbose:
                print(f"warming canvas {c_h}x{c_w}...", flush=True)
            self.collect(self.submit(np.zeros((c_h, c_w, 3), np.uint8)))
