"""The crop-keypoint engine behind FaceDetector and HandDetector (port of
``tpupose/detectors/crop_keypoints.py``).

Per ``detect_crops`` call: the raw crops are packed into one buffer and
uploaded, then all of them are resized to ``cfg.img_size`` square on the
detector's device in one ``resize_u8_linear_batch`` (cv2's uint8
INTER_LINEAR, emulated exactly; a crop is mirrored first where asked: the
left-hand path), normalized by **/256 - 0.5** (the crop nets' convention,
not the pose net's /255), and go through ONE batched forward.  Every
crop's tail runs in one ``crop_tails`` call (``ops/crop_tail.py``: on the
card one ``csrc/crop_tail.cu`` launch per request of up to 64 crops): the
last stage's heatmaps resized (align corners) to the crop's size,
un-mirrored where the input was, blurred and reduced to one keypoint per
channel, the first maximum; every crop's ``(x, y, score, valid)`` comes
back to the host in one device-to-host copy.

The network is ``detectors/net.py``'s ``DetectorNet``, held as
``self.net``.  ``compute_dtype=torch.bfloat16`` runs it in bfloat16 with
its parameters stored in it (the JAX package's
``commit_variables(dtype=...)``); it returns float32 maps.  ``quantize()``
swaps the network forward for the w8a8 int8 one of
``tpupose_torch/quant.py`` (input quant ``u8 - 128``, scale 1/256).

``_batch_forward_fn`` and ``_tail_fn`` are the two programs a crop bundle
exports (``tpupose_torch/serving.py::save_crop_bundle``); the live
``submit_crops`` runs the same bodies with the detector's own weights.

A request's stages run in ``utils.profiling.annotate`` spans:
``crop.upload`` (packing the raw crops and their copy), ``crop.resize``
(``resize_u8_linear_batch``), ``crop.forward`` (``forward_maps``),
``crop.postprocess`` (``crop_tails`` over every crop, one span) and
``crop.fetch`` (``collect_crops``'s copy, its wait and the keypoint
lists).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpupose_torch.detectors.net import (DetectorNet, NetHolder,
                                         float32_numerics)
from tpupose_torch.ops.library import crop_tails
from tpupose_torch.ops.resize import (pack_u8_images, resize_chainer,
                                      resize_u8_linear,
                                      resize_u8_linear_batch)
from tpupose_torch.utils.profiling import annotate


def preprocess_crops_u8(imgs_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 ``/256 - 0.5``, channels last."""
    return imgs_u8.float() / 256.0 - 0.5


class CropKeypointDetector(NetHolder):
    """Runs a single-branch CPM net (FaceNet, HandNet) on square-resized
    crops and extracts one keypoint per channel."""

    def __init__(self, arch: str, cfg,
                 weights_file: Optional[str] = None,
                 params=None,
                 device="cuda",
                 seed: int = 0,
                 tail_stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        """``params``: a Flax param tree (numpy leaves) to load;
        ``weights_file``: a Chainer ``.npz``; otherwise the model keeps its
        weights drawn from ``seed``.  ``compute_dtype``: ``torch.float32``
        or ``torch.bfloat16``, the net's compute dtype and its parameters'.

        ``tail_stride`` > 1 rounds each crop's tail-resize target up to a
        multiple, so crops of many sizes share few tail shapes; keypoint
        coordinates are rescaled back to the true crop size (<= ~1 px
        shift).  1 = the exact per-crop semantics."""
        self.net = DetectorNet(arch, device, type(self).__name__,
                               weights_file, params, seed, compute_dtype)
        self.device = self.net.device
        self.arch = arch
        self.cfg = cfg
        self.tail_stride = tail_stride
        self.compute_dtype = compute_dtype

    def quantize(self, calib_crops, conv7_impl: Optional[str] = None
                 ) -> None:
        """Switch to post-training w8a8 int8 inference (see
        ``PoseDetector.quantize``).  ``calib_crops``: a few representative
        HWC uint8 crops of any sizes, each resized to ``cfg.img_size``
        square; ``conv7_impl``: ``"kernel"`` (CUDA only, the default there)
        or ``"im2col"`` (the CPU default)."""
        self.net.quantize(calib_crops, self.cfg.img_size,
                          preprocess_crops_u8, conv7_impl)

    # ------------------------------------------------------------------

    def prepare_crops(self, crops: Sequence[np.ndarray],
                      flips: Sequence[bool]) -> np.ndarray:
        """HWC uint8 crops -> (B, S, S, 3) uint8 network inputs, S =
        ``cfg.img_size``, on the host; a flipped crop is mirrored first.
        ``submit_crops`` computes the same bytes on the detector's
        device."""
        size = self.cfg.img_size
        return np.stack([
            resize_u8_linear(np.asarray(c)[:, ::-1] if f else np.asarray(c),
                             (size, size)) for c, f in zip(crops, flips)])

    def forward_maps(self, imgs_u8) -> torch.Tensor:
        """(B, S, S, 3) uint8 network inputs, a tensor on the detector's
        device or a numpy batch (uploaded first) -> every stage's heatmaps
        (stages, B, S/8, S/8, C) on the detector's device: the int8 forward
        once quantized, else the float32 model."""
        if not isinstance(imgs_u8, torch.Tensor):
            with annotate("crop.upload"):
                imgs_u8 = torch.from_numpy(
                    np.ascontiguousarray(imgs_u8)).to(self.device)
        with annotate("crop.forward"), float32_numerics(), torch.no_grad():
            return self.net(preprocess_crops_u8(imgs_u8))

    def _batch_forward_fn(self):
        """The crop forward program: ``(weights, imgs_u8)``, (B, S, S, 3)
        uint8 network inputs -> the last stage's (B, S/8, S/8, C)
        heatmaps."""

        def fn(weights, imgs_u8):
            return self.net(preprocess_crops_u8(imgs_u8), weights)[-1]

        return fn

    def _tail_target(self, crop_hw: Tuple[int, int]):
        """Tail-resize target (== crop size at stride 1) and the coordinate
        rescale back to true crop pixels (align-corners mapping)."""
        s = self.tail_stride
        h, w = crop_hw
        if s <= 1:
            return (h, w), (1.0, 1.0)
        th = -(-h // s) * s
        tw = -(-w // s) * s
        return (th, tw), ((w - 1) / max(tw - 1, 1),
                          (h - 1) / max(th - 1, 1))

    @staticmethod
    def tail_maps(hm: torch.Tensor, target_hw: Tuple[int, int],
                  flip: bool) -> torch.Tensor:
        """One crop's last-stage heatmaps (h, w, C) -> the (C - 1, th, tw)
        maps its keypoints are taken from: resized to ``target_hw``,
        un-mirrored if the input was, background dropped.  The resize is a
        matmul: run it inside ``float32_numerics()``.  The tails themselves
        run ``crop_tails``, whose resize equals this one on the CPU bit for
        bit; this is its per-crop statement, which the tests and
        ``chip_smoke.py`` read."""
        hm = resize_chainer(hm, target_hw)
        if flip:
            hm = torch.flip(hm, dims=(1,))
        return hm.permute(2, 0, 1)[:-1]

    def _tail_fn(self, target_hw: Tuple[int, int], flip: bool):
        """A crop tail's program: one crop's last-stage heatmaps (h, w, C)
        -> its (4, C - 1) rows of x, y, score and valid, as float32
        (coordinates are exact in float32 below 2^24): ``crop_tails`` on a
        batch of one, so a bundle's tail equals the live detector's."""

        def fn(hm):
            return crop_tails(hm[None].contiguous(), [target_hw], [flip],
                              self.cfg.gaussian_sigma,
                              self.cfg.heatmap_peak_thresh)[0]

        return fn

    def submit_crops(self, crops, flips=None):
        """Queue the batched forward and every crop's tail without a
        device-to-host copy; returns a pending handle for
        ``collect_crops``."""
        if not crops:
            return []
        flips = list(flips) if flips else [False] * len(crops)
        size = self.cfg.img_size
        with annotate("crop.upload"):
            packed, descriptors = pack_u8_images(
                crops, flips, pin_memory=self.device.type == "cuda")
            packed = packed.to(self.device, non_blocking=True)
        with annotate("crop.resize"):
            imgs = resize_u8_linear_batch(packed, descriptors, (size, size))
        heatmaps = self.forward_maps(imgs)[-1]
        with annotate("crop.postprocess"):
            return self.submit_tails(
                heatmaps, [np.asarray(c).shape[:2] for c in crops], flips)

    def submit_tails(self, heatmaps: torch.Tensor,
                     crop_hws: Sequence[Tuple[int, int]],
                     flips: Sequence[bool]):
        """The tails of ``submit_crops`` on last-stage heatmaps (B, h, w, C)
        already computed for crops of sizes ``crop_hws``: one
        ``crop_tails`` call for all of them."""
        targets, scales = zip(*(self._tail_target(tuple(hw))
                                for hw in crop_hws))
        with torch.no_grad():
            rows = crop_tails(heatmaps.contiguous(), targets, flips,
                              self.cfg.gaussian_sigma,
                              self.cfg.heatmap_peak_thresh)
        return rows, list(scales)

    def collect_crops(self, pending) -> List[list]:
        """Copy a ``submit_crops`` handle's results to the host (one copy);
        per crop, a list of ``[x, y, score]`` or None per channel."""
        if not pending:
            return []
        rows, scales = pending
        with annotate("crop.fetch"):
            rows = rows.cpu().numpy()
            return [self._to_keypoints(r, scale)
                    for r, scale in zip(rows, scales)]

    @staticmethod
    def _to_keypoints(row: np.ndarray, scale=(1.0, 1.0)):
        """(4, C) rows of x, y, score, valid -> per channel ``[x, y, score]``
        in crop pixels, or None below the threshold."""
        xs, ys = row[0].astype(np.int64), row[1].astype(np.int64)
        score, valid = row[2], row[3] > 0
        sx, sy = scale
        return [
            [int(round(xs[i] * sx)), int(round(ys[i] * sy)),
             float(score[i])] if valid[i] else None
            for i in range(len(xs))
        ]

    def detect_crops(self, crops, flips=None):
        """All crops through one batched forward; keypoint lists per
        crop."""
        return self.collect_crops(self.submit_crops(crops, flips))

    def detect_crop(self, crop: np.ndarray, flip: bool = False):
        """One crop -> its keypoint list (a batch of one)."""
        return self.detect_crops([crop], [flip])[0]
