"""The crop-keypoint engine behind FaceDetector and HandDetector (port of
``tpupose/detectors/crop_keypoints.py``).

Per ``detect_crops`` call: each crop (mirrored with a numpy flip where
asked: the left-hand path) is resized on the host to ``cfg.img_size``
square with ``resize_u8_linear`` (cv2's uint8 INTER_LINEAR, emulated
exactly), normalized by **/256 - 0.5** (the crop nets' convention, not the
pose net's /255), and all crops go through ONE batched forward on the
detector's device.  Per crop, the last stage's heatmaps are resized
(align corners) to the crop's size, un-mirrored with ``torch.flip`` where
the input was, blurred and reduced to one keypoint per channel
(``global_argmax_keypoints``); every crop's ``(x, y, score, valid)`` comes
back to the host in one device-to-host copy.

``compute_dtype=torch.bfloat16`` runs the net in bfloat16 with its
parameters stored in it (the JAX package's ``commit_variables(dtype=...)``);
the net returns float32 maps.  ``quantize()`` swaps the network forward for
the w8a8 int8 one of ``tpupose_torch/quant.py`` (input quant ``u8 - 128``,
scale 1/256).

``_batch_forward_fn`` and ``_tail_fn`` are the two programs a crop bundle
exports (``tpupose_torch/serving.py::save_crop_bundle``); the live
``submit_crops`` runs the same bodies with the detector's own weights.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from tpupose_torch.detectors.pose import float32_numerics
from tpupose_torch.models import ARCHS
from tpupose_torch.ops.peaks import global_argmax_keypoints
from tpupose_torch.ops.resize import resize_chainer, resize_u8_linear
from tpupose_torch.quant import (calibrate_ranges, make_quant_apply,
                                 model_params, qtree_to_device, quant_apply,
                                 quantize, resolve_conv7_impl)
from tpupose_torch.weights import (load_chainer_npz, load_flax_params,
                                   warn_on_load_report)


def preprocess_crops_u8(imgs_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 ``/256 - 0.5``, channels last."""
    return imgs_u8.float() / 256.0 - 0.5


class CropKeypointDetector:
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
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}(device={device!r}): "
                               "CUDA is not available")
        self.arch = arch
        self.cfg = cfg
        self.tail_stride = tail_stride
        self.compute_dtype = compute_dtype
        self.model = ARCHS[arch](seed=seed, dtype=compute_dtype)
        if params is not None:
            load_flax_params(self.model, params)
        elif weights_file:
            report = load_chainer_npz(self.model, weights_file)
            warn_on_load_report(report, weights_file, arch=arch)
        self.model = self.model.to(self.device, compute_dtype).eval()
        # set by quantize()
        self.quantized = False
        self.qtree = None
        self.quant_static = None
        self.conv7_impl = None
        self._quant_forward = None

    def quantize(self, calib_crops, conv7_impl: Optional[str] = None
                 ) -> None:
        """Switch to post-training w8a8 int8 inference (see
        ``PoseDetector.quantize``).  ``calib_crops``: a few representative
        HWC uint8 crops of any sizes, each resized to ``cfg.img_size``
        square; ``conv7_impl``: ``"kernel"`` (CUDA only, the default there)
        or ``"im2col"`` (the CPU default)."""
        if self.quantized:
            raise ValueError("detector is already quantized")
        conv7_impl = resolve_conv7_impl(conv7_impl, self.device)
        size = self.cfg.img_size
        frames = np.stack([resize_u8_linear(np.asarray(c), (size, size))
                           for c in calib_crops])
        with float32_numerics():
            ranges = calibrate_ranges(self.model, preprocess_crops_u8(
                torch.from_numpy(frames).to(self.device)))
        self.qtree, self.quant_static = quantize(self.arch, self.model,
                                                 ranges)
        self._quant_forward = make_quant_apply(
            self.quant_static,
            qtree_to_device(self.qtree, self.quant_static, self.device,
                            pack_kernels=conv7_impl == "kernel"),
            conv7_impl)
        self.quantized = True
        self.conv7_impl = conv7_impl

    # ------------------------------------------------------------------

    def prepare_crops(self, crops: Sequence[np.ndarray],
                      flips: Sequence[bool]) -> np.ndarray:
        """HWC uint8 crops -> (B, S, S, 3) uint8 network inputs, S =
        ``cfg.img_size``; a flipped crop is mirrored first."""
        size = self.cfg.img_size
        return np.stack([
            resize_u8_linear(np.asarray(c)[:, ::-1] if f else np.asarray(c),
                             (size, size)) for c, f in zip(crops, flips)])

    def host_weights(self):
        """The weights as host data: the Flax param tree of a float32
        detector, the numpy int8 tree of a quantized one."""
        if self.quantized:
            return self.qtree
        return {"params": model_params(self.model)}

    def program_weights(self, device=None):
        """The weights as a traced program takes them, on ``device``
        (default: the detector's): ``state_dict``, or the quantized
        ``qtree_to_device`` tree, packed on the kernel route."""
        device = torch.device(device or self.device)
        if self.quantized:
            return qtree_to_device(self.qtree, self.quant_static, device,
                                   pack_kernels=self.conv7_impl == "kernel")
        return {k: v.detach().to(device)
                for k, v in self.model.state_dict().items()}

    def _net(self, x: torch.Tensor, weights=None) -> torch.Tensor:
        """Every stage's heatmaps of normalized crops; ``weights`` as in
        ``program_weights``, or None for the detector's own."""
        if self._quant_forward is not None:
            if weights is None:
                return self._quant_forward(x)
            return quant_apply(self.quant_static, weights, x,
                               self.conv7_impl)
        if weights is None:
            return self.model(x)
        return functional_call(self.model, weights, (x,))

    def forward_maps(self, imgs_u8: np.ndarray) -> torch.Tensor:
        """(B, S, S, 3) uint8 network inputs -> every stage's heatmaps
        (stages, B, S/8, S/8, C) on the detector's device: the int8 forward
        once quantized, else the float32 model."""
        with float32_numerics(), torch.no_grad():
            x = preprocess_crops_u8(torch.from_numpy(
                np.ascontiguousarray(imgs_u8)).to(self.device))
            return self._net(x)

    def _batch_forward_fn(self):
        """The crop forward program: ``(weights, imgs_u8)``, (B, S, S, 3)
        uint8 network inputs -> the last stage's (B, S/8, S/8, C)
        heatmaps."""

        def fn(weights, imgs_u8):
            return self._net(preprocess_crops_u8(imgs_u8), weights)[-1]

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
        matmul: run it inside ``float32_numerics()``."""
        hm = resize_chainer(hm, target_hw)
        if flip:
            hm = torch.flip(hm, dims=(1,))
        return hm.permute(2, 0, 1)[:-1]

    def _tail_fn(self, target_hw: Tuple[int, int], flip: bool):
        """A crop tail's program: one crop's last-stage heatmaps (h, w, C)
        -> its (4, C - 1) rows of x, y, score and valid, as float32
        (coordinates are exact in float32 below 2^24)."""

        def fn(hm):
            x, y, score, valid = global_argmax_keypoints(
                self.tail_maps(hm, target_hw, flip),
                self.cfg.gaussian_sigma, self.cfg.heatmap_peak_thresh)
            return torch.stack([x.float(), y.float(), score, valid.float()])

        return fn

    def submit_crops(self, crops, flips=None):
        """Queue the batched forward and every crop's tail without a
        device-to-host copy; returns a pending handle for
        ``collect_crops``."""
        if not crops:
            return []
        flips = list(flips) if flips else [False] * len(crops)
        heatmaps = self.forward_maps(self.prepare_crops(crops, flips))[-1]
        return self.submit_tails(heatmaps,
                                 [np.asarray(c).shape[:2] for c in crops],
                                 flips)

    def submit_tails(self, heatmaps: torch.Tensor,
                     crop_hws: Sequence[Tuple[int, int]],
                     flips: Sequence[bool]):
        """The per-crop tails of ``submit_crops`` on last-stage heatmaps
        (B, h, w, C) already computed for crops of sizes ``crop_hws``."""
        rows, scales = [], []
        with float32_numerics(), torch.no_grad():
            for hm, crop_hw, flip in zip(heatmaps, crop_hws, flips):
                target_hw, scale = self._tail_target(crop_hw)
                rows.append(self._tail_fn(target_hw, flip)(hm))
                scales.append(scale)
        return torch.stack(rows), scales

    def collect_crops(self, pending) -> List[list]:
        """Copy a ``submit_crops`` handle's results to the host (one copy);
        per crop, a list of ``[x, y, score]`` or None per channel."""
        if not pending:
            return []
        rows, scales = pending
        rows = rows.cpu().numpy()
        return [self._to_keypoints(r, scale) for r, scale in zip(rows,
                                                                  scales)]

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
