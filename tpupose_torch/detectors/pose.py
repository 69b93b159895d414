"""PoseDetector, fast single-scale path (port of
``tpupose/detectors/pose.py``).

``detector(img) -> (poses, scores)`` with ``poses: (N, 18, 3)`` rows of
``(x, y, 2)`` in original image pixels.  Per frame: a host resize of the
uint8 frame (numpy emulation of cv2's INTER_LINEAR, so no cv2 is needed),
``/255 - 0.5``, CocoPoseNet, an align-corners resize of the last stage's
maps, then the whole postprocess on the detector's device, and one
device-to-host copy of the result.

Numerics: convs run with cuDNN's TF32 off and matmuls at
``"highest"`` float32 precision; TF32 keeps ~3 decimal digits, enough to
move peak coordinates.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpupose.config import INFERENCE, NUM_JOINTS, InferenceConfig
from tpupose.weights.chainer_npz import warn_on_load_report
from tpupose_torch.models import ARCHS
from tpupose_torch.ops.postprocess import PoseResult, postprocess_pose
from tpupose_torch.ops.resize import (compute_optimal_size, resize_chainer,
                                      resize_u8_linear)
from tpupose_torch.weights import load_chainer_npz, load_flax_params


def preprocess_u8(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 ``/255 - 0.5``, channels last."""
    return img_u8.float() / 255.0 - 0.5


@contextlib.contextmanager
def float32_numerics():
    """cuDNN convs without TF32 (deterministic algorithms) and float32
    matmuls at ``"highest"`` precision, restored on exit."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(old)


def results_to_host(results: List[PoseResult]) -> List[PoseResult]:
    """Copy device ``PoseResult``s to numpy in ONE device-to-host copy: the
    fields are packed into a single float32 tensor (the counters are exact
    in float32 below 2^24)."""
    parts = [torch.cat([f.reshape(-1).float() for f in r]) for r in results]
    flat = torch.cat(parts).cpu().numpy()
    out, pos = [], 0
    for r in results:
        fields = []
        for f in r:
            n = f.numel()
            v = flat[pos:pos + n].reshape(tuple(f.shape))
            pos += n
            if f.dtype == torch.bool:
                v = v > 0
            elif not f.dtype.is_floating_point:
                v = v.astype(np.int64)
            fields.append(v)
        out.append(PoseResult(*fields))
    return out


def emit_result(result: PoseResult, scale_x: float, scale_y: float,
                warned: bool = False):
    """Rescale a ``PoseResult`` to original pixels and compact it to
    (N, 18, 3) poses and (N,) scores.

    Returns ``(poses, scores, warned)``; thread ``warned`` back in to get at
    most one saturation warning per consumer.  A result still on a device
    is fetched with one copy."""
    if isinstance(result.poses, torch.Tensor):
        result = results_to_host([result])[0]
    dropped = int(result.peaks_dropped)
    suppressed = int(result.spawns_suppressed)
    if (dropped or suppressed) and not warned:
        warned = True
        warnings.warn(
            f"pose postprocess capacity saturated ({dropped} peaks "
            f"dropped beyond max_peaks_per_joint, {suppressed} person "
            "subsets suppressed beyond max_subsets); results may "
            "diverge from the reference on this crowd — raise "
            "InferenceConfig.max_peaks_per_joint/max_subsets",
            RuntimeWarning, stacklevel=4)
    valid = np.asarray(result.valid)
    if int(result.num_peaks) == 0 or not valid.any():
        return np.empty((0, NUM_JOINTS, 3)), np.empty(0), warned
    poses = np.asarray(result.poses)[valid]
    scores = np.asarray(result.scores)[valid]
    present = poses[:, :, 2] > 0
    poses[:, :, 0] = np.where(present, poses[:, :, 0] * scale_x, 0.0)
    poses[:, :, 1] = np.where(present, poses[:, :, 1] * scale_y, 0.0)
    return poses, scores, warned


class PoseDetector:
    """Multi-person pose detector; the whole per-frame pipeline after the
    host resize runs on ``device``."""

    def __init__(self, arch: str = "posenet",
                 weights_file: Optional[str] = None,
                 params=None,
                 precise: bool = False,
                 cfg: InferenceConfig = INFERENCE,
                 device="cuda",
                 seed: int = 0):
        """``params``: a Flax param tree (numpy leaves) to load;
        ``weights_file``: a Chainer ``.npz``; otherwise the model keeps its
        weights drawn from ``seed``."""
        if precise:
            raise NotImplementedError(
                "precise (multi-scale) mode is not ported yet (ROADMAP.md, "
                "Queue 1 item 9)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"PoseDetector(device={device!r}): CUDA is not available")
        self.arch = arch
        self.cfg = cfg
        self.model = ARCHS[arch](seed=seed)
        if params is not None:
            load_flax_params(self.model, params)
        elif weights_file:
            report = load_chainer_npz(self.model, weights_file)
            warn_on_load_report(report, weights_file, arch=arch)
        self.model = self.model.to(self.device).eval()
        self._warned_saturation = False

    def quantize(self, *args, **kwargs):
        raise NotImplementedError(
            "w8a8 quantization is not ported yet (ROADMAP.md, Queue 1 "
            "item 10)")

    def _geometry(self, orig_h: int, orig_w: int):
        input_w, input_h = compute_optimal_size(
            orig_h, orig_w, self.cfg.img_size, self.cfg.downscale)
        map_w, map_h = compute_optimal_size(
            orig_h, orig_w, self.cfg.heatmap_size, self.cfg.downscale)
        return (input_h, input_w), (map_h, map_w)

    def _maps(self, imgs_u8: np.ndarray, map_hw: Tuple[int, int]):
        """(B, H, W, 3) uint8 network-size frames -> channel-first
        (B, 38, h, w) PAFs and (B, 19, h, w) heatmaps at ``map_hw``."""
        with float32_numerics(), torch.no_grad():
            x = preprocess_u8(torch.from_numpy(imgs_u8).to(self.device))
            pafs, heatmaps = self.model(x)
            paf = resize_chainer(pafs[-1], map_hw)      # (B, h, w, 38)
            hm = resize_chainer(heatmaps[-1], map_hw)   # (B, h, w, 19)
        return paf.permute(0, 3, 1, 2), hm.permute(0, 3, 1, 2)

    def _postprocess(self, paf: torch.Tensor, hm: torch.Tensor,
                     map_w: int) -> PoseResult:
        with torch.no_grad():
            return postprocess_pose(paf, hm, map_w, self.cfg)

    def compute_maps(self, orig_img: np.ndarray):
        """The (pafs (38, h, w), heatmaps (19, h, w)) maps the postprocess
        consumes for this frame, plus the map -> original scale factors."""
        orig_h, orig_w = orig_img.shape[:2]
        (in_h, in_w), (map_h, map_w) = self._geometry(orig_h, orig_w)
        resized = resize_u8_linear(orig_img, (in_w, in_h))
        paf, hm = self._maps(resized[None], (map_h, map_w))
        return (paf[0], hm[0]), (orig_w / map_w, orig_h / map_h)

    def submit(self, orig_img: np.ndarray):
        """Run one frame up to its result on the device; returns a pending
        handle for ``collect``.  Kernels are queued asynchronously, except
        for the grouping fold's one read of its trip count."""
        (paf, hm), (scale_x, scale_y) = self.compute_maps(orig_img)
        result = self._postprocess(paf, hm, paf.shape[-1])
        return result, scale_x, scale_y

    def collect(self, pending):
        """Copy a ``submit`` handle's result to the host; (poses, scores)."""
        result, scale_x, scale_y = pending
        return self._emit(result, scale_x, scale_y)

    def detect_batch(self, imgs: np.ndarray):
        """(B, H, W, 3) uint8 same-sized frames -> list of (poses, scores).

        One upload and one batched forward; the postprocess runs per frame
        on the device, and one device-to-host copy fetches every result."""
        imgs = np.asarray(imgs)
        b, orig_h, orig_w = imgs.shape[:3]
        (in_h, in_w), (map_h, map_w) = self._geometry(orig_h, orig_w)
        resized = np.stack([resize_u8_linear(img, (in_w, in_h))
                            for img in imgs])
        paf, hm = self._maps(resized, (map_h, map_w))
        results = results_to_host([
            self._postprocess(paf[i], hm[i], map_w) for i in range(b)])
        return [self._emit(r, orig_w / map_w, orig_h / map_h)
                for r in results]

    def _emit(self, result, scale_x: float, scale_y: float):
        poses, scores, self._warned_saturation = emit_result(
            result, scale_x, scale_y, warned=self._warned_saturation)
        return poses, scores

    def __call__(self, orig_img: np.ndarray):
        return self.collect(self.submit(orig_img))
