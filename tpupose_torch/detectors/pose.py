"""PoseDetector (port of ``tpupose/detectors/pose.py``): the fast single-scale
path, the precise multi-scale pyramid, and the w8a8 int8 forward.

``detector(img) -> (poses, scores)`` with ``poses: (N, 18, 3)`` rows of
``(x, y, 2)`` in original image pixels.

Fast path, per frame: a host resize of the uint8 frame (numpy emulation of
cv2's INTER_LINEAR, so no cv2 is needed), ``/255 - 0.5``, CocoPoseNet, an
align-corners resize of the last stage's maps, then the whole postprocess
on the detector's device, and one device-to-host copy of the result.

Precise path (``precise=True``, the device pyramid of the JAX package): the
original frame is uploaded once; per scale of ``cfg.scales`` it is
cubic-resized on the device (cv2's uint8 rounding emulated), placed on a
stride-padded canvas of ``cfg.pad_value``, run through the network, and its
last-stage maps are cubic-resized back to the postprocess resolution; the
scales' maps are averaged and postprocessed there.

``quantize()`` swaps the network forward for the int8 one of
``tpupose_torch/quant.py``; everything around it stays.

The traced programs that ``tpupose_torch/serving.py`` exports are built here
(``_fast_fn``, ``_batch_fn``, ``_device_scale_fn``, ``_batch_scale_fn``,
``_avg_postprocess_fn``, ``_batch_avg_postprocess_fn``, the JAX package's
names): each takes the weights as tensors (``program_weights``) and the
uint8 frame(s) and runs the same bodies as the live paths, which pass no
weights and use the detector's own.

Numerics: convs run with cuDNN's TF32 off and matmuls at
``"highest"`` float32 precision; TF32 keeps ~3 decimal digits, enough to
move peak coordinates.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from tpupose_torch.config import INFERENCE, NUM_JOINTS, InferenceConfig
from tpupose_torch.models import ARCHS
from tpupose_torch.ops.postprocess import PoseResult, postprocess_pose
from tpupose_torch.ops.resize import (compute_optimal_size, resize_chainer,
                                      resize_cv2_cubic, resize_u8_linear)
from tpupose_torch.quant import (calibrate_ranges, make_quant_apply,
                                 model_params, qtree_to_device, quant_apply,
                                 quantize, resolve_conv7_impl)
from tpupose_torch.weights import (load_chainer_npz, load_flax_params,
                                   warn_on_load_report)


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


def stack_results(results: List[PoseResult]) -> PoseResult:
    """Per-frame ``PoseResult``s -> one with a leading batch axis on every
    field (a batched program's output)."""
    return PoseResult(*(torch.stack(fields) for fields in zip(*results)))


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


def _check_device_pyramid(cfg: InferenceConfig) -> None:
    if not cfg.device_pyramid:
        raise NotImplementedError(
            "the host pyramid (cfg.device_pyramid=False, a host emulation "
            "of cv2's uint8 INTER_CUBIC) is not ported yet (ROADMAP.md, "
            "Queue 1 item 22)")


class PoseDetector:
    """Multi-person pose detector; the whole per-frame pipeline after the
    host resize (fast path) or the upload (precise path) runs on
    ``device``."""

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
            _check_device_pyramid(cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"PoseDetector(device={device!r}): CUDA is not available")
        self.arch = arch
        self.precise = precise
        self.cfg = cfg
        self.model = ARCHS[arch](seed=seed)
        if params is not None:
            load_flax_params(self.model, params)
        elif weights_file:
            report = load_chainer_npz(self.model, weights_file)
            warn_on_load_report(report, weights_file, arch=arch)
        self.model = self.model.to(self.device).eval()
        # set by quantize()
        self.quantized = False
        self.qtree = None
        self.quant_static = None
        self.conv7_impl = None
        self._quant_forward = None
        self._quant_min_side = 0
        self._warned_saturation = False

    def quantize(self, calib_images, size: Optional[int] = None,
                 min_side: Optional[int] = None,
                 conv7_impl: Optional[str] = None) -> None:
        """Switch this detector to post-training w8a8 int8 inference.

        ``calib_images``: a few serving-representative HWC uint8 frames,
        each resized to ``size x size`` (default ``cfg.img_size``); the
        activation ranges are taken over them (``tpupose_torch/quant.py``).
        Postprocess, geometry and APIs are unchanged.

        ``conv7_impl``: the route of the int8 layers that are not heads,
        bit-equal either way (the name and values mirror the JAX package's
        ``quantize(conv7_impl=...)``): ``"kernel"``, every one of them on a
        hand-written CUDA kernel with the epilogue fused, ``ops/conv7.py``
        for the 7x7 layers and ``ops/conv_s8.py`` for the 1x1 and 3x3 ones
        (CUDA detectors only); ``"im2col"``, im2col + ``torch._int_mm`` +
        the requantize epilogue ``ops/requant.py``.  The float32 heads run
        as im2col + ``torch._int_mm`` either way.  Default: ``"kernel"`` on
        CUDA, ``"im2col"`` on the CPU.

        ``min_side``: mixed precision; forwards whose network input's short
        side is below it keep the float32 model.  Default 0: every forward
        is int8 (``cfg.quant_min_side`` is a TPU measurement and is not
        read)."""
        if self.quantized:
            raise ValueError("detector is already quantized")
        conv7_impl = resolve_conv7_impl(conv7_impl, self.device)
        size = size or self.cfg.img_size
        frames = np.stack([resize_u8_linear(np.asarray(img), (size, size))
                           for img in calib_images])
        with float32_numerics():
            ranges = calibrate_ranges(self.model, preprocess_u8(
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
        self._quant_min_side = min_side or 0

    def _forward(self, x: torch.Tensor, weights=None):
        """Network forward on normalized (B, H, W, 3) frames: the int8 one
        once quantized (unless the short side is below ``min_side``), else
        the float32 model.  ``weights``: a traced program's weight inputs
        (``program_weights``' layout), or None for the detector's own."""
        if (self._quant_forward is not None
                and min(x.shape[1], x.shape[2]) >= self._quant_min_side):
            if weights is None:
                return self._quant_forward(x)
            return quant_apply(self.quant_static, weights, x,
                               self.conv7_impl)
        if weights is None:
            return self.model(x)
        return functional_call(
            self.model, weights["f32"] if self.quantized else weights, (x,))

    def host_weights(self):
        """The weights as host data: a float32 detector's Flax param tree
        (numpy HWIO kernels, ``quant.model_params``); a quantized one's
        numpy int8 tree, with the float32 tree under ``"f32"`` when
        ``min_side`` keeps some forwards in float32 (the JAX package's
        mixed tree)."""
        if not self.quantized:
            return {"params": model_params(self.model)}
        tree = dict(self.qtree)
        if self._quant_min_side:
            tree["f32"] = {"params": model_params(self.model)}
        return tree

    def program_weights(self, device=None):
        """The weights as a traced program takes them, on ``device``
        (default: the detector's): a float32 detector's ``state_dict``; a
        quantized one's ``qtree_to_device`` tree, packed for the kernels on
        the kernel route, plus ``"f32"``, the ``state_dict``, when
        ``min_side`` is set."""
        device = torch.device(device or self.device)

        def state(model):
            return {k: v.detach().to(device)
                    for k, v in model.state_dict().items()}

        if not self.quantized:
            return state(self.model)
        tree = qtree_to_device(self.qtree, self.quant_static, device,
                               pack_kernels=self.conv7_impl == "kernel")
        if self._quant_min_side:
            tree["f32"] = state(self.model)
        return tree

    # ------------------------------------------------------------------
    # fast single-scale path
    # ------------------------------------------------------------------

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
            return self._fast_maps(
                None, torch.from_numpy(imgs_u8).to(self.device), map_hw)

    def _fast_maps(self, weights, imgs_u8: torch.Tensor,
                   map_hw: Tuple[int, int]):
        """The fast path's body up to the maps: (B, H, W, 3) uint8
        network-size frames on the device -> channel-first PAFs and
        heatmaps at ``map_hw``."""
        x = preprocess_u8(imgs_u8)
        pafs, heatmaps = self._forward(x, weights)
        paf = resize_chainer(pafs[-1], map_hw)      # (B, h, w, 38)
        hm = resize_chainer(heatmaps[-1], map_hw)   # (B, h, w, 19)
        return paf.permute(0, 3, 1, 2), hm.permute(0, 3, 1, 2)

    def _fast_fn(self, map_hw: Tuple[int, int]):
        """The fast-path program: ``(weights, img_u8)``, the (H, W, 3)
        uint8 frame already resized to the network input -> its
        ``PoseResult`` at ``map_hw``."""

        def fn(weights, img_u8):
            paf, hm = self._fast_maps(weights, img_u8[None], map_hw)
            return self._postprocess(paf[0], hm[0])

        return fn

    def _batch_fn(self, map_hw: Tuple[int, int]):
        """The batched fast-path program: (B, H, W, 3) uint8 frames -> one
        ``PoseResult`` with a leading batch axis."""

        def fn(weights, imgs_u8):
            paf, hm = self._fast_maps(weights, imgs_u8, map_hw)
            return stack_results([self._postprocess(p, h)
                                  for p, h in zip(paf, hm)])

        return fn

    # ------------------------------------------------------------------
    # precise multi-scale path (device pyramid)
    # ------------------------------------------------------------------

    def _postprocess_hw(self, orig_h: int, orig_w: int) -> Tuple[int, int]:
        """Precise-mode postprocess resolution: the original one, or capped
        by ``cfg.max_postprocess_len``; poses rescale back at emit."""
        cap = self.cfg.max_postprocess_len
        if cap and max(orig_h, orig_w) > cap:
            s = cap / max(orig_h, orig_w)
            return (max(1, round(orig_h * s)), max(1, round(orig_w * s)))
        return (orig_h, orig_w)

    def _pyramid_geometries(self, orig_h: int, orig_w: int):
        """Per-scale (scale, scaled_hw, padded_hw) of the precise pyramid."""
        out = []
        for scale in self.cfg.scales:
            multiplier = scale * self.cfg.img_size / min(orig_h, orig_w)
            scaled_hw = (math.ceil(orig_h * multiplier),
                         math.ceil(orig_w * multiplier))
            padded_hw = (
                scaled_hw[0] + (-scaled_hw[0]) % self.cfg.downscale,
                scaled_hw[1] + (-scaled_hw[1]) % self.cfg.downscale)
            out.append((scale, scaled_hw, padded_hw))
        return out

    def _scaled_on_canvas(self, imgs_u8: torch.Tensor, scaled_hw,
                          canvas_hw) -> torch.Tensor:
        """(B, H, W, 3) uint8 original frames -> (B, c_h, c_w, 3) float32:
        cubic-resized to ``scaled_hw`` with cv2's uint8 rounding emulated,
        top-left on a ``canvas_hw`` canvas of ``cfg.pad_value``."""
        s_h, s_w = scaled_hw
        # Frame by frame, so the matmuls have one shape whatever the batch
        # and __call__ and detect_batch round every pixel alike: the int8
        # forward turns a pixel moved by one into visibly different maps.
        img = torch.stack([resize_cv2_cubic(f.float(), scaled_hw)
                           for f in imgs_u8])
        img = torch.clamp(torch.round(img), 0.0, 255.0)
        pad = torch.tensor(self.cfg.pad_value, dtype=torch.float32,
                           device=img.device)
        canvas = pad.expand(img.shape[0], *canvas_hw, 3).clone()
        canvas[:, :s_h, :s_w] = img
        return canvas

    def _scale_tail(self, paf, hm, padded_hw, crop_hw, post_hw):
        """Last-stage maps -> postprocess-resolution maps: cubic to the
        padded input size, crop the stride pad, cubic to ``post_hw``.
        Channel-last, batched."""
        out = []
        for m in (paf, hm):
            m = resize_cv2_cubic(m, padded_hw)[:, :crop_hw[0], :crop_hw[1]]
            out.append(resize_cv2_cubic(m, post_hw))
        return tuple(out)

    def _pyramid_scale_maps(self, imgs_u8, scaled_hw, padded_hw, post_hw,
                            weights=None):
        """One pyramid scale: original uint8 frames -> its maps at
        ``post_hw``."""
        x = self._scaled_on_canvas(imgs_u8, scaled_hw, padded_hw) / 255.0 \
            - 0.5
        pafs, heatmaps = self._forward(x, weights)
        return self._scale_tail(pafs[-1], heatmaps[-1], padded_hw,
                                scaled_hw, post_hw)

    def _device_scale_fn(self, post_hw, scaled_hw, padded_hw):
        """A precise scale's program: ``(weights, orig_u8)``, the original
        (H, W, 3) uint8 frame -> the scale's channel-last PAFs and heatmaps
        at ``post_hw``."""

        def fn(weights, orig_u8):
            paf, hm = self._pyramid_scale_maps(orig_u8[None], scaled_hw,
                                               padded_hw, post_hw, weights)
            return paf[0], hm[0]

        return fn

    def _batch_scale_fn(self, post_hw, scaled_hw, padded_hw):
        """The batched variant of ``_device_scale_fn``: (B, H, W, 3)."""

        def fn(weights, imgs_u8):
            return self._pyramid_scale_maps(imgs_u8, scaled_hw, padded_hw,
                                            post_hw, weights)

        return fn

    @staticmethod
    def _average(paf_list, hm_list):
        """The scales' channel-last maps -> their mean, channel-first."""
        n = len(paf_list)
        paf = sum(paf_list) / n
        hm = sum(hm_list) / n
        return paf.movedim(-1, -3), hm.movedim(-1, -3)

    def _avg_postprocess_fn(self):
        """The precise path's last program: the scales' (o_h, o_w, C) maps
        -> their mean -> the ``PoseResult``."""

        def fn(paf_list, hm_list):
            return self._postprocess(*self._average(paf_list, hm_list))

        return fn

    def _batch_avg_postprocess_fn(self):
        """The batched variant of ``_avg_postprocess_fn``: lists of
        (B, o_h, o_w, C) -> one ``PoseResult`` with a leading batch
        axis."""

        def fn(paf_list, hm_list):
            paf, hm = self._average(paf_list, hm_list)
            return stack_results([self._postprocess(p, h)
                                  for p, h in zip(paf, hm)])

        return fn

    def _fused_pyramid_maps(self, imgs_u8, geom_small, geom_large,
                            post_hw):
        """Two pyramid scales through one forward
        (``cfg.fuse_small_scales``): both scaled frames on the larger
        scale's padded canvas as a 2B batch.  Geoms are (scaled_hw,
        padded_hw).  The smaller scale sees ``pad_value`` beyond its own
        stride pad, so its maps near the image border differ slightly from
        the separate-dispatch pyramid."""
        (s_small, _), (s_large, p_large) = geom_small, geom_large
        b = imgs_u8.shape[0]
        x = torch.cat(
            [self._scaled_on_canvas(imgs_u8, s_small, p_large),
             self._scaled_on_canvas(imgs_u8, s_large, p_large)]) / 255.0 \
            - 0.5
        pafs, heatmaps = self._forward(x)
        paf, hm = pafs[-1], heatmaps[-1]
        small = self._scale_tail(paf[:b], hm[:b], p_large, s_small, post_hw)
        large = self._scale_tail(paf[b:], hm[b:], p_large, s_large, post_hw)
        return small, large

    def _fused_small_pair(self, geoms):
        """Indices (small, large) of the two smallest pyramid scales when
        ``cfg.fuse_small_scales`` applies to this geometry, else None."""
        if not (self.cfg.fuse_small_scales and len(geoms) >= 2):
            return None
        order = sorted(range(len(geoms)),
                       key=lambda k: geoms[k][2][0] * geoms[k][2][1])
        i, j = order[0], order[1]
        # the larger canvas must contain the smaller scaled frame
        if (geoms[i][1][0] <= geoms[j][2][0]
                and geoms[i][1][1] <= geoms[j][2][1]):
            return i, j
        return None

    def _precise_maps(self, imgs: np.ndarray):
        """(B, H, W, 3) uint8 original frames -> the scales' averaged
        channel-first (B, 38, o_h, o_w) PAFs and (B, 19, o_h, o_w) heatmaps
        at the postprocess resolution ``(o_h, o_w)``."""
        orig_h, orig_w = imgs.shape[1:3]
        post_hw = self._postprocess_hw(orig_h, orig_w)
        geoms = self._pyramid_geometries(orig_h, orig_w)
        with float32_numerics(), torch.no_grad():
            imgs_u8 = torch.from_numpy(np.ascontiguousarray(imgs)).to(
                self.device)
            fused = {}
            pair = self._fused_small_pair(geoms)
            if pair is not None:
                i, j = pair
                fused[i], fused[j] = self._fused_pyramid_maps(
                    imgs_u8, geoms[i][1:], geoms[j][1:], post_hw)
            paf_list, hm_list = [], []
            for k, (_, scaled_hw, padded_hw) in enumerate(geoms):
                paf, hm = fused[k] if k in fused else \
                    self._pyramid_scale_maps(imgs_u8, scaled_hw, padded_hw,
                                             post_hw)
                paf_list.append(paf)
                hm_list.append(hm)
            return self._average(paf_list, hm_list)

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------

    def _batch_maps(self, imgs: np.ndarray, precise: Optional[bool] = None):
        """(B, H, W, 3) uint8 original frames -> the channel-first maps the
        postprocess consumes and the map -> original scale factors; the
        precise pyramid if ``precise`` (default: the detector's mode)."""
        orig_h, orig_w = imgs.shape[1:3]
        if self.precise if precise is None else precise:
            paf, hm = self._precise_maps(imgs)
        else:
            (in_h, in_w), map_hw = self._geometry(orig_h, orig_w)
            resized = np.stack([resize_u8_linear(img, (in_w, in_h))
                                for img in imgs])
            paf, hm = self._maps(resized, map_hw)
        map_h, map_w = paf.shape[-2:]
        return paf, hm, (orig_w / map_w, orig_h / map_h)

    def _postprocess(self, paf: torch.Tensor, hm: torch.Tensor) -> PoseResult:
        """``img_len`` is the map width: the fast path's map size, or the
        precise path's postprocess resolution."""
        with torch.no_grad():
            return postprocess_pose(paf, hm, paf.shape[-1], self.cfg)

    def compute_maps(self, orig_img: np.ndarray):
        """The (pafs (38, h, w), heatmaps (19, h, w)) maps the postprocess
        consumes for this frame, plus the map -> original scale factors."""
        paf, hm, scale = self._batch_maps(np.asarray(orig_img)[None])
        return (paf[0], hm[0]), scale

    def submit(self, orig_img: np.ndarray):
        """Run one frame up to its result on the device; returns a pending
        handle for ``collect``.  Kernels are queued asynchronously, except
        for the grouping fold's one read of its trip count."""
        (paf, hm), (scale_x, scale_y) = self.compute_maps(orig_img)
        return self._postprocess(paf, hm), scale_x, scale_y

    def collect(self, pending):
        """Copy a ``submit`` handle's result to the host; (poses, scores)."""
        result, scale_x, scale_y = pending
        return self._emit(result, scale_x, scale_y)

    def detect_precise(self, orig_img: np.ndarray):
        """The precise pyramid on one frame, whatever the detector's mode
        (as the JAX package's ``detect_precise``); ``__call__`` of a precise
        detector goes through it."""
        return self.collect(self._submit_precise(orig_img))

    def _submit_precise(self, orig_img: np.ndarray):
        _check_device_pyramid(self.cfg)
        paf, hm, (scale_x, scale_y) = self._batch_maps(
            np.asarray(orig_img)[None], precise=True)
        return self._postprocess(paf[0], hm[0]), scale_x, scale_y

    def detect_batch(self, imgs: np.ndarray):
        """(B, H, W, 3) uint8 same-sized frames -> list of (poses, scores).

        One upload and one batched forward (per pyramid scale in precise
        mode); the postprocess runs per frame on the device, and one
        device-to-host copy fetches every result."""
        imgs = np.asarray(imgs)
        paf, hm, (scale_x, scale_y) = self._batch_maps(imgs)
        results = results_to_host([self._postprocess(paf[i], hm[i])
                                   for i in range(len(imgs))])
        return [self._emit(r, scale_x, scale_y) for r in results]

    def _emit(self, result, scale_x: float, scale_y: float):
        poses, scores, self._warned_saturation = emit_result(
            result, scale_x, scale_y, warned=self._warned_saturation)
        return poses, scores

    def __call__(self, orig_img: np.ndarray):
        if self.precise:
            return self.detect_precise(orig_img)
        return self.collect(self.submit(orig_img))


def _main(argv=None):
    """The JAX package's pose CLI:
    ``python -m tpupose_torch.detectors.pose posenet <npz> --img x.png
    [--precise] [--device cpu]``"""
    import argparse

    import cv2

    from tpupose_torch.detectors.draw import draw_person_pose

    p = argparse.ArgumentParser(description="Pose detector")
    p.add_argument("arch", choices=("posenet",))
    p.add_argument("weights", help="weights file path (.npz)")
    p.add_argument("--img", "-i", required=True, help="image file path")
    p.add_argument("--precise", action="store_true",
                   help="multi-scale precise inference")
    p.add_argument("--out", default="result.png")
    p.add_argument("--device", default="cuda", help="torch device")
    args = p.parse_args(argv)

    detector = PoseDetector(args.arch, weights_file=args.weights,
                            precise=args.precise, device=args.device)
    img = cv2.imread(args.img)
    if img is None:
        raise FileNotFoundError(args.img)
    poses, _ = detector(img)
    print(f"{len(poses)} people")
    print(f"Saving result into {args.out}...")
    cv2.imwrite(args.out, draw_person_pose(img, poses))


if __name__ == "__main__":
    _main()
