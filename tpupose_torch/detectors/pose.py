"""PoseDetector (port of ``tpupose/detectors/pose.py``): the fast single-scale
path, the precise multi-scale pyramid, and the w8a8 int8 forward.

``detector(img) -> (poses, scores)`` with ``poses: (N, J, 3)`` in
original image pixels, J the parts of the architecture's skeleton
(``models.ARCHS[arch].topology``: 18 for ``posenet``, 25 for ``body25``,
17 for ``higherhrnet_w32``), which the whole postprocess reads.  The
architecture's ``decoder`` selects what follows the net: part affinity
fields (``posenet``, ``body25``; rows ``(x, y, 2)``), or associative
embedding (``higherhrnet_w32``; rows ``(x, y, value)``), below.

Fast path, per frame: a host resize of the uint8 frame (cv2's
INTER_LINEAR in compiled C++, ``resize_u8_linear``, so no cv2 is needed)
into its slot of the batch, ``/255 - 0.5``, the net
(CocoPoseNet or BODY_25), an align-corners resize of the last stage's maps,
then the whole postprocess on the detector's device, and one device-to-host
copy of the result.
Every entry point runs one batched postprocess per program (a frame axis
in front of the maps, as the JAX package's ``vmap``); on the card it
reads nothing back to the host, so ``submit`` only queues work and the
one synchronising call is ``collect``'s copy.

Precise path (``precise=True``).  The device pyramid
(``cfg.device_pyramid``, the default): the original frame is uploaded once;
per scale of ``cfg.scales`` it is cubic-resized on the device (cv2's uint8
rounding emulated), placed on a stride-padded canvas of ``cfg.pad_value``
and run through the network.  The host pyramid (``device_pyramid=False``):
per scale the frame is resized on the host with ``resize_u8_cubic`` (cv2's
uint8 INTER_CUBIC, emulated exactly), padded with ``pad_image_np`` and
uploaded.  Either way each scale's last-stage maps are cubic-resized back
to the postprocess resolution; the scales' maps are averaged and
postprocessed there.

``compute_dtype=torch.bfloat16`` runs the network in bfloat16, its
parameters cast once at rest as the JAX package's ``commit_variables``
does; the input stays float32 ``/255 - 0.5`` (the model casts it) and the
model returns float32 maps, so the map resizes, ``blur_nms`` and the
postprocess see float32 as on the float32 route.  ``quantize()`` swaps the
network forward for the int8 one of ``tpupose_torch/quant.py``;
everything around it stays.

Each frame's work runs inside ``utils.profiling.annotate`` spans with the
JAX package's program names (``pose_fast_HxW``, ``poseq_fast_HxW``,
``pose_scale_HxW``, ``pose_avg_postprocess_HxW``).  Stage spans tile a
fast request: ``pose.resize`` (geometry and host resize) before the
program span, ``pose.upload``, ``pose.forward`` and ``pose.postprocess``
inside it, ``pose.fetch`` (the device-to-host copy, its wait and the
emit) after it; the precise path has ``pose.postprocess`` and
``pose.fetch``.  The spans wrap calls into the exported bodies, never
code inside them.

``mesh=`` (``tpupose_torch/parallel``): ``detect_batch`` on a (data,
spatial) mesh of ranks, each calling it with the same frames.  Each data
rank resizes and uploads only its ``B / n_data`` frames; the spatial ranks
split the network input's rows into slabs (``slab_rows``, whole blocks of
8 rows) and run the net with halo rows (``parallel/spatial.py``; the int8
forward through ``quant_apply(halo=...)``, its kernels unchanged on the
slabs), then ``all_gather`` the last stage's rows and postprocess the
whole maps; the results are gathered over ``data``, so every rank returns
the full list.  A network input with fewer blocks of 8 rows than spatial
ranks (a small pyramid scale) runs whole on every rank of its group.

The traced programs that ``tpupose_torch/serving.py`` exports are built here,
one function each: ``_fast_fn`` and ``_scale_fn`` take the weights as
tensors (``program_weights``) and a batch of uint8 frames, and
``_avg_postprocess_fn`` the scales' maps; ``single_frame`` makes a batched
program one of a single frame.  They run the same bodies as the live
paths, which pass no weights and use the detector's own.

The network (model, weights, int8 forward, ``float32_numerics``) is
``detectors/net.py``'s ``DetectorNet``, held as ``self.net``.

Associative embedding (``higherhrnet_w32``, ``ops/ae_decode.py``): the
architecture's ``decoder`` makes ``PoseDetector(arch)`` an
``AEPoseDetector``, once, at construction; its settings are an
``AEConfig`` in place of ``cfg``.  ``pose.resize`` (the frame resized
onto its region of the 64-multiple canvas), then in the program span
``pose.upload``, ``pose.forward`` (the RGB ImageNet normaliser, the frame
and its mirror as one batch-2 eager forward; the maps' aggregation in
the ``hr.head`` span), ``pose.postprocess`` (``ae.topk``:
NMS, top-k and the tag gather, the table's copy to the host queued); in
``collect``, ``pose.fetch`` holds ``ae.match`` (the wait for the table
and the host match) and ``ae.refine`` (refine on the device, one copy
back).  ``submit`` makes no synchronising call.  ``detect_batch``, the
precise pyramid, ``quantize()``, meshes, bfloat16 and the serving
bundle raise ``NotImplementedError`` for it.
"""

from __future__ import annotations

import math
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from tpupose_torch.config import INFERENCE, InferenceConfig
from tpupose_torch.detectors import net as _net
from tpupose_torch.detectors.net import (DetectorNet, NetHolder,
                                         float32_numerics)
from tpupose_torch.ops import ae_decode as ae
from tpupose_torch.ops.postprocess import PoseResult, postprocess_pose
from tpupose_torch.ops.resize import (compute_optimal_size, resize_chainer,
                                      resize_cv2_cubic, resize_u8_cubic,
                                      resize_u8_linear)
from tpupose_torch.ops.upload import to_device
from tpupose_torch.parallel.mesh import (SLAB_MULTIPLE, Mesh, all_gather_list,
                                         data_part, replicate)
from tpupose_torch.parallel.spatial import SpatialSlabs
from tpupose_torch.utils.profiling import annotate


def preprocess_u8(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 ``/255 - 0.5``, channels last."""
    return img_u8.float() / 255.0 - 0.5


def pad_image_np(img: np.ndarray, stride: int,
                 pad_value: Tuple[int, int, int]):
    """Pad bottom and right to a multiple of ``stride`` with a constant BGR
    value; returns ``(padded, (pad_bottom, pad_right))``."""
    h, w = img.shape[:2]
    pad_b = (stride - h % stride) % stride
    pad_r = (stride - w % stride) % stride
    out = np.empty((h + pad_b, w + pad_r, 3), np.uint8)
    out[...] = np.asarray(pad_value, np.uint8)
    out[:h, :w] = img
    return out, (pad_b, pad_r)


def fast_geometry(cfg: InferenceConfig, orig_h: int, orig_w: int):
    """The fast path's (input_hw, map_hw) for an original image size."""
    input_w, input_h = compute_optimal_size(
        orig_h, orig_w, cfg.img_size, cfg.downscale)
    map_w, map_h = compute_optimal_size(
        orig_h, orig_w, cfg.heatmap_size, cfg.downscale)
    return (input_h, input_w), (map_h, map_w)


def single_frame(fn):
    """A batched program ``fn(weights, imgs)`` as the program of one frame:
    a leading axis added to the input and dropped from every output."""

    def one(weights, img):
        return pytree.tree_map(lambda t: t[0], fn(weights, img[None]))

    return one


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
    (N, J, 3) poses and (N,) scores, J the result's parts.

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
        return (np.empty((0, result.poses.shape[-2], 3)), np.empty(0),
                warned)
    poses = np.asarray(result.poses)[valid]
    scores = np.asarray(result.scores)[valid]
    present = poses[:, :, 2] > 0
    poses[:, :, 0] = np.where(present, poses[:, :, 0] * scale_x, 0.0)
    poses[:, :, 1] = np.where(present, poses[:, :, 1] * scale_y, 0.0)
    return poses, scores, warned


class PoseDetector(NetHolder):
    """Multi-person pose detector; the whole per-frame pipeline after the
    host resize (fast path) or the upload (precise path) runs on
    ``device``.  An associative-embedding architecture gets an
    ``AEPoseDetector``."""

    def __new__(cls, arch: str = "posenet", *args, **kwargs):
        if cls is PoseDetector and getattr(
                _net.ARCHS.get(arch), "decoder", "paf") == AE_DECODER:
            cls = AEPoseDetector
        return super().__new__(cls)

    def __init__(self, arch: str = "posenet",
                 weights_file: Optional[str] = None,
                 params=None,
                 precise: bool = False,
                 cfg: InferenceConfig = INFERENCE,
                 device="cuda",
                 seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 mesh: Optional[Mesh] = None):
        """``params``: a Flax param tree (numpy leaves) to load;
        ``weights_file``: a Chainer ``.npz``; otherwise the model keeps its
        weights drawn from ``seed``.  ``compute_dtype``: ``torch.float32``
        or ``torch.bfloat16``, the network's compute dtype; the parameters
        are stored in it.  ``mesh``: ``detect_batch`` runs on it (every
        rank builds the detector; the device is the mesh's and the weights
        are broadcast from rank 0).  ``arch="body25"`` has no weight file
        yet: it takes its seeded weights only."""
        self.net = DetectorNet(arch, mesh.device if mesh is not None
                               else device, type(self).__name__,
                               weights_file, params, seed, compute_dtype)
        self.device = self.net.device
        self.arch = arch
        self.precise = precise
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.topology = self.model.topology
        self.mesh = mesh
        if mesh is not None:
            replicate(self.model, mesh)
        self._slabs_on = False   # inside a meshed detect_batch
        self._quant_min_side = 0   # set by quantize()
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
        read).

        A bfloat16 detector calibrates with its bfloat16 forward and
        quantizes its bfloat16 weights (read as float32), as the JAX
        package's does; the heads stay float32, and ``min_side``'s
        forwards keep the bfloat16 model."""
        self.net.quantize(calib_images, size or self.cfg.img_size,
                          preprocess_u8, conv7_impl)
        self._quant_min_side = min_side or 0
        if self.mesh is not None:
            _check_replicated(self.qtree, self.mesh)

    def _forward(self, x: torch.Tensor, weights=None):
        """Network forward on normalized (B, H, W, 3) frames: the int8 one
        once quantized (unless the short side is below ``min_side``), else
        the float model.  ``weights``: a traced program's weight inputs
        (``program_weights``' layout), or None for the detector's own.
        Inside a meshed ``detect_batch``, ``_slab_forward``."""
        if self._slabs_on:
            return self._slab_forward(x)
        return self.net(x, weights, int8=self._int8_for(x))

    def _int8_for(self, x: torch.Tensor) -> bool:
        """Whether the input ``x`` takes the int8 forward."""
        return (self.net.quantized
                and min(x.shape[1], x.shape[2]) >= self._quant_min_side)

    def _slab_forward(self, x: torch.Tensor):
        """The forward of a spatial mesh's rank on the whole normalized
        input ``x``: its slab of rows through the net with halos, then the
        last stage's maps of every slab (``all_gather`` over ``spatial``),
        as a one-stage stack.  An input with fewer blocks of 8 rows than
        spatial ranks runs whole on every rank (the int8 route is chosen
        on the whole input's short side either way)."""
        rows, n_spatial = x.shape[1], self.mesh.n_spatial
        int8 = self._int8_for(x)
        if rows // SLAB_MULTIPLE < n_spatial:
            return self.net(x, int8=int8)
        slabs = SpatialSlabs.for_height(self.mesh, rows)
        first = sum(slabs.sizes[:slabs.index])
        outs = self.net(x[:, first:first + slabs.sizes[slabs.index]],
                        halo=slabs, int8=int8)
        return tuple(slabs.gather(maps[-1], 1)[None] for maps in outs)

    def host_weights(self):
        """``DetectorNet.host_weights``, the float32 tree riding along when
        ``min_side`` keeps some forwards in float32."""
        return self.net.host_weights(f32=bool(self._quant_min_side))

    def program_weights(self, device=None):
        """``DetectorNet.program_weights`` (default device: the
        detector's), the float32 ``state_dict`` riding along when
        ``min_side`` keeps some forwards in float32."""
        return self.net.program_weights(device,
                                        f32=bool(self._quant_min_side))

    # ------------------------------------------------------------------
    # fast single-scale path
    # ------------------------------------------------------------------

    def _maps(self, imgs_u8: np.ndarray, map_hw: Tuple[int, int]):
        """(B, H, W, 3) uint8 network-size frames -> channel-first
        (B, 2L, h, w) PAFs and (B, J + 1, h, w) heatmaps at ``map_hw``, per
        the architecture's topology."""
        with annotate("pose.upload"):
            imgs = to_device(imgs_u8, self.device)
        with annotate("pose.forward"), float32_numerics(), torch.no_grad():
            return self._fast_maps(None, imgs, map_hw)

    def _fast_maps(self, weights, imgs_u8: torch.Tensor,
                   map_hw: Tuple[int, int]):
        """The fast path's body up to the maps: (B, H, W, 3) uint8
        network-size frames on the device -> channel-first PAFs and
        heatmaps at ``map_hw``."""
        x = preprocess_u8(imgs_u8)
        pafs, heatmaps = self._forward(x, weights)
        paf = resize_chainer(pafs[-1], map_hw)      # (B, h, w, 2L)
        hm = resize_chainer(heatmaps[-1], map_hw)   # (B, h, w, J + 1)
        return paf.permute(0, 3, 1, 2), hm.permute(0, 3, 1, 2)

    def _fast_fn(self, map_hw: Tuple[int, int]):
        """The fast-path program: ``(weights, imgs_u8)``, (B, H, W, 3)
        uint8 frames already resized to the network input -> one
        ``PoseResult`` at ``map_hw`` with a leading batch axis."""

        def fn(weights, imgs_u8):
            return self._postprocess(*self._fast_maps(weights, imgs_u8,
                                                      map_hw))

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
        pad = to_device(np.asarray(self.cfg.pad_value, np.float32),
                        img.device)
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

    def _scale_fn(self, post_hw, scaled_hw, padded_hw):
        """A precise scale's program: ``(weights, imgs_u8)``, the original
        (B, H, W, 3) uint8 frames -> the scale's channel-last PAFs and
        heatmaps at ``post_hw``."""

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
        """The precise path's last program: the scales' (o_h, o_w, C) maps,
        a leading batch axis or none -> their mean -> the ``PoseResult``."""

        def fn(paf_list, hm_list):
            return self._postprocess(*self._average(paf_list, hm_list))

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
        if not (self.cfg.fuse_small_scales and self.cfg.device_pyramid
                and len(geoms) >= 2):
            return None
        order = sorted(range(len(geoms)),
                       key=lambda k: geoms[k][2][0] * geoms[k][2][1])
        i, j = order[0], order[1]
        # the larger canvas must contain the smaller scaled frame
        if (geoms[i][1][0] <= geoms[j][2][0]
                and geoms[i][1][1] <= geoms[j][2][1]):
            return i, j
        return None

    def _padded_scale_maps(self, imgs_u8, pad, post_hw):
        """The host pyramid's scale: (B, p_h, p_w, 3) uint8 frames already
        resized and stride-padded on the host -> the scale's maps at
        ``post_hw``; ``pad`` is the (bottom, right) padding."""
        p_h, p_w = imgs_u8.shape[1:3]
        pafs, heatmaps = self._forward(preprocess_u8(imgs_u8))
        return self._scale_tail(pafs[-1], heatmaps[-1], (p_h, p_w),
                                (p_h - pad[0], p_w - pad[1]), post_hw)

    def _host_scaled(self, imgs: np.ndarray, scaled_hw):
        """(B, H, W, 3) uint8 frames -> cubic-resized to ``scaled_hw`` and
        padded to the stride on the host; returns (frames, (pad_bottom,
        pad_right))."""
        padded = [pad_image_np(resize_u8_cubic(img, scaled_hw[::-1]),
                               self.cfg.downscale, self.cfg.pad_value)
                  for img in imgs]
        return np.stack([p for p, _ in padded]), padded[0][1]

    def _precise_scale_maps(self, imgs: np.ndarray):
        """(B, H, W, 3) uint8 original frames -> the scales' channel-last
        (B, o_h, o_w, 2L) PAFs and (B, o_h, o_w, J + 1) heatmaps, as two
        lists, at the postprocess resolution ``(o_h, o_w)``, which is
        returned third."""
        orig_h, orig_w = imgs.shape[1:3]
        post_hw = self._postprocess_hw(orig_h, orig_w)
        geoms = self._pyramid_geometries(orig_h, orig_w)
        device_pyramid = self.cfg.device_pyramid
        with float32_numerics(), torch.no_grad():
            if device_pyramid:
                imgs_u8 = to_device(imgs, self.device)
            fused = {}
            pair = self._fused_small_pair(geoms)
            if pair is not None:
                i, j = pair
                fused[i], fused[j] = self._fused_pyramid_maps(
                    imgs_u8, geoms[i][1:], geoms[j][1:], post_hw)
            paf_list, hm_list = [], []
            for k, (_, scaled_hw, padded_hw) in enumerate(geoms):
                if k in fused:
                    paf, hm = fused[k]
                else:
                    name = (f"{self._prefix_for(padded_hw)}_scale_"
                            f"{scaled_hw[0]}x{scaled_hw[1]}")
                    with annotate(name):
                        if device_pyramid:
                            paf, hm = self._pyramid_scale_maps(
                                imgs_u8, scaled_hw, padded_hw, post_hw)
                        else:
                            padded, pad = self._host_scaled(imgs, scaled_hw)
                            paf, hm = self._padded_scale_maps(
                                to_device(padded, self.device), pad, post_hw)
                paf_list.append(paf)
                hm_list.append(hm)
        return paf_list, hm_list, post_hw

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------

    def _prefix_for(self, forward_hw: Tuple[int, int]) -> str:
        """Program-name prefix of a forward at ``forward_hw``: ``poseq``
        when it runs int8, else ``pose``."""
        if (self.quantized
                and min(forward_hw) >= self._quant_min_side):
            return "poseq"
        return "pose"

    def _run(self, imgs: np.ndarray, precise: bool, postprocess: bool):
        """(B, H, W, 3) uint8 original frames -> the batch's ``PoseResult``
        (a leading frame axis) on the device (``postprocess``), or its
        channel-first maps the postprocess consumes; plus the map ->
        original scale factors.  The precise pyramid if ``precise``."""
        orig_h, orig_w = imgs.shape[1:3]
        if precise:
            paf_list, hm_list, (map_h, map_w) = self._precise_scale_maps(
                imgs)
            prefix = "poseq" if self.quantized else "pose"
            name = f"{prefix}_avg_postprocess_{map_h}x{map_w}"

            def maps():
                return self._average(paf_list, hm_list)
        else:
            with annotate("pose.resize"):
                (in_h, in_w), (map_h, map_w) = fast_geometry(
                    self.cfg, orig_h, orig_w)
                resized = np.empty((len(imgs), in_h, in_w) + imgs.shape[3:],
                                   np.uint8)
                for img, slot in zip(imgs, resized):
                    resize_u8_linear(img, (in_w, in_h), out=slot)
            name = f"{self._prefix_for((in_h, in_w))}_fast_{in_h}x{in_w}"

            def maps():
                return self._maps(resized, (map_h, map_w))
        with annotate(name):
            out = maps()
            if postprocess:
                with annotate("pose.postprocess"):
                    out = self._postprocess(*out)
        return out, (orig_w / map_w, orig_h / map_h)

    def _postprocess(self, paf: torch.Tensor, hm: torch.Tensor) -> PoseResult:
        """The postprocess of (..., 2L, h, w) and (..., J + 1, h, w) maps
        over the detector's topology, a frame axis or none; ``img_len`` is
        the map width: the fast path's map size, or the precise path's
        postprocess resolution."""
        with torch.no_grad():
            return postprocess_pose(paf, hm, paf.shape[-1], self.cfg,
                                    self.topology)

    def compute_maps(self, orig_img: np.ndarray):
        """The (pafs (2L, h, w), heatmaps (J + 1, h, w)) maps the
        postprocess consumes for this frame, per the architecture, plus the
        map -> original scale factors."""
        (paf, hm), scale = self._run(np.asarray(orig_img)[None],
                                     self.precise, postprocess=False)
        return (paf[0], hm[0]), scale

    def submit(self, orig_img: np.ndarray):
        """Run one frame up to its result on the device; returns a pending
        handle for ``collect``.  On the card everything is queued
        asynchronously: the frame's upload (from pinned memory), the
        forward and the postprocess's kernels; nothing reads back to the
        host before ``collect``'s one device-to-host copy."""
        return self._submit(orig_img, self.precise)

    def _submit(self, orig_img: np.ndarray, precise: bool):
        result, (scale_x, scale_y) = self._run(
            np.asarray(orig_img)[None], precise, postprocess=True)
        return PoseResult(*(f[0] for f in result)), scale_x, scale_y

    def collect(self, pending):
        """Copy a ``submit`` handle's result to the host; (poses, scores)."""
        result, scale_x, scale_y = pending
        with annotate("pose.fetch"):
            return self._emit(result, scale_x, scale_y)

    def detect_precise(self, orig_img: np.ndarray):
        """The precise pyramid on one frame, whatever the detector's mode
        (as the JAX package's ``detect_precise``); ``__call__`` of a precise
        detector goes through it."""
        return self.collect(self._submit(orig_img, precise=True))

    def detect_batch(self, imgs: np.ndarray):
        """(B, H, W, 3) uint8 same-sized frames -> list of (poses, scores).

        One upload and one batched forward (per pyramid scale in precise
        mode), one batched postprocess on the device, and one
        device-to-host copy fetches every result.  On a mesh every rank
        passes the same frames and gets the whole list; ``n_data`` must
        divide ``B`` (else ``ValueError``)."""
        result, (scale_x, scale_y) = self._run_batch(
            np.asarray(imgs), postprocess=True)
        with annotate("pose.fetch"):
            (host,) = results_to_host([result])
            out = [self._emit(PoseResult(*(f[j] for f in host)), scale_x,
                              scale_y) for j in range(len(host.valid))]
        if self.mesh is None:
            return out
        return all_gather_list(out, self.mesh.data_group)

    def compute_maps_batch(self, imgs: np.ndarray):
        """``detect_batch``'s maps: numpy float32 (B, 2L, h, w) PAFs and
        (B, J + 1, h, w) heatmaps (per the architecture), the postprocess's
        input, plus the map ->
        original scale factors; on a mesh, the whole batch's on every
        rank."""
        (paf, hm), scale = self._run_batch(np.asarray(imgs),
                                           postprocess=False)
        frames = list(zip(paf.cpu().numpy(), hm.cpu().numpy()))
        if self.mesh is not None:
            frames = all_gather_list(frames, self.mesh.data_group)
        return (np.stack([p for p, _ in frames]),
                np.stack([h for _, h in frames])), scale

    def _run_batch(self, imgs: np.ndarray, postprocess: bool):
        """``_run`` of a batch; on a mesh, of this data rank's frames, the
        net on this spatial rank's slabs."""
        if self.mesh is None:
            return self._run(imgs, self.precise, postprocess)
        first, stop = data_part(len(imgs), self.mesh)
        self._slabs_on = self.mesh.n_spatial > 1
        try:
            return self._run(imgs[first:stop], self.precise, postprocess)
        finally:
            self._slabs_on = False

    def _emit(self, result, scale_x: float, scale_y: float):
        poses, scores, self._warned_saturation = emit_result(
            result, scale_x, scale_y, warned=self._warned_saturation)
        return poses, scores

    def __call__(self, orig_img: np.ndarray):
        return self.collect(self.submit(orig_img))


AE_DECODER = "associative_embedding"


class AEPoseDetector(PoseDetector):
    """``PoseDetector`` of an associative-embedding architecture
    (``higherhrnet_w32``), which ``PoseDetector(arch)`` builds from the
    arch's ``decoder``: ``__call__``, ``submit``/``collect`` and
    ``compute_maps`` of one frame at a time, float32, with
    ``ops/ae_decode.py``'s decoder after the net.  Its ``cfg`` is an
    ``ae_decode.AEConfig`` (default: the published 512).  It takes no
    weight file (seeded weights only).  The precise pyramid, meshes,
    ``quantize()``, ``detect_batch`` and the serving bundle raise
    ``NotImplementedError``."""

    def __init__(self, arch: str, weights_file: Optional[str] = None,
                 params=None, precise: bool = False,
                 cfg=INFERENCE, device="cuda", seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 mesh: Optional[Mesh] = None):
        if precise or mesh is not None:
            self._unsupported("precise=True" if precise else "mesh=")
        if cfg is INFERENCE:
            cfg = ae.AE_DEFAULTS
        elif not isinstance(cfg, ae.AEConfig):
            raise TypeError(f"PoseDetector(arch={arch!r}) takes an "
                            "ae_decode.AEConfig as cfg")
        self.net = DetectorNet(arch, device, "PoseDetector", weights_file,
                               params, seed, compute_dtype)
        self.device = self.net.device
        self.arch = arch
        self.precise = False
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.topology = self.model.topology
        self.mesh = None

    def _unsupported(self, what: str):
        raise NotImplementedError(
            f"{what} is not implemented for the associative-embedding "
            "decoder: it runs __call__ and submit/collect, float32, one "
            "frame at a time")

    def quantize(self, *args, **kwargs):
        self._unsupported("quantize()")

    def host_weights(self):
        self._unsupported("the serving bundle")

    def program_weights(self, device=None):
        self._unsupported("the serving bundle")

    def detect_precise(self, orig_img: np.ndarray):
        self._unsupported("the precise pyramid")

    def detect_batch(self, imgs: np.ndarray):
        self._unsupported("detect_batch")

    def compute_maps_batch(self, imgs: np.ndarray):
        self._unsupported("compute_maps_batch")

    def _ae_run(self, img: np.ndarray, postprocess: bool):
        """One (H, W, 3) frame to its ``AEPending`` (``postprocess``), or
        to its maps, heatmaps (J, H, W) and tags (2, J, H, W) at the
        network input; plus the geometry."""
        geom = ae.ae_geometry(*img.shape[:2], self.cfg.input_size)
        with annotate("pose.resize"):
            canvas = ae.place_frame(img, geom,
                                    pin=self.device.type == "cuda")[None]
        with annotate(f"pose_fast_{geom.in_hw[0]}x{geom.in_hw[1]}"):
            with annotate("pose.upload"):
                u8 = to_device(canvas, self.device)
            with annotate("pose.forward"), float32_numerics(), \
                    torch.no_grad():
                out0, out1 = self.model(ae.with_mirror(ae.normalise(u8)))
                with annotate("hr.head"):
                    det, tags = ae.aggregate(out0, out1,
                                             self.topology.flip_index,
                                             geom.in_hw)
            if not postprocess:
                return (det, tags), geom
            with annotate("pose.postprocess"), annotate("ae.topk"), \
                    torch.no_grad():
                table = ae.top_k(det, tags)
                return ae.start_fetch(det, tags, table, geom), geom

    def compute_maps(self, orig_img: np.ndarray):
        """The (heatmaps (J, H, W), tags (2, J, H, W)) maps at the network
        input, and the frame pixels per input pixel (x, y)."""
        maps, geom = self._ae_run(np.asarray(orig_img), False)
        return maps, geom.scale

    def submit(self, orig_img: np.ndarray):
        """Queue one frame up to its candidate table's copy to the host;
        returns the pending frame for ``collect``, with no synchronising
        call."""
        return self._ae_run(np.asarray(orig_img), True)[0]

    def collect(self, pending):
        """The host match and the refine of a ``submit`` handle; (poses
        (N, J, 3) as x, y, value in frame pixels, scores)."""
        with annotate("pose.fetch"), torch.no_grad():
            persons, scores = ae.ae_decode(pending,
                                           self.topology.match_order)
            return ae.final_poses(persons, pending.geom), scores


def _check_replicated(qtree, mesh: Mesh) -> None:
    """Raise unless every rank of ``mesh`` holds the same int8 tree: a
    48-bit digest of its arrays, its minimum and maximum over the world
    (``all_reduce``) compared."""
    import hashlib

    import torch.distributed as dist

    if not mesh.distributed:
        return
    digest = hashlib.sha256()
    for path in sorted(qtree["qlayers"]):
        spec = qtree["qlayers"][path]
        for key in ("kernel_q", "mult"):
            for a in spec[key]:
                digest.update(np.ascontiguousarray(a).tobytes())
        digest.update(np.ascontiguousarray(spec["bias_eff"]).tobytes())
        if "slope" in spec:
            digest.update(np.ascontiguousarray(spec["slope"]).tobytes())
    for stage in sorted(qtree["part_scales"]):
        for a in qtree["part_scales"][stage]:
            digest.update(np.asarray(a, np.float64).tobytes())
    value = float(int(digest.hexdigest()[:12], 16))
    lo = torch.tensor([value], dtype=torch.float64, device=mesh.device)
    hi = lo.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    if lo.item() != hi.item():
        raise RuntimeError("quantize() on a mesh: the ranks' int8 trees "
                           "differ (calibrate every rank on the same "
                           "frames)")


def _main(argv=None):
    """The JAX package's pose CLI:
    ``python -m tpupose_torch.detectors.pose posenet <npz> --img x.png
    [--precise] [--device cpu]``; ``body25`` and ``higherhrnet_w32`` take
    no weight file (their seeded weights)."""
    import argparse

    import cv2

    from tpupose_torch.detectors.draw import draw_person_pose

    p = argparse.ArgumentParser(description="Pose detector")
    p.add_argument("arch", choices=("posenet", "body25", "higherhrnet_w32"))
    p.add_argument("weights", nargs="?",
                   help="weights file path (.npz); none for body25 and "
                   "higherhrnet_w32")
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
    cv2.imwrite(args.out, draw_person_pose(img, poses, detector.topology))


if __name__ == "__main__":
    _main()
