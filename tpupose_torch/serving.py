"""AOT serving bundles: ``torch.export``'ed detector programs + weights
(port of ``tpupose/serving.py``).

The detector programs for each serving image geometry (the fast-path
program, or the precise pyramid's per-scale programs and its cross-scale
average + postprocess program; the crop nets' batched forward and per-crop
tails) are traced with ``torch.export`` and saved next to the weights, so a
serving process runs the detector without the detector code tracing
anything.  Each program takes the weights as inputs: ``params.npz`` holds
them once, however many programs and platforms the bundle has.

Layout of a bundle directory::

    meta.json      arch, mode, params_dtype, cfg, platforms and the
                   geometry table, with the JAX package's keys; int8
                   bundles add conv7_impl and quant_static
    params.npz     the JAX package's keys: a float tree's Flax paths
                   joined by '/' (stored float32 whatever params_dtype
                   says: npz holds no bfloat16), an int8 tree's
                   ``qtree_to_flat`` keys
    <program>.<platform>.pt2     one ``torch.export.save`` file per
                   program and platform; meta.json names each program
                   without the suffix: fast_<H>x<W>, fast_<H>x<W>_b<B>,
                   precise_<H>x<W>[_b<B>]_scale<k>, precise_<H>x<W>
                   [_b<B>]_avg, crop_forward_b<B>, crop_tail_<H>x<W>_f<0|1>

``platforms`` are taken from ``("cpu", "cuda")``.  Programs are traced on
fake tensors of the platform's device (no data, nothing stored twice);
CUDA programs need CUDA to trace.  The kernels stay in the programs as
``tpupose::*`` ops (``ops/library.py::traced_ops``): on the card a program
launches the hand kernels, which count their launches in their wrappers
as in a live forward; on the CPU it runs their plain versions.

The runners enter ``float32_numerics()`` around every call (cuDNN's TF32
changes pose tables) and resize on the host with ``resize_u8_linear``, as
the live detectors do, so a bundle's pose tables equal the live
detector's.  These process-wide flags make it the caller's job to keep two
forwards of one process from overlapping (``apps/serve.py`` runs every
forward on one device thread).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from tpupose_torch import config as config_mod
from tpupose_torch.config import InferenceConfig
from tpupose_torch.detectors.crop_keypoints import CropKeypointDetector
from tpupose_torch.detectors.net import float32_numerics
from tpupose_torch.detectors.pose import (emit_result, fast_geometry,
                                          results_to_host, single_frame)
from tpupose_torch.ops.library import traced_ops
from tpupose_torch.ops.postprocess import PoseResult
from tpupose_torch.ops.resize import resize_u8_linear
from tpupose_torch.quant import (qtree_from_flat, qtree_to_device,
                                 qtree_to_flat, static_from_dict,
                                 static_to_dict)
from tpupose_torch.weights import state_dict_from_flax

# The programs return a PoseResult; its pytree type needs a name for
# serialization in both the exporting and the serving process (this module
# is imported by both sides).
pytree._register_namedtuple(
    PoseResult,
    serialized_type_name="tpupose_torch.ops.postprocess.PoseResult")

_META = "meta.json"
_PARAMS = "params.npz"
_QUANT_DTYPE = "quant-w8a8"
PLATFORMS = ("cpu", "cuda")


def _canonical(tree):
    """``tree`` with every dict's keys sorted: the order an exported
    program's input spec records, whichever way the weights were built."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_canonical(v) for v in tree)
    return tree


def _check_platforms(platforms) -> Tuple[str, ...]:
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms {platforms}: choose from {PLATFORMS}")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError("exporting CUDA programs traces on CUDA fake "
                           "tensors and needs CUDA; CUDA is not available")
    return platforms


class _Program(torch.nn.Module):
    """``torch.export`` takes a module: this one holds a program function
    as a plain attribute, so no parameter is registered and the weights
    stay program inputs.  With ``spec`` the program takes the weights as
    one flat list of tensors (``spec``'s leaves, in order) and rebuilds
    their tree inside the trace: the call then flattens a list, not a
    nested tree of ~450 int8 leaves."""

    def __init__(self, fn, spec=None):
        super().__init__()
        self.fn = fn
        self.spec = spec

    def forward(self, *args):
        if self.spec is None:
            return self.fn(*args)
        flat, *rest = args
        return self.fn(pytree.tree_unflatten(list(flat), self.spec), *rest)


class _Exporter:
    """Traces program functions on fake tensors of each platform and writes
    one ``.pt2`` file per program and platform."""

    def __init__(self, path: str, platforms, weights_cpu):
        from torch._subclasses.fake_tensor import FakeTensorMode

        self.path = path
        self.platforms = platforms
        self.mode = FakeTensorMode(allow_non_fake_inputs=True)
        leaves, self.treespec = pytree.tree_flatten(weights_cpu)
        self.weights = {p: self.fake(leaves, p) for p in platforms}

    def fake(self, tree, platform: str):
        """Fake tensors of ``tree``'s shapes and dtypes on ``platform``."""

        def make(t):
            with self.mode:
                return torch.empty(tuple(t.shape), dtype=t.dtype,
                                   device=platform)

        return pytree.tree_map(make, tree)

    def spec(self, shape, dtype, platform):
        with self.mode:
            return torch.empty(tuple(shape), dtype=dtype, device=platform)

    def write(self, fn, name: str, make_args, weights: bool = True) -> str:
        """Export ``fn`` once per platform on the weights (unless
        ``weights`` is False) and ``make_args(platform)``; returns the
        program's name as meta.json records it."""
        for platform in self.platforms:
            args = tuple(make_args(platform))
            if weights:
                args = (self.weights[platform],) + args
            with torch.no_grad():
                ep = torch.export.export(
                    _Program(fn, self.treespec if weights else None), args,
                    strict=False)
            # the example inputs are fake: keep them out of the file
            ep._example_inputs = None
            torch.export.save(ep, os.path.join(self.path,
                                               f"{name}.{platform}.pt2"))
        return name


def save_bundle(det, path: str, image_sizes: List[Tuple[int, int]],
                platforms: Tuple[str, ...] = PLATFORMS,
                batch_sizes: Tuple[int, ...] = ()) -> None:
    """Export ``det``'s serving programs for each (orig_h, orig_w) image
    size and write a self-contained bundle to ``path``.

    Fast detectors export one program per geometry; precise detectors the
    device pyramid's per-scale programs plus the cross-scale average +
    postprocess program (one upload of the original frame per request, as
    in the live detector).  Quantized (w8a8) detectors export their int8
    programs and tree the same way.  ``batch_sizes``: also export batched
    programs per geometry, for ``ServingPoseDetector.detect_batch``."""
    platforms = _check_platforms(platforms)
    if det.precise and not det.cfg.device_pyramid:
        raise ValueError("precise serving bundles require "
                         "cfg.device_pyramid=True")
    if det.precise and det.cfg.fuse_small_scales:
        raise ValueError(
            "export with cfg.fuse_small_scales=False: the fused pair "
            "changes small-scale border values, and bundles pin exact "
            "serving semantics")
    params_dtype = _params_dtype(det)
    os.makedirs(path, exist_ok=True)
    _save_params(path, det.host_weights(), params_dtype)
    ex = _Exporter(path, platforms, _canonical(det.program_weights("cpu")))
    u8, f32 = torch.uint8, torch.float32

    mode = "precise" if det.precise else "fast"
    channels = (det.topology.paf_channels, det.topology.heatmap_channels)
    geoms: Dict[str, dict] = {}
    with traced_ops(), float32_numerics():
        for orig_h, orig_w in image_sizes:
            key = f"{orig_h}x{orig_w}"
            if det.precise:
                post_hw = det._postprocess_hw(orig_h, orig_w)
                pyramid = det._pyramid_geometries(orig_h, orig_w)
                sizes = {"post_hw": list(post_hw)}
            else:
                in_hw, map_hw = fast_geometry(det.cfg, orig_h, orig_w)
                sizes = {"in_hw": list(in_hw), "map_hw": list(map_hw)}

            def programs(prefix, lead):
                """The geometry's programs on ``lead`` frames: ``(b,)``, a
                batch, or ``()``, one frame (``single_frame``)."""
                adapt = (lambda fn: fn) if lead else single_frame
                if not det.precise:
                    return {"program": ex.write(
                        adapt(det._fast_fn(map_hw)), prefix,
                        lambda p: (ex.spec((*lead, *in_hw, 3), u8, p),))}
                return {
                    "scale_programs": [ex.write(
                        adapt(det._scale_fn(post_hw, scaled_hw, padded_hw)),
                        f"{prefix}_scale{k}",
                        lambda p: (ex.spec((*lead, orig_h, orig_w, 3), u8,
                                           p),))
                        for k, (_, scaled_hw, padded_hw) in
                        enumerate(pyramid)],
                    "avg_program": ex.write(
                        det._avg_postprocess_fn(), f"{prefix}_avg",
                        lambda p: [[ex.spec((*lead, *post_hw, c), f32, p)
                                    for _ in pyramid] for c in channels],
                        weights=False)}

            geoms[key] = {**programs(f"{mode}_{key}", ()), **sizes}
            batched = {str(b): programs(f"{mode}_{key}_b{b}", (b,))
                       for b in batch_sizes}
            if batched:
                geoms[key]["batched"] = batched

    meta = {
        "arch": det.arch,
        "mode": mode,
        "params_dtype": params_dtype,
        "cfg": dataclasses.asdict(det.cfg),
        "platforms": list(platforms),
        "geometries": geoms,
    }
    meta.update(_quant_meta(det))
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)


def _quant_meta(det) -> dict:
    """What a loader needs to rebuild an int8 device tree: the route (the
    kernel route packs weights for the kernels) and the layers' static
    info."""
    if not det.quantized:
        return {}
    return {"conv7_impl": det.conv7_impl,
            "quant_static": static_to_dict(det.quant_static)}


def _cfg_from_meta(d: dict, cls=InferenceConfig):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in d.items():
        if k in fields:
            kw[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)


def _flatten_params(params, prefix=()) -> Dict[str, np.ndarray]:
    """A Flax param tree -> ``{"block/layer/conv/kernel": array}``."""
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update(_flatten_params(v, prefix + (k,)))
        else:
            flat["/".join(prefix + (k,))] = np.asarray(v)
    return flat


def _unflatten_params(flat) -> dict:
    params: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return params


def _params_dtype(det) -> str:
    """The params dtype a bundle of ``det`` records: ``"quant-w8a8"`` for an
    int8 tree, else the one float dtype of the model's parameters
    (``"float32"`` or ``"bfloat16"``).  A model mixing float dtypes is
    refused, as the JAX package refuses such a tree: one recorded dtype
    could not rebuild it at load time."""
    if det.quantized:
        return _QUANT_DTYPE
    names = sorted({str(v.dtype).removeprefix("torch.")
                    for v in det.model.state_dict().values()
                    if v.is_floating_point()})
    if len(names) > 1:
        raise ValueError(
            f"param tree mixes float dtypes {names}; commit the detector's "
            "params in one dtype before exporting")
    return names[0] if names else "float32"


def _save_params(path: str, host_weights,
                 params_dtype: str = "float32") -> str:
    """Write params.npz from ``det.host_weights()``: an int8 tree with
    ``qtree_to_flat``, a float tree as float32.  Returns the params dtype
    the bundle records: ``"quant-w8a8"`` for an int8 tree, else
    ``params_dtype`` (``_params_dtype``'s)."""
    if "qlayers" in host_weights:
        np.savez(os.path.join(path, _PARAMS), **qtree_to_flat(host_weights))
        return _QUANT_DTYPE
    flat = _flatten_params(host_weights["params"])
    np.savez(os.path.join(path, _PARAMS),
             **{k: v.astype(np.float32) for k, v in flat.items()})
    return params_dtype


def load_params(path: str, meta: dict, device):
    """A bundle's params.npz as its programs take them, on ``device``: the
    ``state_dict`` of a float bundle, cast to its ``params_dtype``
    (``"float32"`` or ``"bfloat16"``); the int8 device tree of a quantized
    one, rebuilt by ``qtree_from_flat`` + ``qtree_to_device`` (the kernel
    route's packed weights are made here, never stored), with the float32
    ``state_dict`` under ``"f32"`` for a mixed tree.  Reads files the JAX
    package's ``_save_params`` wrote too."""
    device = torch.device(device)

    def tensors(state):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in state.items()}

    with np.load(os.path.join(path, _PARAMS)) as z:
        flat = {k: z[k] for k in z.files}
    pd = meta.get("params_dtype", "float32")
    if pd == _QUANT_DTYPE:
        tree = qtree_from_flat(flat)
        f32 = tree.pop("f32", None)
        static = static_from_dict(meta["quant_static"])
        weights = qtree_to_device(tree, static, device,
                                  meta.get("conv7_impl", "im2col"))
        if f32 is not None:
            weights["f32"] = tensors(state_dict_from_flax(f32))
        return _canonical(weights)
    if pd not in ("float32", "bfloat16"):
        raise ValueError(f"params_dtype {pd!r}: the port serves float32, "
                         "bfloat16 and quant-w8a8 bundles")
    state = tensors(state_dict_from_flax(_unflatten_params(flat)))
    return _canonical({k: v.to(getattr(torch, pd))
                       for k, v in state.items()})


def _read_meta(path: str) -> dict:
    with open(os.path.join(path, _META)) as f:
        return json.load(f)


def _check_device(cls_name: str, device, meta: dict) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{cls_name}(device={str(device)!r}): CUDA is "
                           "not available")
    if device.type not in meta["platforms"]:
        raise ValueError(f"the bundle holds programs for "
                         f"{meta['platforms']}, not {device.type}")
    return device


def _program_loader(path: str, platform: str, flat_weights):
    """``load(name, weights=True)``: a program's module.  A program that
    takes the weights has them checked once here, leaf by leaf against its
    inputs' shapes and dtypes; the per-call validation of every input
    (~6 ms of host time for an int8 program's ~450 leaves) is switched
    off, since the runners pick programs by the frame's exact size."""

    def load(name, weights: bool = True):
        module = torch.export.load(
            os.path.join(path, f"{name}.{platform}.pt2")).module()
        if weights:
            inputs = [n.meta["val"] for n in module.graph.nodes
                      if n.op == "placeholder"]
            if len(inputs) < len(flat_weights) or any(
                    tuple(v.shape) != tuple(t.shape) or v.dtype != t.dtype
                    for v, t in zip(inputs, flat_weights)):
                raise ValueError(f"{name}: params.npz does not match the "
                                 "program's weight inputs")
        module.validate_inputs = False
        return module

    return load


class ServingPoseDetector:
    """Runs a saved bundle: loaded programs + the weights of params.npz.

    API-compatible with ``PoseDetector`` (``__call__``, ``submit`` /
    ``collect``, and ``detect_batch`` when the bundle was exported with
    ``batch_sizes``), without building the model; only the geometries
    exported into the bundle are servable.  ``device`` picks the platform
    whose programs run (default the card)."""

    def __init__(self, path: str, device="cuda"):
        meta = _read_meta(path)
        if meta.get("mode") == "crop":
            raise ValueError("this is a crop-net bundle; load it with "
                             "ServingCropDetector")
        self.device = _check_device(type(self).__name__, device, meta)
        self.arch = meta["arch"]
        self.mode = meta.get("mode", "fast")
        self.precise = self.mode == "precise"
        self.quantized = meta.get("params_dtype") == _QUANT_DTYPE
        self.cfg = _cfg_from_meta(meta["cfg"])
        self.weights = pytree.tree_leaves(load_params(path, meta,
                                                      self.device))
        load = _program_loader(path, self.device.type, self.weights)
        self._by_size: Dict[Tuple[int, int], tuple] = {}
        self._batched: Dict[Tuple[int, int], Dict[int, tuple]] = {}
        for key, g in meta["geometries"].items():
            h, w = (int(t) for t in key.split("x"))
            if self.precise:
                self._by_size[(h, w)] = (
                    [load(n) for n in g["scale_programs"]],
                    load(g["avg_program"], weights=False),
                    tuple(g["post_hw"]))
                self._batched[(h, w)] = {
                    int(b): ([load(n) for n in bg["scale_programs"]],
                             load(bg["avg_program"], weights=False))
                    for b, bg in g.get("batched", {}).items()}
            else:
                self._by_size[(h, w)] = (
                    load(g["program"]), tuple(g["in_hw"]),
                    tuple(g["map_hw"]))
                self._batched[(h, w)] = {
                    int(b): (load(bg["program"]),)
                    for b, bg in g.get("batched", {}).items()}
        self._warned_saturation = False

    @property
    def image_sizes(self) -> List[Tuple[int, int]]:
        return sorted(self._by_size)

    def batch_sizes(self, image_size: Tuple[int, int]) -> List[int]:
        """Batched-program sizes exported for an image size ([] = none)."""
        return sorted(self._batched.get(tuple(image_size), {}))

    def _entry(self, orig_h: int, orig_w: int):
        entry = self._by_size.get((orig_h, orig_w))
        if entry is None:
            raise ValueError(
                f"no program exported for image size {(orig_h, orig_w)}; "
                f"bundle serves {self.image_sizes}")
        return entry

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def _run(self, entry, frames: np.ndarray, programs=None):
        """One frame (H, W, 3) or a batch (B, H, W, 3) through the entry's
        programs (``programs``: a batched set); returns the device result
        and the map size."""
        with float32_numerics(), torch.no_grad():
            if self.precise:
                scale_programs, avg_program = programs or entry[:2]
                orig = self._upload(frames)
                maps = [p(self.weights, orig) for p in scale_programs]
                return (avg_program([m[0] for m in maps],
                                    [m[1] for m in maps]), entry[2])
            program = programs[0] if programs else entry[0]
            in_h, in_w = entry[1]
            resized = (np.stack([resize_u8_linear(f, (in_w, in_h))
                                 for f in frames]) if frames.ndim == 4
                       else resize_u8_linear(frames, (in_w, in_h)))
            return program(self.weights, self._upload(resized)), entry[2]

    def submit(self, orig_img: np.ndarray):
        """Queue one frame's programs on the device; returns a pending
        handle for ``collect`` (the live detector's streaming API)."""
        orig_img = np.asarray(orig_img)
        orig_h, orig_w = orig_img.shape[:2]
        result, map_hw = self._run(self._entry(orig_h, orig_w), orig_img)
        return result, orig_w / map_hw[1], orig_h / map_hw[0]

    def collect(self, pending):
        """Copy a ``submit`` handle's result to the host; (poses,
        scores)."""
        result, scale_x, scale_y = pending
        poses, scores, self._warned_saturation = emit_result(
            result, scale_x, scale_y, warned=self._warned_saturation)
        return poses, scores

    def __call__(self, orig_img: np.ndarray):
        return self.collect(self.submit(orig_img))

    def detect_batch(self, imgs: np.ndarray):
        """Same-sized frames through the bundle's batched programs
        (``save_bundle(..., batch_sizes=...)``); larger batches chunk over
        the largest exported size, the last chunk padded with repeats of
        its last frame (exact: frames are independent).  Mirrors
        ``PoseDetector.detect_batch``."""
        imgs = np.asarray(imgs)
        n_total, orig_h, orig_w = imgs.shape[:3]
        programs = self._batched.get((orig_h, orig_w))
        if not programs:
            raise ValueError(
                f"no batched programs exported for image size "
                f"{(orig_h, orig_w)}; re-export with "
                f"save_bundle(..., batch_sizes=...) or use submit/collect")
        entry = self._entry(orig_h, orig_w)
        cap = max(programs)
        out = []
        for i in range(0, n_total, cap):
            chunk = imgs[i:i + cap]
            n_real = len(chunk)
            b = next(bb for bb in sorted(programs) if bb >= n_real)
            if n_real < b:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], b - n_real, axis=0)])
            result, map_hw = self._run(entry, chunk, programs[b])
            (host,) = results_to_host([result])
            for j in range(n_real):
                poses, scores, self._warned_saturation = emit_result(
                    PoseResult(*(f[j] for f in host)), orig_w / map_hw[1],
                    orig_h / map_hw[0], warned=self._warned_saturation)
                out.append((poses, scores))
        return out


# ---------------------------------------------------------------------------
# Crop-net bundles (FaceNet / HandNet)
# ---------------------------------------------------------------------------


_CROP_CFGS = {"facenet": "FaceConfig", "handnet": "HandConfig"}


def save_crop_bundle(det, path: str, crop_sizes: List[Tuple[int, int]],
                     batch_sizes: Tuple[int, ...] = (1, 4, 8),
                     flips: Tuple[bool, ...] = (False, True),
                     platforms: Tuple[str, ...] = PLATFORMS) -> None:
    """Export a ``CropKeypointDetector``'s programs: the batched forward
    per batch size, plus the resize + argmax tail per (crop size, flip).
    Quantized (w8a8) detectors export their int8 programs and tree the same
    way."""
    platforms = _check_platforms(platforms)
    params_dtype = _params_dtype(det)
    os.makedirs(path, exist_ok=True)
    _save_params(path, det.net.host_weights(), params_dtype)
    ex = _Exporter(path, platforms,
                   _canonical(det.net.program_weights("cpu")))
    s = det.cfg.img_size
    net_hw = (s // 8, s // 8)
    num_ch = det.cfg.num_keypoints + 1
    forwards, tails = {}, {}
    with traced_ops(), float32_numerics():
        for b in batch_sizes:
            forwards[str(b)] = ex.write(
                det._batch_forward_fn(), f"crop_forward_b{b}",
                lambda p, b=b: (ex.spec((b, s, s, 3), torch.uint8, p),))
        for crop_hw in crop_sizes:
            target_hw, scale = det._tail_target(tuple(crop_hw))
            for flip in flips:
                key = f"{crop_hw[0]}x{crop_hw[1]}:{int(flip)}"
                tails[key] = {
                    "program": ex.write(
                        det._tail_fn(target_hw, flip),
                        f"crop_tail_{crop_hw[0]}x{crop_hw[1]}_f{int(flip)}",
                        lambda p: (ex.spec((*net_hw, num_ch), torch.float32,
                                           p),), weights=False),
                    "scale": list(scale),
                }
    meta = {
        "arch": det.arch,
        "mode": "crop",
        "params_dtype": params_dtype,
        "cfg": dataclasses.asdict(det.cfg),
        "tail_stride": det.tail_stride,
        "platforms": list(platforms),
        "forwards": forwards,
        "tails": tails,
    }
    meta.update(_quant_meta(det))
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)


class ServingCropDetector:
    """Runs a saved crop-net bundle (FaceNet / HandNet): the batched
    forward and the per-geometry tails, without building the model.

    ``detect_crops(crops, flips)`` mirrors ``CropKeypointDetector``; only
    the exported crop sizes are servable, and crop lists longer than the
    largest exported batch are chunked over it, the last chunk padded."""

    def __init__(self, path: str, device="cuda"):
        meta = _read_meta(path)
        if meta.get("mode") != "crop":
            raise ValueError(
                "not a crop-net bundle; load it with ServingPoseDetector")
        self.device = _check_device(type(self).__name__, device, meta)
        self.arch = meta["arch"]
        self.quantized = meta.get("params_dtype") == _QUANT_DTYPE
        self.cfg = _cfg_from_meta(meta["cfg"],
                                  getattr(config_mod, _CROP_CFGS[self.arch]))
        self.tail_stride = meta.get("tail_stride", 1)
        self.weights = pytree.tree_leaves(load_params(path, meta,
                                                      self.device))
        load = _program_loader(path, self.device.type, self.weights)
        self._forwards = {int(b): load(n)
                          for b, n in meta["forwards"].items()}
        self._tails = {}
        for key, t in meta["tails"].items():
            hw, flip = key.split(":")
            h, w = (int(v) for v in hw.split("x"))
            self._tails[(h, w, bool(int(flip)))] = (
                load(t["program"], weights=False), tuple(t["scale"]))

    @property
    def crop_sizes(self):
        return sorted({(h, w) for (h, w, _) in self._tails})

    def detect_crop(self, crop: np.ndarray, flip: bool = False):
        return self.detect_crops([crop], [flip])[0]

    def detect_crops(self, crops, flips=None):
        return self.collect_crops(self.submit_crops(crops, flips))

    def submit_crops(self, crops, flips=None):
        """Queue the batched forwards and every crop's tail without a
        device-to-host copy; returns a pending handle for
        ``collect_crops``, as the live detector's."""
        if not len(crops):
            return []
        flips = list(flips) if flips else [False] * len(crops)
        tails = []
        for crop, flip in zip(crops, flips):
            key = (crop.shape[0], crop.shape[1], bool(flip))
            if key not in self._tails:
                raise ValueError(
                    f"no tail exported for crop size {key[:2]} "
                    f"flip={key[2]}; bundle serves {self.crop_sizes}")
            tails.append(self._tails[key])
        s = self.cfg.img_size
        prepped = np.stack([
            resize_u8_linear(np.asarray(c)[:, ::-1] if f else np.asarray(c),
                             (s, s)) for c, f in zip(crops, flips)])
        cap = max(self._forwards)
        rows = []
        with float32_numerics(), torch.no_grad():
            for i in range(0, len(prepped), cap):
                chunk = prepped[i:i + cap]
                n_real = len(chunk)
                b = next(bb for bb in sorted(self._forwards) if bb >= n_real)
                if n_real < b:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], b - n_real, axis=0)])
                heatmaps = self._forwards[b](
                    self.weights, torch.from_numpy(chunk).to(self.device))
                for hm, (tail, _) in zip(heatmaps[:n_real],
                                         tails[i:i + n_real]):
                    rows.append(tail(hm))
        return torch.stack(rows), [scale for _, scale in tails]

    def collect_crops(self, pending):
        """Copy a ``submit_crops`` handle's results to the host (one copy);
        per crop, a list of ``[x, y, score]`` or None per channel."""
        if not pending:
            return []
        rows, scales = pending
        rows = rows.cpu().numpy()
        return [CropKeypointDetector._to_keypoints(r, scale)
                for r, scale in zip(rows, scales)]
