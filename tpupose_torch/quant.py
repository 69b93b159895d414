"""Post-training w8a8 int8 inference (port of ``tpupose/quant.py``).

The scheme is the JAX package's, unchanged: symmetric per-output-channel
int8 weights; symmetric int8 activations ``v = a * X`` with ``a = range /
127`` taken from a calibration forward; the image layer quantized losslessly
as ``X = u8 - 128``; the refine stages' concat entering each stage kept as
separate groups at their own scales; the per-stage output convs (heads) left
in float32.  The quantization tree matches the JAX one key for key (layer
paths such as ``"stem/conv1_1"``, HWIO int8 kernels), so the two compare
directly.  ``tpupose/quant.py`` imports jax, so the numpy pieces are copies.

The forward keeps activations as NHWC int8 tensors.  PyTorch has no int8
convolution (on the CPU ``F.conv2d`` wraps int8 sums mod 256; on the card
there is none), so every layer is an exact integer matmul:

- with ``conv7_impl="kernel"`` every int8 layer that is not a head runs on
  a hand-written CUDA kernel with the requantize epilogue fused: the 7x7
  layers on ``ops/conv7.py::conv7_s8``, the 1x1 and 3x3 ones on
  ``ops/conv_s8.py::conv_s8`` (on CPU tensors each runs its plain version);
- with ``conv7_impl="im2col"`` they run as im2col + ``torch._int_mm`` into
  int32, then the requantize epilogue ``ops/requant.py::requant_epilogue``
  (the CUDA kernel on the card, its plain version on the CPU);
- the heads (float32 out, 38 or 19 channels) always run as im2col +
  ``torch._int_mm`` and the float32 epilogue.

Routing is by the tensors' device only; no grid-size threshold applies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpupose_torch.ops.conv7 import im2col_acc_s8, pack_conv7_weights
from tpupose_torch.ops.conv_s8 import pack_conv_s8_weights
from tpupose_torch.ops.library import conv7_s8, conv_s8, requant_epilogue
from tpupose_torch.ops.requant import scaled_sum

# ---------------------------------------------------------------------------
# Architecture graphs (copies of the JAX module's): layer names are the
# Chainer-parity module names
# ---------------------------------------------------------------------------

# (layer_name, pool_after) for the two stems
VGG19_STEM = [
    ("conv1_1", False), ("conv1_2", True),
    ("conv2_1", False), ("conv2_2", True),
    ("conv3_1", False), ("conv3_2", False), ("conv3_3", False),
    ("conv3_4", True),
    ("conv4_1", False), ("conv4_2", False),
    ("conv4_3_CPM", False), ("conv4_4_CPM", False),
]
VGGFACE_STEM = [
    ("conv1_1", False), ("conv1_2", True),
    ("conv2_1", False), ("conv2_2", True),
    ("conv3_1", False), ("conv3_2", False), ("conv3_3", False),
    ("conv3_4", True),
    ("conv4_1", False), ("conv4_2", False), ("conv4_3", False),
    ("conv4_4", False),
    ("conv5_1", False), ("conv5_2", False), ("conv5_3_CPM", False),
]


def _stage1_branch(suffix: str) -> List[str]:
    return [f"conv5_{i}_CPM{suffix}" for i in range(1, 6)]


def _refine_branch(stage: int, suffix: str) -> List[str]:
    return [f"Mconv{i}_stage{stage}{suffix}" for i in range(1, 8)]


@dataclasses.dataclass(frozen=True)
class ArchGraph:
    """Quantizer's view of one CPM architecture."""

    stem: List[Tuple[str, bool]]
    two_branch: bool
    num_stages: int = 6

    def stage_modules(self, stage: int) -> List[str]:
        if self.two_branch:
            return [f"stage{stage}_L1", f"stage{stage}_L2"]
        return [f"stage{stage}"]

    def branch_layers(self, stage: int, module: str) -> List[str]:
        if stage == 1:
            if self.two_branch:
                return _stage1_branch("_L" + module[-1])
            return ["conv6_1_CPM", "conv6_2_CPM"]
        suffix = "_L" + module[-1] if self.two_branch else ""
        return _refine_branch(stage, suffix)


ARCH_GRAPHS: Dict[str, ArchGraph] = {
    "posenet": ArchGraph(stem=VGG19_STEM, two_branch=True),
    "facenet": ArchGraph(stem=VGGFACE_STEM, two_branch=False),
    "handnet": ArchGraph(stem=VGGFACE_STEM, two_branch=False),
}


# ---------------------------------------------------------------------------
# Calibration: per-tensor max-abs ranges from the f32 model
# ---------------------------------------------------------------------------


def calibrate_ranges(model: nn.Module, frames_normalized: torch.Tensor
                     ) -> Dict[str, float]:
    """Run the f32 model over normalized (B, H, W, 3) frames, one at a time,
    and return ``path -> max|value|`` of every submodule's output, with the
    JAX package's paths (``"stem/conv1_1"``, ``"stem/conv1_1/conv"``,
    ``"stage2_L1"``, ...).

    Forward hooks take each maximum on the frames' device; one host copy per
    frame brings them back."""
    maxes: Dict[str, torch.Tensor] = {}

    def hook(path):
        def record(module, inputs, output):
            maxes[path] = output.detach().abs().amax()
        return record

    handles = [module.register_forward_hook(hook(name.replace(".", "/")))
               for name, module in model.named_modules() if name]
    ranges: Dict[str, float] = {}
    try:
        with torch.no_grad():
            for frame in frames_normalized:
                maxes.clear()
                model(frame[None])
                paths = list(maxes)
                values = torch.stack([maxes[p] for p in paths]).cpu().tolist()
                for path, m in zip(paths, values):
                    ranges[path] = max(ranges.get(path, 0.0), float(m))
    finally:
        for handle in handles:
            handle.remove()
    return ranges


# ---------------------------------------------------------------------------
# Quantization: f32 weights + ranges -> int8 spec tree (numpy)
# ---------------------------------------------------------------------------

_EPS = 1e-12


def _quantize_kernel(kernel: np.ndarray):
    """Per-output-channel symmetric int8: returns (kq, ws) with
    ws shape (O,)."""
    ws = np.maximum(np.abs(kernel).reshape(-1, kernel.shape[-1]).max(axis=0),
                    _EPS) / 127.0
    kq = np.clip(np.round(kernel / ws), -127, 127).astype(np.int8)
    return kq, ws.astype(np.float32)


def _layer_spec(params, module: str, layer: str,
                groups: List[Tuple[float, float, int]],
                relu: bool, a_out: Optional[float]):
    """Build one quantized conv layer's arrays.

    ``groups``: per input-channel group ``(a_in, z_in, n_channels)``; the
    concat entering each refinement stage keeps one group per member.
    ``a_out=None`` -> float32 output (head).  Folded epilogue:
    ``y = sum_g acc_g * mult_g + bias_eff`` in output-scale units (real
    units for heads)."""
    conv = params[module][layer]["conv"]
    kernel = np.asarray(conv["kernel"], np.float32)
    bias = np.asarray(conv["bias"], np.float32)
    if sum(n for _, _, n in groups) != kernel.shape[2]:
        raise ValueError(f"{module}/{layer}: groups {groups} do not cover "
                         f"kernel {kernel.shape}")
    kqs, mults, splits = [], [], []
    bias_eff = (bias if a_out is None else bias / a_out).astype(np.float64)
    start = 0
    for a_in, z_in, n in groups:
        part = kernel[:, :, start:start + n, :]
        start += n
        kq, ws = _quantize_kernel(part)
        s_o = kq.astype(np.int64).sum(axis=(0, 1, 2)).astype(np.float64)
        mult = a_in * ws if a_out is None else a_in * ws / a_out
        # z_in is 0 everywhere except the image layer's 0.5; the constant
        # z * S_o correction folds into the bias.
        bias_eff = bias_eff + z_in * s_o * mult
        kqs.append(kq)
        mults.append(mult.astype(np.float32))
        splits.append(int(n))
    return {
        "kernel_q": tuple(kqs),
        "mult": tuple(mults),
        "bias_eff": bias_eff.astype(np.float32),
        "meta": {
            "ksize": int(kernel.shape[0]),
            "relu": bool(relu),
            "splits": tuple(splits),
            "f32_out": a_out is None,
        },
    }


def model_params(model: nn.Module) -> Dict[str, dict]:
    """A torch CPM model's convs as the JAX package's param tree:
    ``params[module][layer]["conv"]`` with numpy HWIO ``kernel`` and
    ``bias``."""
    params: Dict[str, dict] = {}
    for name, conv in model.named_modules():
        if isinstance(conv, nn.Conv2d):
            module, layer, _ = name.split(".")
            params.setdefault(module, {})[layer] = {"conv": {
                "kernel": conv.weight.detach().cpu().numpy().transpose(
                    2, 3, 1, 0),
                "bias": conv.bias.detach().cpu().numpy()}}
    return params


@dataclasses.dataclass(frozen=True)
class QuantStatic:
    """Per-layer static info the forward closes over."""

    arch: str
    layer_meta: Dict[str, dict]
    stem: Tuple[Tuple[str, bool], ...]
    two_branch: bool
    num_stages: int
    input_a: float
    input_z: float


def quantize(arch: str, model: nn.Module, ranges: Dict[str, float],
             input_quant: Optional[Tuple[float, float]] = None):
    """f32 ``model`` + calibration ``ranges`` -> ``(qtree, static)``.

    ``input_quant``: the lossless ``(a, z)`` of the preprocess, normalized
    pixels being ``v = a * (X + z)`` with ``X = u8 - 128``: posenet's
    ``u8/255 - 0.5`` is ``(1/255, 0.5)``, the crop nets' ``u8/256 - 0.5`` is
    ``(1/256, 0)``.  The tree holds numpy arrays: ``{"qlayers": {path:
    {kernel_q, mult, bias_eff}}, "part_scales": {stage: (a_head, ...)}}``;
    ``qtree_to_device`` makes the forward's tensors from it."""
    if input_quant is None:
        input_quant = (1.0 / 255.0, 0.5) if arch == "posenet" \
            else (1.0 / 256.0, 0.0)
    graph = ARCH_GRAPHS[arch]
    params = model_params(model)

    def a_of(path: str) -> float:
        return max(ranges[path], _EPS) / 127.0

    def out_channels(module: str, layer: str) -> int:
        return int(params[module][layer]["conv"]["kernel"].shape[-1])

    qlayers: Dict[str, dict] = {}
    meta: Dict[str, dict] = {}
    part_scales: Dict[str, tuple] = {}

    def add(module: str, layer: str, groups, relu: bool,
            a_out: Optional[float]) -> None:
        spec = _layer_spec(params, module, layer, groups, relu, a_out)
        path = f"{module}/{layer}"
        meta[path] = spec.pop("meta")
        qlayers[path] = spec

    # stem: the input layer is the near-lossless image quant X = u8 - 128;
    # every later tensor is symmetric (z = 0)
    a_in, z_in = input_quant
    for name, _pool in graph.stem:
        a_out = a_of(f"stem/{name}")
        n_in = int(params["stem"][name]["conv"]["kernel"].shape[2])
        add("stem", name, [(a_in, z_in, n_in)], relu=True, a_out=a_out)
        a_in, z_in = a_out, 0.0
    a_feat = a_in  # symmetric scale of the stem feature map
    feat_ch = out_channels("stem", graph.stem[-1][0])

    num_stages = graph.num_stages
    for stage in range(1, num_stages + 1):
        modules = graph.stage_modules(stage)
        if stage == 1:
            in_groups = [(a_feat, 0.0, feat_ch)]
        else:
            # concat(head_outputs..., feature): heads quantize symmetric at
            # their own scales; the feature arrives already quantized
            prev = graph.stage_modules(stage - 1)
            head_as = tuple(a_of(p) for p in prev)
            part_scales[f"stage{stage}"] = tuple(
                np.float32(a) for a in head_as)
            in_groups = [
                (a, 0.0, out_channels(p, graph.branch_layers(stage - 1,
                                                             p)[-1]))
                for a, p in zip(head_as, prev)
            ] + [(a_feat, 0.0, feat_ch)]
        for module in modules:
            layers = graph.branch_layers(stage, module)
            groups = in_groups
            for layer in layers[:-1]:
                a_out = a_of(f"{module}/{layer}")
                add(module, layer, groups, relu=True, a_out=a_out)
                groups = [(a_out, 0.0, out_channels(module, layer))]
            add(module, layers[-1], groups, relu=False, a_out=None)

    qtree = {"qlayers": qlayers, "part_scales": part_scales}
    static = QuantStatic(arch=arch, layer_meta=meta,
                         stem=tuple(graph.stem),
                         two_branch=graph.two_branch,
                         num_stages=num_stages,
                         input_a=float(input_quant[0]),
                         input_z=float(input_quant[1]))
    return qtree, static


def qtree_to_device(qtree, static: QuantStatic, device,
                    pack_kernels: bool = False):
    """The numpy tree as tensors on ``device``.  ``pack_kernels`` adds
    each non-head layer's kernels in its CUDA kernel's layout: the 7x7
    layers' under ``"conv7_packed"``, the others' under
    ``"conv_s8_packed"``.  Head scales become 1-element tensors, so the
    division in ``_quant_sym`` is a true division on every device."""
    device = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    qlayers = {}
    for path, spec in qtree["qlayers"].items():
        kernels = tuple(t(k) for k in spec["kernel_q"])
        out = {"kernel_q": kernels,
               "mult": tuple(t(m) for m in spec["mult"]),
               "bias_eff": t(spec["bias_eff"])}
        meta = static.layer_meta[path]
        if pack_kernels and not meta["f32_out"]:
            if meta["ksize"] == 7:
                out["conv7_packed"] = tuple(pack_conv7_weights(k)
                                            for k in kernels)
            else:
                (kernel,) = kernels
                out["conv_s8_packed"] = pack_conv_s8_weights(kernel)
        qlayers[path] = out
    part_scales = {
        stage: tuple(t(np.asarray([a], np.float32)) for a in scales)
        for stage, scales in qtree["part_scales"].items()}
    return {"qlayers": qlayers, "part_scales": part_scales}


# ---------------------------------------------------------------------------
# Quantized forward (mirrors the torch models' wiring)
# ---------------------------------------------------------------------------

CONV7_IMPLS = ("kernel", "im2col")


def resolve_conv7_impl(conv7_impl: Optional[str], device) -> str:
    """A detector's ``quantize(conv7_impl=...)`` checked against its
    device: None gives ``"kernel"`` on CUDA and ``"im2col"`` on the CPU;
    ``"kernel"`` asks for CUDA; ``"xla"`` has no counterpart here."""
    device = torch.device(device)
    if conv7_impl is None:
        conv7_impl = "kernel" if device.type == "cuda" else "im2col"
    if conv7_impl == "xla":
        raise ValueError(
            "conv7_impl='xla' has no counterpart in the port: PyTorch "
            "has no int8 convolution; use 'kernel' or 'im2col'")
    if conv7_impl not in CONV7_IMPLS:
        raise ValueError(f"unknown conv7_impl {conv7_impl!r}")
    if conv7_impl == "kernel" and device.type != "cuda":
        raise ValueError("conv7_impl='kernel' launches a CUDA kernel; "
                         f"this detector runs on {device}")
    return conv7_impl


def _qconv(parts, spec, meta, conv7_impl: str = "im2col"):
    """One quantized conv layer: a tuple of int8 NHWC input groups (the
    refine-stage concat members; a 1-tuple elsewhere) -> int8 (or float32
    head) out.  Each group runs its own exact int32 accumulation; the
    epilogue combines them with the folded scales and bias in group order.

    ``conv7_impl`` picks the non-head layers' route: ``"kernel"``, the
    fused CUDA kernels, ``conv7_s8`` for the 7x7 layers and ``conv_s8``
    (one input group) for the 1x1 and 3x3 ones (on CPU tensors each runs
    its plain version); ``"im2col"``, im2col + ``torch._int_mm`` + the
    requantize epilogue.  Both are bit-equal.  The heads run as im2col +
    ``torch._int_mm`` + the float32 epilogue on either route."""
    if conv7_impl == "kernel" and not meta["f32_out"]:
        if meta["ksize"] == 7:
            return conv7_s8(parts, spec["kernel_q"], spec["mult"],
                            spec["bias_eff"], relu=meta["relu"],
                            packed=spec.get("conv7_packed"))
        (x,), (kernel,), (mult,) = parts, spec["kernel_q"], spec["mult"]
        return conv_s8(x, kernel, mult, spec["bias_eff"], relu=meta["relu"],
                       packed=spec.get("conv_s8_packed"))
    accs = [im2col_acc_s8(xq, kq)
            for xq, kq in zip(parts, spec["kernel_q"])]
    if meta["f32_out"]:
        return scaled_sum(accs, spec["mult"], spec["bias_eff"])
    # symmetric store in output-scale units: ReLU outputs occupy [0, 127]
    return requant_epilogue(accs, spec["mult"], spec["bias_eff"],
                            relu=meta["relu"], lo=0.0)


def _max_pool_s8(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pooling of NHWC int8, floor on odd sizes (VALID).
    A view and ``amax``: the card's ``max_pool2d`` takes no int8."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, :2 * h2, :2 * w2].reshape(b, h2, 2, w2, 2, c)
    return x.amax(dim=(2, 4))


def _quant_sym(x_f32: torch.Tensor, a_to: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x_f32 / a_to), -128.0, 127.0).to(
        torch.int8)


def quant_apply(static: QuantStatic, qtree, x: torch.Tensor,
                conv7_impl: str = "im2col"):
    """Quantized forward matching the f32 model's: normalized float32
    (B, H, W, 3) in, stacked per-stage float32 maps (S, B, h, w, C) out,
    ``(pafs, heatmaps)`` for two-branch nets, stacked heatmaps otherwise.
    ``qtree`` is ``qtree_to_device``'s, on ``x``'s device."""
    if conv7_impl not in CONV7_IMPLS:
        raise ValueError(f"unknown conv7_impl {conv7_impl!r}")
    ql = qtree["qlayers"]
    meta = static.layer_meta

    def run(module, layer, parts):
        path = f"{module}/{layer}"
        return _qconv(parts, ql[path], meta[path], conv7_impl)

    # lossless input quantization: X = u8 - 128 (see ``quantize``)
    xq = torch.clamp(torch.round(x / static.input_a - static.input_z),
                     -128.0, 127.0).to(torch.int8)
    for name, pool in static.stem:
        xq = run("stem", name, (xq,))
        if pool:
            xq = _max_pool_s8(xq)
    feat_q = xq  # symmetric; its scale is folded into every consumer

    graph = ARCH_GRAPHS[static.arch]
    heads: List[List[torch.Tensor]] = []  # per stage: [h1(, h2)]
    for stage in range(1, static.num_stages + 1):
        modules = graph.stage_modules(stage)
        if stage == 1:
            parts_in = (feat_q,)
        else:
            scales = qtree["part_scales"][f"stage{stage}"]
            parts_in = tuple(
                _quant_sym(h, a) for h, a in zip(heads[-1], scales)
            ) + (feat_q,)
        outs = []
        for module in modules:
            parts = parts_in
            for layer in graph.branch_layers(stage, module):
                parts = (run(module, layer, parts),)
            outs.append(parts[0])
        heads.append(outs)

    if static.two_branch:
        pafs = torch.stack([h[0] for h in heads])
        hms = torch.stack([h[1] for h in heads])
        return pafs, hms
    return torch.stack([h[0] for h in heads])


def make_quant_apply(static: QuantStatic, qtree, conv7_impl: str = "im2col"):
    """``x -> maps`` closure over the device tree, the signature of the f32
    model's forward."""

    def apply_fn(x):
        return quant_apply(static, qtree, x, conv7_impl)

    return apply_fn


# ---------------------------------------------------------------------------
# Flat (npz-compatible) round trip for serving bundles: the JAX package's
# keys, so one params.npz reads the same in both packages
# ---------------------------------------------------------------------------

_FLAT_SEP = "|"  # layer paths contain "/" (module/layer), never "|"


def qtree_to_flat(qtree) -> Dict[str, np.ndarray]:
    """Quantized tree -> {key: array} for ``np.savez`` (tuple positions
    become integer path components)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + [str(k)])
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, prefix + [str(i)])
        else:
            flat[_FLAT_SEP.join(prefix)] = np.asarray(node)

    walk(qtree, [])
    return flat


def qtree_from_flat(flat: Dict[str, np.ndarray]):
    """Inverse of ``qtree_to_flat``: all-digit dict levels fold back into
    tuples.  ``qtree_to_device(..., pack_kernels=True)`` then rebuilds the
    kernels' packed weights, which are never stored."""
    root: dict = {}
    for key, arr in flat.items():
        parts = key.split(_FLAT_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def fold(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return tuple(fold(node[str(i)]) for i in range(len(node)))
            return {k: fold(v) for k, v in node.items()}
        return node

    return fold(root)


def static_to_dict(static: QuantStatic) -> dict:
    """``QuantStatic`` as JSON-ready data (a bundle's ``meta.json``)."""
    return dataclasses.asdict(static)


def static_from_dict(d: dict) -> QuantStatic:
    """Inverse of ``static_to_dict`` (JSON lists back to tuples)."""
    meta = {path: dict(m, splits=tuple(m["splits"]))
            for path, m in d["layer_meta"].items()}
    return QuantStatic(arch=d["arch"], layer_meta=meta,
                       stem=tuple((str(n), bool(p)) for n, p in d["stem"]),
                       two_branch=bool(d["two_branch"]),
                       num_stages=int(d["num_stages"]),
                       input_a=float(d["input_a"]),
                       input_z=float(d["input_z"]))
