"""BODY_25 in the benchmark's reference: its layer table, float32 forward,
w8a8 int8 emulation (grouped inputs, PReLU) with its int4 control, the
multiply-add, byte and least-time counts of its int8 layers, and the pose
postprocess over its 25 parts and 26 pairs.

The layer table follows ``configs/body25.json`` (the published prototxt):
the VGG-19 stem with ReLU, ``conv4_3_CPM`` and ``conv4_4_CPM`` with PReLU;
then the stages in forward order, the PAF stages (``_L2``) first, each
five dense blocks of three 3x3 PReLU convs (``_0`` on the block's input,
``_1`` on ``_0``, ``_2`` on ``_1``, the block's output ``[_0, _1, _2]``),
``Mconv6`` (1x1, PReLU) and the head ``Mconv7`` (1x1, no activation).  A
stage's input is ``[feature, earlier heads...]`` in the order the file
lists.  Parameters are named as the program's ``state_dict`` names them
(``stem.conv4_3_CPM.conv.weight``, ``stem.conv4_3_CPM.prelu.weight``).

The int8 scheme is ``reference/quant.py``'s, extended as the program
extends it: a PReLU layer's output is quantized symmetrically at ``a =
max|v| / 127`` into [-127, 127], and its epilogue is ``y < 0 ? y * slope :
y`` on ``y = sum_g acc_g * mult_g + bias``, then rounded; each concat
member is a group at its own scale.  Integer sums run as float64
convolutions, exact.

Nothing here imports the program.  It reuses, unedited, the benchmark's
resizes, numerics context, geometry, blur and peak finder.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from posebench.core import flops
from posebench.reference import pipeline, postprocess
from posebench.reference.resize import resize_align_corners, resize_u8_linear

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Layer:
    module: str              # "stem", "stage0_L2", ...
    name: str                # "conv1_1", "Mconv1_stage0_L2_0", ...
    groups: Tuple[str, ...]  # the tensors it reads, one per concat member
    cin: Tuple[int, ...]     # their channels
    cout: int
    k: int
    act: str                 # "relu", "prelu" or "none" (a head)

    @property
    def key(self) -> str:
        return f"{self.module}.{self.name}"

    @property
    def path(self) -> str:
        return f"{self.module}/{self.name}"


def layer_table(cfg: dict) -> List[Layer]:
    """Every conv in forward order; each layer's output tensor is named by
    its path, a stage's head output by the stage's module."""
    layers, prev, prev_c = [], "image", 3
    for name, cin, cout, k, act in cfg["stem"]:
        layers.append(Layer("stem", name, (prev,), (cin,), cout, k, act))
        prev, prev_c = f"stem/{name}", cout
    feature, feat_c = prev, prev_c
    outs = {m: o for m, _, _, o, _ in cfg["stages"]}
    for module, width, mid, out, inputs in cfg["stages"]:
        t = module[len("stage"):]
        groups = (feature,) + tuple(inputs)
        cin = (feat_c,) + tuple(outs[p] for p in inputs)
        for i in range(1, cfg["dense_blocks"] + 1):
            block = []
            for j in range(3):
                name = f"Mconv{i}_stage{t}_{j}"
                src = (groups, cin) if j == 0 else ((block[-1],), (width,))
                layers.append(Layer(module, name, *src, width, 3, "prelu"))
                block.append(f"{module}/{name}")
            groups, cin = tuple(block), (width,) * 3
        layers.append(Layer(module, f"Mconv6_stage{t}", groups, cin, mid, 1,
                            "prelu"))
        layers.append(Layer(module, f"Mconv7_stage{t}",
                            (f"{module}/Mconv6_stage{t}",), (mid,), out, 1,
                            "none"))
    return layers


def layer_grids(cfg: dict, input_hw) -> List[Tuple[Layer, Tuple[int, int]]]:
    """Each layer with the (H, W) it runs at (pools floor odd sizes)."""
    h, w = input_hw
    pools = set(cfg["pool_after"])
    out = []
    for layer in layer_table(cfg):
        out.append((layer, (h, w)))
        if layer.module == "stem" and layer.name in pools:
            h, w = h // 2, w // 2
    return out


def forward_macs(cfg: dict, input_hw) -> int:
    """Multiply-adds of one forward at ``input_hw``."""
    return sum(h * w * layer.k * layer.k * sum(layer.cin) * layer.cout
               for layer, (h, w) in layer_grids(cfg, input_hw))


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """``state_dict`` name -> shape: each conv's weight and bias, then a
    PReLU layer's slopes."""
    shapes = {}
    for layer in layer_table(cfg):
        shapes[f"{layer.key}.conv.weight"] = (layer.cout, sum(layer.cin),
                                              layer.k, layer.k)
        shapes[f"{layer.key}.conv.bias"] = (layer.cout,)
        if layer.act == "prelu":
            shapes[f"{layer.key}.prelu.weight"] = (layer.cout,)
    return shapes


def param_count(cfg: dict) -> Tuple[int, int]:
    """(conv parameters, PReLU slopes)."""
    conv = slopes = 0
    for key, shape in param_shapes(cfg).items():
        n = int(np.prod(shape))
        if key.endswith(".prelu.weight"):
            slopes += n
        else:
            conv += n
    return conv, slopes


def seeded_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights drawn on ``device`` from ``seed``: one unit normal clamped
    at 2 sigma for every kernel, scaled per layer to lecun-normal (as
    ``nets.seeded_params``), zero biases, then one uniform draw of every
    slope over ``cfg["prelu_slopes"]``."""
    shapes = param_shapes(cfg)
    weights = [s for k, s in shapes.items() if k.endswith(".conv.weight")]
    slopes = [s for k, s in shapes.items() if k.endswith(".prelu.weight")]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(int(np.prod(s)) for s in weights), generator=gen,
                       device=device).clamp_(-2.0, 2.0)
    lo, hi = cfg["prelu_slopes"]
    flat_s = torch.rand(sum(s[0] for s in slopes), generator=gen,
                        device=device).mul_(hi - lo).add_(lo)
    params, pos, pos_s = {}, 0, 0
    for key, shape in shapes.items():
        if key.endswith(".conv.bias"):
            params[key] = torch.zeros(shape, device=device)
        elif key.endswith(".prelu.weight"):
            params[key] = flat_s[pos_s:pos_s + shape[0]]
            pos_s += shape[0]
        else:
            n = int(np.prod(shape))
            std = (1.0 / int(np.prod(shape[1:]))) ** 0.5 / 0.87962566103423978
            params[key] = flat[pos:pos + n].view(shape).mul_(std)
            pos += n
    return params


def head_key(cfg: dict, module: str) -> str:
    """The ``state_dict`` prefix of a stage's output conv."""
    return f"{module}.Mconv7_stage{module[len('stage'):]}.conv"


# ---------------------------------------------------------------------------
# float32 forward
# ---------------------------------------------------------------------------


def _prelu(y: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    return torch.where(y < 0, y * slope[:, None, None], y)


def forward(cfg: dict, params, x: torch.Tensor, hook=None):
    """x: (B, H, W, 3) normalized float input -> (last PAF, last heatmap),
    NCHW float32.  ``hook(path, tensor)`` sees every layer's output (after
    its activation) and every stage's head under the stage's module."""
    pools = set(cfg["pool_after"])
    t = {"image": x.permute(0, 3, 1, 2).contiguous()}
    for layer in layer_table(cfg):
        inp = torch.cat([t[g] for g in layer.groups], 1)
        y = F.conv2d(inp, params[f"{layer.key}.conv.weight"],
                     params[f"{layer.key}.conv.bias"], padding=layer.k // 2)
        if layer.act == "relu":
            y = F.relu(y)
        elif layer.act == "prelu":
            y = _prelu(y, params[f"{layer.key}.prelu.weight"])
        if layer.module == "stem" and layer.name in pools:
            if hook is not None:
                hook(layer.path, y)
            y = F.max_pool2d(y, 2, 2)
            t[layer.path] = y
        else:
            t[layer.path] = y
            if hook is not None:
                hook(layer.path, y)
        if layer.act == "none":
            t[layer.module] = y
            if hook is not None:
                hook(layer.module, y)
    return t[cfg["paf_output"]], t[cfg["heatmap_output"]]


# ---------------------------------------------------------------------------
# w8a8 int8 emulation and its int4 control
# ---------------------------------------------------------------------------


def calibration_ranges(cfg: dict, params, frames_norm) -> Dict[str, float]:
    """``path -> max|value|`` over the float32 forward of each normalized
    (H, W, 3) frame, one at a time."""
    ranges: Dict[str, float] = {}
    with torch.no_grad():
        for frame in frames_norm:
            maxes = {}
            forward(cfg, params, frame[None],
                    hook=lambda path, y: maxes.__setitem__(
                        path, y.abs().amax()))
            paths = list(maxes)
            values = torch.stack([maxes[p] for p in paths]).cpu().tolist()
            for path, m in zip(paths, values):
                ranges[path] = max(ranges.get(path, 0.0), float(m))
    return ranges


def _quantize_kernel(kernel: np.ndarray, qmax: int):
    ws = np.maximum(np.abs(kernel).reshape(-1, kernel.shape[-1]).max(axis=0),
                    _EPS) / float(qmax)
    kq = np.clip(np.round(kernel / ws), -qmax, qmax).astype(np.int8)
    return kq, ws.astype(np.float32)


def quantize(cfg: dict, params, ranges: Dict[str, float], bits: int = 8):
    """Float weights + ranges -> ``{path: (kernels, mults, bias, slope)}``
    and each tensor's scale, on the host.  A stage's head is quantized at
    the stage module's range where a later stage reads it."""
    qmax = {8: 127, 4: 7}[bits]
    host = {k: v.detach().float().cpu().numpy() for k, v in params.items()}

    def a_of(path):
        return max(ranges[path], _EPS) / 127.0

    scale = cfg["input_scale"]
    a = {"image": (1.0 / scale, 0.5 if scale == 255.0 else 0.0)}
    layers = {}
    for layer in layer_table(cfg):
        kernel = host[f"{layer.key}.conv.weight"].transpose(2, 3, 1, 0)
        bias = host[f"{layer.key}.conv.bias"]
        a_out = None if layer.act == "none" else a_of(layer.path)
        kqs, mults = [], []
        bias_eff = (bias if a_out is None else bias / a_out).astype(
            np.float64)
        start = 0
        for g, n in zip(layer.groups, layer.cin):
            a_in, z_in = a[g] if g in a else (a_of(g), 0.0)
            kq, ws = _quantize_kernel(kernel[:, :, start:start + n, :], qmax)
            start += n
            s_o = kq.astype(np.int64).sum(axis=(0, 1, 2)).astype(np.float64)
            mult = a_in * ws if a_out is None else a_in * ws / a_out
            bias_eff = bias_eff + z_in * s_o * mult
            kqs.append(kq)
            mults.append(mult.astype(np.float32))
        slope = host.get(f"{layer.key}.prelu.weight")
        layers[layer.path] = (kqs, mults, bias_eff.astype(np.float32), slope)
        if a_out is not None:
            a[layer.path] = (a_out, 0.0)
    return layers


def to_device(layers, device):
    """The quantized layers as float64 OIHW kernels (one per group) and
    float32 mults, bias and slopes on ``device``."""
    out = {}
    for path, (kqs, mults, bias, slope) in layers.items():
        out[path] = (
            [torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
             .to(device, torch.float64) for k in kqs],
            [torch.from_numpy(m).to(device) for m in mults],
            torch.from_numpy(bias).to(device),
            None if slope is None else torch.from_numpy(slope).to(device))
    return out


def build(cfg: dict, params, calib_u8: np.ndarray, device, bits: int = 8):
    """Ranges from the float32 forward of the calibration inputs (uint8
    (B, S, S, 3), already resized), then the quantized layers on
    ``device`` and the ranges (the heads' scales)."""
    x = torch.from_numpy(calib_u8).to(device).float() / cfg["input_scale"] \
        - 0.5
    ranges = calibration_ranges(cfg, params, x)
    return to_device(quantize(cfg, params, ranges, bits), device), ranges


def _epilogue(accs, mults, bias, act, slope):
    y = None
    for acc, mult in zip(accs, mults):
        part = acc.float() * mult[:, None, None]
        y = part if y is None else y + part
    y = y + bias[:, None, None]
    if act == "none":
        return y
    if act == "relu":
        return torch.clamp(torch.round(torch.clamp_min(y, 0.0)), 0.0, 127.0)
    y = torch.where(y < 0, y * slope[:, None, None], y)
    return torch.clamp(torch.round(y), -127.0, 127.0)


def int8_forward(cfg: dict, qtree, x_u8: torch.Tensor):
    """(B, H, W, 3) uint8 network inputs on the device -> (last PAF, last
    heatmap), float32 NCHW.  Integer activations are held as float64."""
    layers, ranges = qtree
    scale = cfg["input_scale"]
    z = 0.5 if scale == 255.0 else 0.0
    x = x_u8.float() / scale - 0.5
    xq = torch.clamp(torch.round(x / (1.0 / scale) - z), -128.0, 127.0)
    t = {"image": xq.permute(0, 3, 1, 2).contiguous().double()}
    pools = set(cfg["pool_after"])
    heads = {}
    for layer in layer_table(cfg):
        kernels, mults, bias, slope = layers[layer.path]
        parts = []
        for g in layer.groups:
            if g in t:
                parts.append(t[g])
            else:    # a stage's head, quantized at its module's scale
                a = torch.tensor([max(ranges[g], _EPS) / 127.0],
                                 dtype=torch.float32, device=x_u8.device)
                parts.append(torch.clamp(torch.round(heads[g] / a), -128.0,
                                         127.0).double())
        accs = [F.conv2d(p, k, padding=layer.k // 2)
                for p, k in zip(parts, kernels)]
        y = _epilogue(accs, mults, bias, layer.act, slope)
        if layer.act == "none":
            heads[layer.module] = y
            continue
        y = y.double()
        if layer.module == "stem" and layer.name in pools:
            y = F.max_pool2d(y, 2, 2)
        t[layer.path] = y
    return heads[cfg["paf_output"]], heads[cfg["heatmap_output"]]


# ---------------------------------------------------------------------------
# Work and least time of the int8 layers
# ---------------------------------------------------------------------------


def conv_s8_bound_s(b: int, h: int, w: int, cin: Sequence[int], o: int,
                    k: int, prelu: bool) -> float:
    """A 1x1 or 3x3 int8 layer of ``len(cin)`` groups: every group's
    activations, the int8 weights, the per-group mults, the bias, the
    slopes (PReLU) and the int8 output, each moved once; 2 operations per
    multiply-add."""
    c = sum(cin)
    n_bytes = (b * h * w * c + k * k * c * o + 4 * o * len(cin) + 4 * o
               + (4 * o if prelu else 0) + b * h * w * o)
    return flops._bound_s(n_bytes, 2 * b * h * w * o * k * k * c,
                          flops.INT8_OPS_PER_S)


def int8_layers(cfg: dict, input_hw):
    """(layer, (h, w)) of every int8 layer that is not a head: 108."""
    return [(layer, hw) for layer, hw in layer_grids(cfg, input_hw)
            if layer.act != "none"]


def conv_s8_forward_bound_s(cfg: dict, input_hw, batch: int = 1) -> float:
    """Least seconds of one forward's non-head int8 layers, every one of
    which ``conv_s8`` runs."""
    return sum(conv_s8_bound_s(batch, h, w, layer.cin, layer.cout, layer.k,
                               layer.act == "prelu")
               for layer, (h, w) in int8_layers(cfg, input_hw))


def forward_ops(cfg: dict, input_hw, batch: int = 1) -> int:
    """Operations of one forward (2 per multiply-add)."""
    return 2 * batch * forward_macs(cfg, input_hw)


# ---------------------------------------------------------------------------
# The postprocess over BODY_25's pairs
# ---------------------------------------------------------------------------


def candidate_scores(pafs: torch.Tensor, peaks, img_len: float, p: dict,
                     pairs, n_parts: int):
    """``postprocess.candidate_scores`` over ``pairs``: (score, valid)
    (L, K, K) float32 numpy.  pafs: (2L, H, W) float32 on a device."""
    k = p["max_peaks_per_joint"]
    dev = pafs.device
    h, w = pafs.shape[-2:]
    table = np.zeros((3, n_parts, k), np.float32)
    for j, plist in enumerate(peaks):
        for i, (x, y, _) in enumerate(plist):
            table[:, j, i] = (x, y, 1.0)
    table = torch.from_numpy(table).to(dev)
    ia = torch.tensor([a for a, _ in pairs], device=dev)
    ib = torch.tensor([b for _, b in pairs], device=dev)
    ax, ay, av = (t.index_select(0, ia) for t in table)
    bx, by, bv = (t.index_select(0, ib) for t in table)
    av, bv = av > 0, bv > 0
    rows = pafs.reshape(len(pairs), 2, -1).transpose(-1, -2)
    n_pts = p["n_integ_points"]
    vx = bx[:, None, :] - ax[:, :, None]
    vy = by[:, None, :] - ay[:, :, None]
    norm = torch.sqrt(vx * vx + vy * vy)
    nonzero = norm > 0
    safe_norm = torch.where(nonzero, norm, torch.ones_like(norm))
    ux, uy = vx / safe_norm, vy / safe_norm
    t = torch.linspace(0.0, 1.0, n_pts).to(dev)
    xs = ax[:, :, None, None] + vx[..., None] * t
    ys = ay[:, :, None, None] + vy[..., None] * t
    xi = torch.round(xs).long().clamp(0, w - 1)
    yi = torch.round(ys).long().clamp(0, h - 1)
    flat = (yi * w + xi).reshape(len(pairs), -1)
    got = torch.gather(rows, 1, flat[..., None].expand(-1, -1, 2))
    got = got.reshape(len(pairs), k, k, n_pts, 2)
    inner = got[..., 0] * ux[..., None] + got[..., 1] * uy[..., None]
    integ = inner.mean(dim=-1)
    penalty = torch.clamp(p["limb_length_ratio"] * img_len / safe_norm
                          - p["length_penalty_value"], max=0.0)
    score = integ + penalty
    n_valid = (inner > p["inner_product_thresh"]).sum(dim=-1)
    valid = (nonzero & (n_valid > p["n_integ_points_thresh"])
             & (score > 0.0) & av[:, :, None] & bv[:, None, :])
    return score.cpu().numpy(), valid.cpu().numpy()


def connections(score, valid, peaks, pairs):
    """``postprocess.connections`` over ``pairs``."""
    out = []
    for limb, (ja, jb) in enumerate(pairs):
        n_a, n_b = len(peaks[ja]), len(peaks[jb])
        ia, ib = np.nonzero(valid[limb])
        cands = sorted(zip(ia.tolist(), ib.tolist(),
                           score[limb][ia, ib].tolist()),
                       key=lambda c: c[2], reverse=True)
        conns, used_a, used_b = [], set(), set()
        for a, b, s in cands:
            if len(conns) >= min(n_a, n_b):
                break
            if a not in used_a and b not in used_b:
                conns.append((a, b, np.float32(s)))
                used_a.add(a)
                used_b.add(b)
        out.append(conns)
    return out


def group(conns, peak_scores: np.ndarray, p: dict, pairs, non_spawning,
          n_parts: int):
    """``postprocess.group`` over ``pairs``, ``non_spawning`` and
    ``n_parts`` slots a person."""
    subsets = []
    for limb, limb_conns in enumerate(conns):
        ja, jb = pairs[limb]
        for ind_a, ind_b, conn in limb_conns:
            found = [i for i, s in enumerate(subsets)
                     if s["j"][ja] == ind_a or s["j"][jb] == ind_b]
            if len(found) == 1:
                s = subsets[found[0]]
                if s["j"][jb] != ind_b:
                    s["j"][jb] = ind_b
                    s["count"] += np.float32(1)
                    s["score"] += peak_scores[jb, ind_b] + conn
            elif len(found) == 2:
                s1, s2 = subsets[found[0]], subsets[found[1]]
                if not np.any((s1["j"] >= 0) & (s2["j"] >= 0)):
                    s1["j"] = s1["j"] + s2["j"] + 1
                    s1["score"] += s2["score"] + conn
                    s1["count"] += s2["count"] + conn
                    del subsets[found[1]]
                else:
                    for s in (s1, s2):
                        if s["j"][ja] == -1:
                            s["j"][ja] = ind_a
                            s["count"] += np.float32(1)
                            s["score"] += peak_scores[ja, ind_a] + conn
                        elif s["j"][jb] == -1:
                            s["j"][jb] = ind_b
                            s["count"] += np.float32(1)
                            s["score"] += peak_scores[jb, ind_b] + conn
            elif len(found) == 0 and limb not in non_spawning:
                j = -np.ones(n_parts, np.int64)
                j[ja], j[jb] = ind_a, ind_b
                subsets.append({"j": j, "count": np.float32(2),
                                "score": (peak_scores[ja, ind_a]
                                          + peak_scores[jb, ind_b] + conn)})
    thresh = np.float32(p["subset_score_thresh"])
    return [s for s in subsets
            if s["count"] >= p["n_subset_limbs_thresh"]
            and s["score"] / s["count"] >= thresh]


def poses(cfg: dict, pafs: torch.Tensor, heatmaps: np.ndarray,
          scale: Tuple[float, float]):
    """Maps at postprocess resolution, PAFs (52, H, W) on a device and
    heatmaps (26, H, W) float32 numpy -> (poses (N, 25, 3) of (x, y, 2) in
    original pixels, scores (N,), the most peaks of any part, ``scale``)."""
    p = cfg["inference"]
    pairs = [tuple(x) for x in cfg["pairs"]]
    n_parts = len(cfg["parts"])
    peaks, most = postprocess.find_peaks(heatmaps[:-1], p)
    peak_scores = np.zeros((n_parts, p["max_peaks_per_joint"]), np.float32)
    for j, plist in enumerate(peaks):
        for i, (_, _, s) in enumerate(plist):
            peak_scores[j, i] = s
    score, valid = candidate_scores(pafs, peaks, float(pafs.shape[-1]), p,
                                    pairs, n_parts)
    subsets = group(connections(score, valid, peaks, pairs), peak_scores, p,
                    pairs, tuple(cfg["non_spawning_pairs"]), n_parts)
    out = []
    for s in subsets:
        pose = np.zeros((n_parts, 3), np.float64)
        for j in range(n_parts):
            if s["j"][j] >= 0:
                x, y, _ = peaks[j][s["j"][j]]
                pose[j] = (x * scale[0], y * scale[1], 2)
        out.append(pose)
    pose_arr = (np.stack(out) if out
                else np.zeros((0, n_parts, 3), np.float64))
    return (pose_arr, np.asarray([s["score"] for s in subsets], np.float32),
            most, scale)


# ---------------------------------------------------------------------------
# Whole paths
# ---------------------------------------------------------------------------


def int8_tree(cfg: dict, params, calib_u8: Sequence[np.ndarray], device,
              control: bool = False):
    """The w8a8 layers from calibration inputs of any size, each resized
    to ``img_size`` square (int4 weights for the control)."""
    s = cfg["img_size"]
    calib = np.stack([resize_u8_linear(np.asarray(c), (s, s))
                      for c in calib_u8])
    with pipeline.numerics():
        return build(cfg, params, calib, device, 4 if control else 8)


def _last_maps(cfg, params, x_u8, qtree, control: bool):
    with torch.no_grad(), pipeline.numerics(tf32=control and qtree is None):
        if qtree is None:
            outs = forward(cfg, params, x_u8.float() / cfg["input_scale"]
                           - 0.5)
        else:
            outs = int8_forward(cfg, qtree, x_u8)
    return [o.permute(0, 2, 3, 1) for o in outs]


def _frame_maps(cfg, params, frame, device, qtree=None, control=False):
    (in_h, in_w), map_hw = pipeline.pose_geometry(cfg, frame.shape[:2])
    x = torch.from_numpy(resize_u8_linear(frame, (in_w, in_h))
                         ).to(device)[None]
    paf, hm = _last_maps(cfg, params, x, qtree, control)
    with pipeline.numerics():
        paf = resize_align_corners(paf, map_hw)
        hm = resize_align_corners(hm, map_hw)
    return paf[0].permute(2, 0, 1), hm[0].permute(2, 0, 1), map_hw


def pose_maps(cfg: dict, params, frame: np.ndarray, device):
    """The float32 maps the postprocess of ``frame`` reads, channel-first
    numpy (PAFs, heatmaps): what the calibration scales."""
    paf, hm, _ = _frame_maps(cfg, params, frame, device)
    return paf.cpu().numpy(), hm.cpu().numpy()


def pose_answers(cfg: dict, params, frames: np.ndarray, device,
                 qtree=None, control: bool = False):
    """Per frame: (poses (N, 25, 3), scores (N,), most peaks of a part,
    original pixels per map pixel).  ``qtree``: ``int8_tree``'s layers for
    the int8 path, else float32; ``control``: TF32 (float32) or int4
    weights (int8)."""
    out = []
    for frame in frames:
        paf, hm, map_hw = _frame_maps(cfg, params, frame, device, qtree,
                                      control)
        scale = (frame.shape[1] / map_hw[1], frame.shape[0] / map_hw[0])
        out.append(poses(cfg, paf, hm.cpu().numpy(), scale))
    return out
