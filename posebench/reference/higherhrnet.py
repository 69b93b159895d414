"""HigherHRNet-W32 in the benchmark's reference: its modules and seeded
weights, the float32 forward with BN unfolded, the test-time path of the
source's ``valid.py`` (resize, flip test, aggregation, projection to the
input, ``HeatmapParser.parse``, ``get_final_preds``), its own Hungarian,
the multiply-add and parameter counts and the heads' calibration.

The modules follow ``configs/higherhrnet_w32.json`` and
``lib/models/pose_higher_hrnet.py`` and carry its ``state_dict`` names
(``conv1``, ``layer1.0.downsample.0``, ``transition1.1.0.0``,
``stage3.2.fuse_layers.2.0.1.0``, ``final_layers.0``,
``deconv_layers.0.0.0``): a BN's ``weight``, ``bias``, ``running_mean``
and ``running_var`` beside each conv that has no bias.

The test-time path, per frame (``TEST:`` of the configuration):

- the frame resized onto the uniformly scaled region of the 64-multiple
  canvas (short side 512), centred, zero-padded; BGR to RGB, ``/255``,
  ImageNet's mean and std;
- one forward of the frame and its mirror; per pass, output 0 resized
  bilinearly (``align_corners=False``) to output 1's size, the heatmaps
  the mean of its first 17 channels and output 1, the tags its last 17;
  the mirrored pass's maps mirrored back and its channels permuted by the
  flip index;
- heatmaps and tags resized bilinearly to the canvas; the heatmaps the
  mean of the two passes, the tags stacked, 2 a joint and pixel;
- NMS (a pixel kept where the 5x5 max pool equals it), the top 30 of each
  joint (equal values in row-major order), ``match_by_tag`` over the
  joint order with this file's Hungarian, the person's score the mean of
  its 17 values, then adjust and refine as ``HeatmapParser``;
- the joints mapped back to the frame by the exact inverse of the resize.

Refine runs in torch on the maps' device, person by person, in the
source's arithmetic; everything else of the parse runs in numpy.  Nothing
here imports the program.  It reuses, unedited, the benchmark's resize
and numerics context.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from posebench.core import flops
from posebench.reference.pipeline import numerics
from posebench.reference.resize import resize_u8_linear


# ----------------------------------------------------------------------
# modules
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Conv:
    """One conv of the net: its ``state_dict`` prefix, the BN after it
    (None for a head, which has a bias), channels, kernel and stride;
    ``transposed`` for the deconv (kernel 4, stride 2, padding 1)."""

    key: str
    bn: Optional[str]
    cin: int
    cout: int
    k: int
    stride: int = 1
    transposed: bool = False


def _basic(prefix: str, c: int) -> List[Conv]:
    return [Conv(f"{prefix}.conv1", f"{prefix}.bn1", c, c, 3),
            Conv(f"{prefix}.conv2", f"{prefix}.bn2", c, c, 3)]


def _bottleneck(prefix: str, cin: int, planes: int, expansion: int,
                downsample: bool) -> List[Conv]:
    out = [Conv(f"{prefix}.conv1", f"{prefix}.bn1", cin, planes, 1),
           Conv(f"{prefix}.conv2", f"{prefix}.bn2", planes, planes, 3),
           Conv(f"{prefix}.conv3", f"{prefix}.bn3", planes,
                planes * expansion, 1)]
    if downsample:
        out.append(Conv(f"{prefix}.downsample.0", f"{prefix}.downsample.1",
                        cin, planes * expansion, 1))
    return out


def _fuse(prefix: str, ch: Sequence[int], outputs: int) -> List[Conv]:
    """A module's fuse units: for output i and input j > i a 1x1 conv
    (then a nearest upsample), for j < i a chain of i - j stride-2 3x3
    convs."""
    out = []
    for i in range(outputs):
        for j in range(len(ch)):
            if j > i:
                out.append(Conv(f"{prefix}.fuse_layers.{i}.{j}.0",
                                f"{prefix}.fuse_layers.{i}.{j}.1",
                                ch[j], ch[i], 1))
            elif j < i:
                for k in range(i - j):
                    last = k == i - j - 1
                    out.append(Conv(f"{prefix}.fuse_layers.{i}.{j}.{k}.0",
                                    f"{prefix}.fuse_layers.{i}.{j}.{k}.1",
                                    ch[j], ch[i] if last else ch[j], 3, 2))
    return out


def _module_outputs(cfg: dict, stage: int, module: int) -> int:
    """Branches a module fuses to: all, but one for the last module of
    the last stage (``multi_scale_output=False``)."""
    s = cfg["stages"][stage]
    last = stage == len(cfg["stages"]) - 1 and module == s["num_modules"] - 1
    return 1 if last else s["num_branches"]


def convs(cfg: dict) -> List[Conv]:
    """Every conv of the net in ``state_dict`` order."""
    stem = cfg["stem_channels"]
    l1 = cfg["layer1"]
    out = [Conv("conv1", "bn1", 3, stem, 3, 2),
           Conv("conv2", "bn2", stem, stem, 3, 2)]
    cin = stem
    for b in range(l1["num_blocks"]):
        out += _bottleneck(f"layer1.{b}", cin, l1["planes"], l1["expansion"],
                           b == 0 and cin != l1["planes"] * l1["expansion"])
        cin = l1["planes"] * l1["expansion"]
    pre = [cin]
    for t, s in enumerate(cfg["stages"]):
        out += _transition(f"transition{t + 1}", pre, s["num_channels"])
        ch = s["num_channels"]
        for m in range(s["num_modules"]):
            prefix = f"{s['name']}.{m}"
            for b in range(s["num_branches"]):
                for k in range(s["num_blocks"][b]):
                    out += _basic(f"{prefix}.branches.{b}.{k}", ch[b])
            outputs = _module_outputs(cfg, t, m)
            if s["num_branches"] > 1:
                out += _fuse(prefix, ch, outputs)
        pre = ch
    j = cfg["num_joints"]
    tags = j if cfg["tag_per_joint"] else 1
    c0 = pre[0]
    d = cfg["deconv"]
    out.append(Conv("final_layers.0", None, c0, j + tags,
                    cfg["final_conv_kernel"]))
    out.append(Conv("final_layers.1", None, d["num_channels"][0], j,
                    cfg["final_conv_kernel"]))
    dc = d["num_channels"][0]
    out.append(Conv("deconv_layers.0.0.0", "deconv_layers.0.0.1",
                    c0 + j + tags, dc, d["kernel_size"][0], 2,
                    transposed=True))
    for b in range(d["num_basic_blocks"]):
        out += _basic(f"deconv_layers.0.{b + 1}.0", dc)
    return out


def _transition(name: str, pre: Sequence[int], cur: Sequence[int]
                ) -> List[Conv]:
    out = []
    for i, c in enumerate(cur):
        if i < len(pre):
            if pre[i] != c:
                out.append(Conv(f"{name}.{i}.0", f"{name}.{i}.1", pre[i], c,
                                3))
        else:
            for k in range(i + 1 - len(pre)):
                cin = pre[-1]
                cout = c if k == i - len(pre) else cin
                out.append(Conv(f"{name}.{i}.{k}.0", f"{name}.{i}.{k}.1",
                                cin, cout, 3, 2))
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """``state_dict`` name -> shape, the BN's statistics included."""
    shapes = {}
    for c in convs(cfg):
        shapes[f"{c.key}.weight"] = ((c.cin, c.cout, c.k, c.k) if c.transposed
                                     else (c.cout, c.cin, c.k, c.k))
        if c.bn is None:
            shapes[f"{c.key}.bias"] = (c.cout,)
        else:
            for f in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{c.bn}.{f}"] = (c.cout,)
    return shapes


def param_count(cfg: dict) -> int:
    """Trainable parameters: conv kernels, the heads' biases, BN's gamma
    and beta (its running statistics are buffers)."""
    return sum(int(np.prod(s)) for k, s in param_shapes(cfg).items()
               if not k.endswith(("running_mean", "running_var")))


def conv_grids(cfg: dict, input_hw) -> List[Tuple[Conv, Tuple[int, int]]]:
    """Each conv with the (h, w) of its output at ``input_hw`` (a multiple
    of 32): the stem at 1/2 and 1/4, branch b at 1/2^(b+2), the heads at
    1/4 and 1/2."""
    h, w = input_hw
    out = []
    for c in convs(cfg):
        if c.key == "conv1":
            s = 2
        elif c.key.startswith("deconv_layers") or c.key == "final_layers.1":
            s = 2
        elif c.key.startswith(("conv2", "layer1", "final_layers.0")):
            s = 4
        else:
            s = 4 * 2 ** _branch_of(c)
        out.append((c, (h // s, w // s)))
    return out


def _branch_of(c: Conv) -> int:
    """The branch whose grid a conv of a transition or stage writes."""
    parts = c.key.split(".")
    if parts[0].startswith("transition"):
        return int(parts[1])
    if parts[2] == "branches":
        return int(parts[3])
    i, j = int(parts[3]), int(parts[4])      # fuse_layers.i.j...
    if j > i:
        return i
    k = int(parts[5])
    return j + k + 1


def forward_macs(cfg: dict, input_hw, batch: int = 1) -> int:
    """Multiply-adds of one forward of ``batch`` images at ``input_hw``:
    every conv (a transposed conv counted per input pixel, its k x k
    taps each)."""
    total = 0
    for c, (h, w) in conv_grids(cfg, input_hw):
        if c.transposed:
            total += (h // 2) * (w // 2) * c.k * c.k * c.cin * c.cout
        else:
            total += h * w * c.k * c.k * c.cin * c.cout
    return batch * total


def forward_ops(cfg: dict, input_hw, batch: int = 1) -> int:
    """Operations of one forward (2 per multiply-add)."""
    return 2 * forward_macs(cfg, input_hw, batch)


def refine_bound_s(pairs: float, groups: float, hw: int) -> float:
    """The least seconds of the port's refine kernel for ``pairs``
    (person, joint) pairs scored in ``groups`` groups of one joint over a
    map of ``hw`` pixels: each group reads its joint's heatmap and two tag
    planes once (12 bytes a pixel), each pair's mean, key and index once
    (20 bytes); 8 operations a pair and pixel (two differences, two
    squares, a sum, a square root, a rounding, the score), at the card's
    published float32 peak outside the tensor cores."""
    n_bytes = 12.0 * hw * groups + 20.0 * pairs
    ops = 8.0 * pairs * hw
    return max(n_bytes / flops.HBM_BYTES_PER_S, ops / flops.F32_OPS_PER_S)


def seeded_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights drawn on ``device`` from ``seed``: one unit normal clamped
    at 2 sigma for every kernel, scaled per conv to He-normal (variance 2
    over its taps a pixel); the heads' biases zero; one uniform draw of
    every BN field over ``cfg["seeded_bn"]``."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    kernels = {k: s for k, s in shapes.items() if _is_kernel(k, shapes)}
    flat = torch.randn(sum(int(np.prod(s)) for s in kernels.values()),
                       generator=gen, device=device).clamp_(-2.0, 2.0)
    bn = {k: s for k, s in shapes.items()
          if k not in kernels and not _is_head_bias(k)}
    flat_bn = torch.rand(sum(s[0] for s in bn.values()), generator=gen,
                         device=device)
    transposed = {f"{c.key}.weight" for c in convs(cfg) if c.transposed}
    params, pos, pos_bn = {}, 0, 0
    for key, shape in shapes.items():
        if key in kernels:
            n = int(np.prod(shape))
            if key in transposed:     # (cin, cout, k, k), stride 2
                fan = shape[0] * shape[2] * shape[3] // 4
            else:
                fan = shape[1] * shape[2] * shape[3]
            std = (2.0 / fan) ** 0.5 / 0.87962566103423978
            params[key] = flat[pos:pos + n].view(shape).mul_(std)
            pos += n
        elif _is_head_bias(key):
            params[key] = torch.zeros(shape, device=device)
        else:
            lo, hi = cfg["seeded_bn"][_BN_FIELD[key.rsplit(".", 1)[1]]]
            params[key] = flat_bn[pos_bn:pos_bn + shape[0]].mul(hi - lo) \
                .add_(lo)
            pos_bn += shape[0]
    return params


_BN_FIELD = {"weight": "gamma", "bias": "beta", "running_mean": "mean",
             "running_var": "var"}


def _is_kernel(key: str, shapes) -> bool:
    return key.endswith(".weight") and len(shapes[key]) == 4


def _is_head_bias(key: str) -> bool:
    return key.startswith("final_layers.") and key.endswith(".bias")


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------

def _folded(p, c: Conv, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conv ``c``'s kernel and bias with its BN folded in, in float64:
    ``w * gamma / sqrt(var + eps)`` per output channel and ``beta - mean *
    gamma / sqrt(var + eps)``, then float32."""
    s = p[f"{c.bn}.weight"].double() / torch.sqrt(
        p[f"{c.bn}.running_var"].double() + eps)
    w = p[f"{c.key}.weight"].double()
    w = w * (s[None, :, None, None] if c.transposed
             else s[:, None, None, None])
    b = p[f"{c.bn}.bias"].double() - p[f"{c.bn}.running_mean"].double() * s
    return w.float(), b.float()


def _conv_bn(p, c: Conv, x: torch.Tensor, eps: float, relu: bool,
             fold: bool) -> torch.Tensor:
    w, b = p[f"{c.key}.weight"], p.get(f"{c.key}.bias")
    if fold and c.bn is not None:
        w, b = _folded(p, c, eps)
    if c.transposed:
        y = F.conv_transpose2d(x, w, b, 2, 1, 0)
    else:
        y = F.conv2d(x, w, b, c.stride, c.k // 2)
    if c.bn is not None and not fold:
        y = F.batch_norm(y, p[f"{c.bn}.running_mean"],
                         p[f"{c.bn}.running_var"], p[f"{c.bn}.weight"],
                         p[f"{c.bn}.bias"], False, 0.0, eps)
    return F.relu(y) if relu else y


def _ops(cfg: dict, params, fold: bool):
    """``cbr(key, x, relu=True)``: conv ``key`` with its BN (and ReLU);
    ``basic(prefix, x)``: a BasicBlock."""
    by_key = {c.key: c for c in convs(cfg)}
    eps = cfg["bn_eps"]

    def cbr(key, t, relu=True):
        return _conv_bn(params, by_key[key], t, eps, relu, fold)

    def basic(prefix, t):
        y = cbr(f"{prefix}.conv2", cbr(f"{prefix}.conv1", t), relu=False)
        return F.relu(y + t)

    return cbr, basic


def module_forward(cfg: dict, params, stage: int, module: int,
                   xs: List[torch.Tensor], fold: bool = True
                   ) -> List[torch.Tensor]:
    """Module ``module`` of stage ``stage`` (0-based: stage2 is 0) on its
    branches' inputs: 4 BasicBlocks a branch, then each output i the ReLU
    of ``f_i0(x_0) + f_i1(x_1) + ...`` in that order."""
    cbr, basic = _ops(cfg, params, fold)
    s = cfg["stages"][stage]
    prefix = f"{s['name']}.{module}"
    xs = list(xs)
    for b in range(s["num_branches"]):
        for k in range(s["num_blocks"][b]):
            xs[b] = basic(f"{prefix}.branches.{b}.{k}", xs[b])
    if s["num_branches"] == 1:
        return xs
    fused = []
    for i in range(_module_outputs(cfg, stage, module)):
        y = None
        for j in range(s["num_branches"]):
            f = f"{prefix}.fuse_layers.{i}.{j}"
            if j == i:
                term = xs[j]
            elif j > i:
                term = F.interpolate(cbr(f"{f}.0", xs[j], relu=False),
                                     scale_factor=2 ** (j - i),
                                     mode="nearest")
            else:
                term = xs[j]
                for k in range(i - j):
                    term = cbr(f"{f}.{k}.0", term, relu=k < i - j - 1)
            y = term if y is None else y + term
        fused.append(F.relu(y))
    return fused


def forward(cfg: dict, params: Dict[str, torch.Tensor], x: torch.Tensor,
            fold: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, 3, H, W) normalized RGB -> (B, 34, H/4, W/4) and
    (B, 17, H/2, W/2), as ``PoseHigherResolutionNet.forward`` in eval
    mode.  ``fold=False``: each BN after its conv, as published;
    ``fold=True`` (the answers'): each BN folded into its conv, the
    arithmetic of a deployed net.  The decode's choices (NMS equality,
    refine's argmax over rounded tag distances) turn on the maps' last
    bits: a BN applied after its conv moves the maps by a few 1e-6
    relative, which moves about one refined joint in four frames of this
    traffic."""
    cbr, basic = _ops(cfg, params, fold)
    by_key = {c.key: c for c in convs(cfg)}
    x = cbr("conv2", cbr("conv1", x))
    l1 = cfg["layer1"]
    for b in range(l1["num_blocks"]):
        pre = f"layer1.{b}"
        y = cbr(f"{pre}.conv3", cbr(f"{pre}.conv2", cbr(f"{pre}.conv1", x)),
                relu=False)
        res = cbr(f"{pre}.downsample.0", x, relu=False) \
            if f"{pre}.downsample.0" in by_key else x
        x = F.relu(y + res)
    ys = [x]
    for t, s in enumerate(cfg["stages"]):
        xs = []
        for i in range(s["num_branches"]):
            name = f"transition{t + 1}.{i}"
            if i < len(ys):
                xs.append(cbr(f"{name}.0", ys[i]) if f"{name}.0" in by_key
                          else ys[i])
            else:
                y = ys[-1]
                k = 0
                while f"{name}.{k}.0" in by_key:
                    y = cbr(f"{name}.{k}.0", y)
                    k += 1
                xs.append(y)
        for m in range(s["num_modules"]):
            xs = module_forward(cfg, params, t, m, xs, fold)
        ys = xs
    feat = ys[0]
    out0 = cbr("final_layers.0", feat, relu=False)
    y = cbr("deconv_layers.0.0.0", torch.cat([feat, out0], dim=1))
    for b in range(cfg["deconv"]["num_basic_blocks"]):
        y = basic(f"deconv_layers.0.{b + 1}.0", y)
    out1 = cbr("final_layers.1", y, relu=False)
    return out0, out1


# ----------------------------------------------------------------------
# the test-time path
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Geometry:
    """A frame's network input (``in_hw``), the region its resize fills
    (``res_hw``) and that region's top-left corner in the input."""

    frame_hw: Tuple[int, int]
    in_hw: Tuple[int, int]
    res_hw: Tuple[int, int]
    offset: Tuple[int, int]      # (y, x)

    @property
    def scale(self) -> Tuple[float, float]:
        """Frame pixels per input pixel, (x, y)."""
        return (self.frame_hw[1] / self.res_hw[1],
                self.frame_hw[0] / self.res_hw[0])


def geometry(cfg: dict, frame_hw) -> Geometry:
    """``get_multi_scale_size`` at scale 1: the short side to
    ``input_size``, the long side to the next multiple of
    ``size_multiple`` above its scaled length; the resized frame the
    uniformly scaled region, centred."""
    h, w = frame_hw
    m = cfg["size_multiple"]
    base = int((cfg["input_size"] + m - 1) // m * m)
    if w < h:
        in_hw = (int((base / w * h + m - 1) // m * m), base)
        res_hw = (int(math.floor(h * base / w + 0.5)), base)
    else:
        in_hw = (base, int((base / h * w + m - 1) // m * m))
        res_hw = (base, int(math.floor(w * base / h + 0.5)))
    offset = ((in_hw[0] - res_hw[0]) // 2, (in_hw[1] - res_hw[1]) // 2)
    return Geometry((h, w), in_hw, res_hw, offset)


def canvas(cfg: dict, frame: np.ndarray) -> np.ndarray:
    """The network input of a BGR uint8 frame: resized, centred, zeros
    around."""
    g = geometry(cfg, frame.shape[:2])
    out = np.zeros(g.in_hw + (3,), np.uint8)
    oy, ox = g.offset
    out[oy:oy + g.res_hw[0], ox:ox + g.res_hw[1]] = resize_u8_linear(
        frame, (g.res_hw[1], g.res_hw[0]))
    return out


def normalise(cfg: dict, u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) BGR uint8 -> (B, 3, H, W): RGB, ``ToTensor`` then
    ``Normalize``."""
    x = u8[..., [2, 1, 0]].permute(0, 3, 1, 2).float().div(255)
    mean = torch.tensor(cfg["mean"], dtype=torch.float32, device=x.device)
    std = torch.tensor(cfg["std"], dtype=torch.float32, device=x.device)
    return x.sub(mean[:, None, None]).div(std[:, None, None])


def _bilinear(t: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(t, size=tuple(hw), mode="bilinear",
                         align_corners=False)


def aggregate(cfg: dict, out0: torch.Tensor, out1: torch.Tensor, in_hw,
              gains=None):
    """The two passes' outputs (batch 2: the frame, its mirror) -> the
    heatmaps (J, H, W) and tags (J, H, W, 2) at the input size, as
    ``get_multi_stage_outputs`` and ``aggregate_results``.  ``gains``
    (for the calibration): factors of output 0's heatmaps, tags and
    output 1 before anything is summed."""
    j = cfg["num_joints"]
    fi = cfg["flip_index"]
    up = _bilinear(out0, out1.shape[-2:])
    if gains is not None:
        up = torch.cat([up[:, :j] * gains[0], up[:, j:] * gains[1]], dim=1)
        out1 = out1 * gains[2]
    heat, tags = [], []
    for b in (0, 1):
        u, o = up[b:b + 1], out1[b:b + 1]
        if b == 1:
            u, o = torch.flip(u, [3]), torch.flip(o, [3])
            hm = 0 + u[:, :j][:, fi]
            hm = hm + o[:, fi]
            tg = u[:, j:][:, fi]
        else:
            hm = 0 + u[:, :j]
            hm = hm + o
            tg = u[:, j:]
        # contiguous: a one-image channel slice may come out channels-last,
        # whose bilinear kernel rounds otherwise
        heat.append(_bilinear((hm / 2).contiguous(), in_hw))
        tags.append(_bilinear(tg.contiguous(), in_hw))
    det = (heat[0] + heat[1]) / 2.0
    return det[0], torch.stack(tags, dim=4)[0]


def frame_maps(cfg: dict, params, frame: np.ndarray, device,
              tf32: bool = False, gains=None):
    """(heatmaps (J, H, W), tags (J, H, W, 2)) of a frame, on ``device``."""
    g = geometry(cfg, frame.shape[:2])
    x = normalise(cfg, torch.from_numpy(canvas(cfg, frame)).to(device)[None])
    with torch.no_grad(), numerics(tf32=tf32):
        out0, out1 = forward(cfg, params, torch.cat([x, torch.flip(x, [3])]))
        return aggregate(cfg, out0, out1, g.in_hw, gains)


def nms(cfg: dict, det: torch.Tensor) -> torch.Tensor:
    t = cfg["test"]
    maxm = F.max_pool2d(det[None], t["nms_kernel"], 1, t["nms_padding"])[0]
    return det * torch.eq(maxm, det).float()


def candidates(cfg: dict, det: torch.Tensor, tags: torch.Tensor):
    """Per joint, (rows of (x, y, val, tag...) float64, tags float32) of
    the top ``max_num_people`` NMS peaks above the detection threshold,
    by value, equal values in row-major order."""
    t = cfg["test"]
    peaks = nms(cfg, det).cpu().numpy()
    tg = tags.cpu().numpy()
    w = peaks.shape[2]
    out = []
    for j in range(peaks.shape[0]):
        flat = peaks[j].ravel()
        idx = np.flatnonzero(flat.astype(np.float64)
                             > t["detection_threshold"])
        idx = idx[np.lexsort((idx, -flat[idx]))][:t["max_num_people"]]
        ys, xs = idx // w, idx % w
        tj = tg[j, ys, xs]                       # (n, L) float32
        rows = np.concatenate([xs[:, None], ys[:, None],
                               flat[idx][:, None], tj], 1)
        out.append((rows.astype(np.float64), tj))
    return out


# ----------------------------------------------------------------------
# the Hungarian: the first optimal assignment in row order
# ----------------------------------------------------------------------

def _solve(cost: List[List[int]]) -> List[int]:
    """Minimum-cost assignment of a square integer matrix (the classic
    O(n^3) potentials method, rows added one at a time): the column of
    each row."""
    n = len(cost)
    inf = None
    u = [0] * (n + 1)
    v = [0] * (n + 1)
    p = [0] * (n + 1)           # p[col] = row (1-based), 0 free
    way = [0] * (n + 1)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = [inf] * (n + 1)
        used = [False] * (n + 1)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta, j1 = inf, 0
            row = cost[i0 - 1]
            for j in range(1, n + 1):
                if used[j]:
                    continue
                cur = row[j - 1] - u[i0] - v[j]
                if minv[j] is None or cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if delta is None or minv[j] < delta:
                    delta, j1 = minv[j], j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col = [0] * n
    for j in range(1, n + 1):
        if p[j]:
            col[p[j] - 1] = j - 1
    return col


def assign(rounded: np.ndarray, vals: np.ndarray, cols: int) -> List[int]:
    """The column of each row in the first least-cost assignment of the
    source's matrix ``round(d) * 100 - val`` (``rounded`` the rounded tag
    distances, rows x groups; ``vals`` each row's value), padded to
    ``cols`` columns of 1e10: the least total cost, and of those the
    smallest column for row 0, then row 1, ...  Exact: each cost a
    fraction (where the source's float64 sum would round for distances of
    millions), scaled to integers by the common denominator and perturbed
    by its column's base-(cols + 1) digit weighted by the row, below the
    least step of the true cost."""
    rows, grouped = rounded.shape
    fr = [[Fraction(int(rounded[i, j])) * 100 - Fraction(float(vals[i]))
           if j < grouped else Fraction(10**10) for j in range(cols)]
          for i in range(rows)]
    den = max(f.denominator for r in fr for f in r)
    base = cols + 1
    big = base ** rows
    m = [[int(f * den) * big + j * base ** (rows - 1 - i)
          for j, f in enumerate(r)] for i, r in enumerate(fr)]
    m += [[0] * cols for _ in range(cols - rows)]
    return _solve(m)[:rows]


# ----------------------------------------------------------------------
# HeatmapParser
# ----------------------------------------------------------------------

def _mean32(vectors: Sequence[np.ndarray]) -> np.ndarray:
    """A float32 mean: the sum in the given order, over the count."""
    acc = np.zeros_like(vectors[0], dtype=np.float32)
    for v in vectors:
        acc = (acc + v).astype(np.float32)
    return (acc / np.float32(len(vectors))).astype(np.float32)


def match_by_tag(cfg: dict, cands) -> np.ndarray:
    """``match_by_tag``: groups (P, J, 3 + L) float32 in insertion order,
    a row per joint (x, y, val, tags), zeros where absent."""
    t = cfg["test"]
    nj = cfg["num_joints"]
    width = 3 + cands[0][1].shape[1] if cands else 5
    joint_dict: Dict = {}
    tag_dict: Dict = {}
    for i, idx in enumerate(cfg["joint_order"]):
        joints, tags = cands[idx]
        if joints.shape[0] == 0:
            continue
        if i == 0 or len(joint_dict) == 0:
            for tag, joint in zip(tags, joints):
                key = tag[0]
                joint_dict.setdefault(key, np.zeros((nj, width)))[idx] = joint
                tag_dict[key] = [tag]
            continue
        keys = list(joint_dict.keys())[:t["max_num_people"]]
        means = [_mean32(tag_dict[k]) for k in keys]
        diff = joints[:, None, 3:] - np.array(means)[None, :, :]
        normed = np.linalg.norm(diff, ord=2, axis=2)
        saved = np.copy(normed)
        added, grouped = diff.shape[0], diff.shape[1]
        # use_detection_val: round(d) * 100 - val, 1e10 columns past the
        # groups where there are more candidates
        for row, col in enumerate(assign(np.round(normed), joints[:, 2],
                                         max(added, grouped))):
            if (row < added and col < grouped
                    and saved[row][col] < t["tag_threshold"]):
                key = keys[col]
                joint_dict[key][idx] = joints[row]
                tag_dict[key].append(tags[row])
            else:
                key = tags[row][0]
                joint_dict.setdefault(key, np.zeros((nj, width)))[idx] = \
                    joints[row]
                tag_dict[key] = [tags[row]]
    if not joint_dict:
        return np.zeros((0, nj, width), np.float32)
    return np.array([joint_dict[k] for k in joint_dict]).astype(np.float32)


def _quarter(det: np.ndarray, x: int, y: int) -> Tuple[float, float]:
    """The quarter-pixel step of a peak at (x, y) toward its larger
    neighbour in x and in y."""
    h, w = det.shape
    dx = 0.25 if det[y, min(x + 1, w - 1)] > det[y, max(x - 1, 0)] else -0.25
    dy = 0.25 if det[min(y + 1, h - 1), x] > det[max(y - 1, 0), x] else -0.25
    return dx, dy


def adjust(groups: np.ndarray, det: np.ndarray) -> np.ndarray:
    for person in groups:
        for j, joint in enumerate(person):
            if joint[2] > 0:
                x, y = int(joint[0]), int(joint[1])
                dx, dy = _quarter(det[j], x, y)
                person[j, 0] = x + dx + 0.5
                person[j, 1] = y + dy + 0.5
    return groups


def refine(det: torch.Tensor, tags: torch.Tensor, keypoints: np.ndarray,
           det_np: np.ndarray) -> np.ndarray:
    """``HeatmapParser.refine`` of one person: per joint the argmax of
    ``det - round(|tag - mean tag|)`` (the first in row-major order), its
    quarter step and value; filled where the person lacked the joint and
    the value is positive.  ``det`` (J, H, W) and ``tags`` (J, H, W, L) on
    the maps' device, ``det_np`` the heatmaps on the host."""
    seen = []
    for j in range(keypoints.shape[0]):
        if keypoints[j, 2] > 0:
            x, y = keypoints[j][:2].astype(np.int32)
            seen.append(keypoints[j, 3:])      # the tag at (x, y)
    mean = torch.from_numpy(_mean32(seen)).to(det.device)
    d = tags - mean
    tt = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    score = det - torch.round(tt)
    flat = torch.argmax(score.reshape(score.shape[0], -1), dim=1).cpu()
    w = det.shape[2]
    for j in range(keypoints.shape[0]):
        y, x = divmod(int(flat[j]), w)
        val = det_np[j, y, x]
        dx, dy = _quarter(det_np[j], x, y)
        if val > 0 and keypoints[j, 2] == 0:
            keypoints[j, 0] = x + 0.5 + dx
            keypoints[j, 1] = y + 0.5 + dy
            keypoints[j, 2] = val
    return keypoints


def parse(cfg: dict, det: torch.Tensor, tags: torch.Tensor):
    """``HeatmapParser.parse`` with adjust and refine: (persons (P, J,
    3 + L) float32, scores (P,), most candidates of a joint)."""
    cands = candidates(cfg, det, tags)
    groups = match_by_tag(cfg, cands)
    det_np = det.cpu().numpy()
    if cfg["test"]["adjust"]:
        groups = adjust(groups, det_np)
    scores = np.array([g[:, 2].mean() for g in groups], np.float32)
    if cfg["test"]["refine"]:
        for p in range(len(groups)):
            groups[p] = refine(det, tags, groups[p], det_np)
    return groups, scores, max((len(c[0]) for c in cands), default=0)


def final_poses(g: Geometry, groups: np.ndarray) -> np.ndarray:
    """(P, J, 3) (x, y, val) in frame pixels: the inverse of the resize,
    absent joints zero."""
    out = np.zeros(groups.shape[:2] + (3,), np.float32)
    if not len(groups):
        return out
    sx, sy = g.scale
    present = groups[:, :, 2] > 0
    x = (groups[:, :, 0].astype(np.float64) - g.offset[1] + 0.5) * sx - 0.5
    y = (groups[:, :, 1].astype(np.float64) - g.offset[0] + 0.5) * sy - 0.5
    out[:, :, 0] = np.where(present, x, 0.0)
    out[:, :, 1] = np.where(present, y, 0.0)
    out[:, :, 2] = groups[:, :, 2]
    return out


def pose_answers(cfg: dict, params, frames: np.ndarray, device,
                 control: bool = False):
    """Per frame: (poses (P, J, 3), scores (P,), most candidates of a
    joint, frame pixels per input pixel (x, y)).  ``control``: the
    forward with TF32 convolutions and matmuls."""
    out = []
    for frame in frames:
        g = geometry(cfg, frame.shape[:2])
        det, tags = frame_maps(cfg, params, frame, device, tf32=control)
        groups, scores, most = parse(cfg, det, tags)
        out.append((final_poses(g, groups), scores, most, g.scale))
    return out


# ----------------------------------------------------------------------
# calibration of the heads
# ----------------------------------------------------------------------

def _flip_pairs(cfg: dict) -> List[Tuple[int, ...]]:
    """The joints in flip pairs, each once: (j, partner), or (j,) for a
    joint that is its own mirror.  The mirrored pass reads the partner's
    channel, so a pair shares its gains."""
    fi = cfg["flip_index"]
    return [(j,) if fi[j] == j else (j, fi[j])
            for j in range(len(fi)) if j <= fi[j]]


def _count_on_device(cfg: dict, det: torch.Tensor) -> torch.Tensor:
    """Per joint, its NMS peaks over the detection threshold (float64
    comparisons, as ``match_by_tag``'s), on ``det``'s device."""
    over = nms(cfg, det).double() > cfg["test"]["detection_threshold"]
    return over.sum(dim=(1, 2))



def _closest_gains(cfg: dict, counts, base: np.ndarray) -> np.ndarray:
    """Per flip pair, the gain of eighth octaves around ``base`` (1/16 to
    16 times) at which ``counts(gains)``, the candidates a joint and frame
    for per-joint gains, comes closest to ``n_target``: a bisection of
    each pair's step, the count taken as rising with the gain (6 counts in
    all), then the closest step it tried (the smaller gain of equals).
    The pairs' maps do not mix, so every pair steps at once."""
    target = cfg["calibration"]["n_target"]
    pairs = _flip_pairs(cfg)
    lo, hi = np.full(len(pairs), -32), np.full(len(pairs), 32)
    tried = [[] for _ in pairs]

    def gains(steps):
        out = base.copy()
        for pair, k in zip(pairs, steps):
            out[list(pair)] = base[list(pair)] * 2.0 ** (k / 8)
        return out

    while np.any(hi - lo > 1):
        mid = (lo + hi) // 2
        got = counts(gains(mid))
        for i, pair in enumerate(pairs):
            if hi[i] - lo[i] <= 1:
                continue
            tried[i].append((sum(abs(got[j] - target) for j in pair),
                             mid[i]))
            if np.mean([got[j] for j in pair]) > target:
                hi[i] = mid[i]
            else:
                lo[i] = mid[i]
    return gains([min(t)[1] for t in tried])


def _mean_count(cfg: dict, fixed, scaled, gains) -> np.ndarray:
    """Candidates a joint and frame of the maps ``fixed + gains *
    scaled`` (per frame; ``fixed`` None for none), counted on the maps'
    device with one copy to the host."""
    g = torch.as_tensor(gains, dtype=torch.float32,
                        device=scaled[0].device)[:, None, None]
    total = sum(_count_on_device(cfg, g * b if a is None else a + g * b)
                for a, b in zip(fixed, scaled))
    return total.cpu().numpy() / len(scaled)


def _tag_gain(cfg: dict, cands_by_frame) -> float:
    """One gain for every tag channel, at which ``match_by_tag`` groups
    the frames' candidates into ``persons_target`` persons a frame (the
    closest a bisection of the gain's logarithm gives).  Larger tags join
    fewer candidates; a random head gives each joint's candidates nearly
    one tag (they sit on a few ridges of the maps) and each joint
    another."""
    target = cfg["calibration"]["persons_target"]

    def persons(g):
        n = 0
        for cands in cands_by_frame:
            scaled = [(np.concatenate([r[:, :3], r[:, 3:] * g], 1),
                       (t * np.float32(g)).astype(np.float32))
                      for r, t in cands]
            n += len(match_by_tag(cfg, scaled))
        return n / len(cands_by_frame)

    lo, hi = -12.0, 12.0            # log2 of the gain
    best = (abs(persons(1.0) - target), 0.0)
    for _ in range(12):
        mid = (lo + hi) / 2
        got = persons(2.0 ** mid)
        best = min(best, (abs(got - target), mid))
        lo, hi = (lo, mid) if got > target else (mid, hi)
    return 2.0 ** best[1]


def _shift_and_scale(params, key: str, rows: slice, shift, gain) -> None:
    """Head ``key``'s output channels ``rows``: minus ``shift``, then
    times ``gain``."""
    b = params[f"{key}.bias"]
    g = torch.as_tensor(gain, dtype=torch.float32, device=b.device)
    b[rows] -= torch.as_tensor(shift, dtype=torch.float32, device=b.device)
    params[f"{key}.weight"][rows] *= g[:, None, None, None]
    b[rows] *= g


def calibrate(cfg: dict, params, frames: np.ndarray, device) -> None:
    """Shift and scale the heads in place on the maps of the first
    ``calibration.frames`` of ``frames`` (a run's), in order:

    0. the deconv's weights from output 0's tags to zero (the deconv
       reads output 0), so that the tags' scale moves no heatmap;
    1. output 0's heatmap channels to mean 0, then to about ``n_target``
       candidates a joint and frame in the maps they give alone (output 1
       left out);
    2. the outputs recomputed, output 1's channels to mean 0 and output
       0's heatmaps' spread, then to about ``n_target`` candidates a joint
       and frame in the whole maps;
    3. output 0's tag channels, by one gain, to ``persons_target``
       persons a frame from ``match_by_tag`` on the whole maps'
       candidates.

    Means and spreads are over the frames' two passes at the heads' own
    grids; each count the closest a bisection of eighth octaves gives,
    over those frames, so that seeds differ little in their work (the
    persons a frame set the decode's), on maps
    scaled as a whole (the heads are linear); each gain is shared by a
    flip pair.  A random head's channel is an offset with a
    small ripple, its candidates clustered where the canvas's edges and
    padding bend the features; a trained one's is near zero but at its
    peaks, and every joint's tags share one embedding, which the shifts
    give them."""
    j = cfg["num_joints"]
    frames = frames[:cfg["calibration"]["frames"]]
    g = geometry(cfg, frames.shape[1:3])
    batches = []
    for frame in frames:
        x = normalise(cfg, torch.from_numpy(canvas(cfg, frame)).to(
            device)[None])
        batches.append(torch.cat([x, torch.flip(x, [3])]))

    def outputs():
        with torch.no_grad(), numerics():
            return [forward(cfg, params, b) for b in batches]

    def col(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=device)[None, :, None, None]

    def maps(outs, g0, g1, g2):
        with torch.no_grad(), numerics():
            return [aggregate(cfg, o0, o1, g.in_hw,
                              (col(g0), col(g1), col(g2)))
                    for o0, o1 in outs]

    def stats(ts, rows):
        cat = torch.cat([t[:, rows] for t in ts])
        return (cat.mean(dim=(0, 2, 3)),
                cat.std(dim=(0, 2, 3)).clamp_min(1e-12).cpu().numpy())

    ones, zeros = np.ones(j, np.float32), np.zeros(j, np.float32)
    key0, key1 = "final_layers.0", "final_layers.1"
    # the deconv reads output 0: no weight from its tags, so that the tags'
    # scale leaves the heatmaps as they are
    params["deconv_layers.0.0.0.weight"][params[
        "deconv_layers.0.0.0.weight"].shape[0] - j:] = 0
    outs = outputs()
    mean, spread = stats([o0 for o0, _ in outs], slice(0, j))
    _shift_and_scale(params, key0, slice(0, j), mean, ones)
    outs = outputs()
    alone = [d * 2 for d, _ in maps(outs, ones, ones, zeros)]
    hg = _closest_gains(cfg, lambda gg: _mean_count(cfg, [None] * len(alone),
                                                    alone, gg),
                        (0.05 / spread).astype(np.float32))
    del alone
    _shift_and_scale(params, key0, slice(0, j), np.zeros(j), hg)
    outs = outputs()
    mean1, _ = stats([o1 for _, o1 in outs], slice(None))
    _shift_and_scale(params, key1, slice(None), mean1, ones)
    outs = outputs()
    _, spread1 = stats([o1 for _, o1 in outs], slice(None))
    _, spread0 = stats([o0 for o0, _ in outs], slice(0, j))
    base = spread0 / spread1
    for pair in _flip_pairs(cfg):
        base[list(pair)] = np.exp(np.mean(np.log(base[list(pair)])))
    fixed = [d for d, _ in maps(outs, ones, ones, zeros)]
    scaled = [d for d, _ in maps(outs, zeros, ones, ones)]
    g1 = _closest_gains(cfg, lambda gg: _mean_count(cfg, fixed, scaled, gg),
                        base.astype(np.float32))
    del fixed, scaled
    _shift_and_scale(params, key1, slice(None), np.zeros(j), g1)
    outs = outputs()
    cands = [candidates(cfg, d, t) for d, t in maps(outs, ones, ones, ones)]
    _shift_and_scale(params, key0, slice(j, None), np.zeros(j),
                     np.full(j, _tag_gain(cfg, cands), np.float32))
