"""HigherHRNetW32: the bottom-up HigherHRNet-W32 pose net (Cheng, Xiao,
Wang, Shi, Huang, Zhang, "HigherHRNet: Scale-Aware Representation Learning
for Bottom-Up Human Pose Estimation", CVPR 2020; the layers of
``lib/models/pose_higher_hrnet.py`` under
``experiments/coco/higher_hrnet/w32_512_adam_lr1e-3.yaml``).

- Stem: two 3x3 stride-2 convs (3 -> 64 -> 64) with BN and ReLU, then
  ``layer1``: 4 Bottlenecks of 64 planes (256 channels), at 1/4.
- Stages 2, 3 and 4: 1, 4 and 3 modules over 2, 3 and 4 branches of 32,
  64, 128 and 256 channels at 1/4 to 1/32.  A module runs 4 BasicBlocks
  on each branch, then fuses: output i is ``ReLU(sum_j f_ij(x_j))``,
  ``f_ij`` the identity (j = i), a 1x1 conv and a nearest upsample
  (j > i), or i - j stride-2 3x3 convs (j < i).  A transition adds the
  next branch by a stride-2 3x3 conv of the lowest resolution.  The last
  module fuses to branch 0 only.
- Head: ``final_layers.0`` (1x1, 32 -> 17 heatmaps and 17 tags) at 1/4;
  ``deconv_layers.0``: the features and that output concatenated (66
  channels), a 4x4 stride-2 transposed conv to 32 with BN and ReLU and 4
  BasicBlocks, at 1/2; ``final_layers.1`` (1x1, 32 -> 17 heatmaps).

303 convs, 28.65 M parameters.  Modules carry the source's names
(``layer1.0.downsample.0``, ``transition2.2.0.0``,
``stage3.2.fuse_layers.2.0.1.0``, ``deconv_layers.0.0.1``), BN's running
statistics as buffers, so its ``state_dict`` maps one to one.  Each BN is
folded into the conv before it (in float64, then float32) when the model
is built or a ``state_dict`` is loaded, never per forward; the forward
runs the folded convs.  It opens the spans ``hr.stem``, ``hr.stages`` and
``hr.head``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpupose_torch.topology import COCO17
from tpupose_torch.utils.profiling import annotate

STEM_CHANNELS = 64
LAYER1 = (64, 4, 4)                       # planes, blocks, expansion
# (name, modules, branch widths); 4 BasicBlocks a branch in every module
STAGES = (("stage2", 1, (32, 64)), ("stage3", 4, (32, 64, 128)),
          ("stage4", 3, (32, 64, 128, 256)))
BLOCKS = 4
NUM_JOINTS = COCO17.num_joints            # 17 heatmaps, 17 tags
DECONV_CHANNELS = 32
DECONV_BLOCKS = 4
BN_EPS = 1e-5
SPANS = ("hr.stem", "hr.stages", "hr.head")


class BatchNorm(nn.Module):
    """An inference BN: ``weight``, ``bias`` and the running statistics
    (``running_mean``, ``running_var``) as ``nn.BatchNorm2d`` names them;
    it never runs, its conv folds it."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=bias)


def fold(conv: nn.Module, bn: BatchNorm) -> None:
    """Store ``conv`` followed by ``bn`` as one conv with a bias
    (``folded_weight``, ``folded_bias``, buffers left out of the
    ``state_dict``, updated in place once they exist): ``w * g / sqrt(var
    + eps)`` and ``beta - mean * g / sqrt(var + eps)``, computed in
    float64."""
    scale = bn.weight.double() / torch.sqrt(bn.running_var.double() + BN_EPS)
    w = conv.weight.double()
    if isinstance(conv, nn.ConvTranspose2d):      # (in, out, k, k)
        w = w * scale[None, :, None, None]
    else:
        w = w * scale[:, None, None, None]
    b = bn.bias.double() - bn.running_mean.double() * scale
    dtype = conv.weight.dtype
    for name, t in (("folded_weight", w), ("folded_bias", b)):
        old = getattr(conv, name, None)
        if old is not None and old.shape == t.shape:
            old.copy_(t.to(dtype))             # in place
        else:
            conv.register_buffer(name, t.to(dtype).detach(),
                                 persistent=False)


def run(conv: nn.Module, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """A folded conv (a BN after it) or a head (its own bias)."""
    if isinstance(conv, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, conv.folded_weight, conv.folded_bias,
                               conv.stride, conv.padding)
    elif hasattr(conv, "folded_weight"):
        y = F.conv2d(x, conv.folded_weight, conv.folded_bias, conv.stride,
                     conv.padding)
    else:
        y = conv(x)
    return F.relu_(y) if relu else y


class BasicBlock(nn.Module):
    """conv3 -> BN -> ReLU -> conv3 -> BN, plus the input, then ReLU."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(c, c, 3), BatchNorm(c)
        self.conv2, self.bn2 = _conv(c, c, 3), BatchNorm(c)

    def pairs(self):
        return [(self.conv1, self.bn1), (self.conv2, self.bn2)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = run(self.conv2, run(self.conv1, x, True), False)
        return F.relu_(y.add_(x))


class Bottleneck(nn.Module):
    """conv1 -> BN -> ReLU -> conv3 -> BN -> ReLU -> conv1 (x4) -> BN,
    plus the input (through ``downsample``, a 1x1 conv and BN, where the
    width changes), then ReLU."""

    def __init__(self, cin: int, planes: int, expansion: int):
        super().__init__()
        cout = planes * expansion
        self.conv1, self.bn1 = _conv(cin, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), BatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, cout, 1), BatchNorm(cout)
        self.downsample = (nn.Sequential(_conv(cin, cout, 1), BatchNorm(cout))
                           if cin != cout else None)

    def pairs(self):
        return [(self.conv1, self.bn1), (self.conv2, self.bn2),
                (self.conv3, self.bn3)]    # downsample: a (conv, BN) pair

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = run(self.conv3, run(self.conv2, run(self.conv1, x, True), True),
                False)
        res = x if self.downsample is None else run(self.downsample[0], x,
                                                    False)
        return F.relu_(y.add_(res))


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1) -> nn.Sequential:
    """A conv and its BN, as ``Sequential`` entries 0 and 1 (a ReLU, where
    the source has one as entry 2, holds no weights and is left out)."""
    return nn.Sequential(_conv(cin, cout, k, stride), BatchNorm(cout))


class HighResolutionModule(nn.Module):
    """4 BasicBlocks a branch, then the fuse units (``fuse_layers[i][j]``:
    None on the diagonal)."""

    def __init__(self, widths: Sequence[int], outputs: int):
        super().__init__()
        self.widths = tuple(widths)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c) for _ in range(BLOCKS)])
            for c in widths)
        fuse = []
        for i in range(outputs if len(widths) > 1 else 0):
            row = []
            for j, cj in enumerate(widths):
                if j > i:
                    row.append(_conv_bn(cj, widths[i], 1))
                elif j < i:
                    row.append(nn.Sequential(*[
                        _conv_bn(cj, widths[i] if k == i - j - 1 else cj, 3,
                                 2) for k in range(i - j)]))
                else:
                    row.append(None)
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if not len(self.fuse_layers):
            return xs
        out = []
        for i, row in enumerate(self.fuse_layers):
            y, owned = None, False      # owned: y may be summed in place
            for j, unit in enumerate(row):
                if j == i:
                    term = xs[j]
                elif j > i:
                    term = F.interpolate(run(unit[0], xs[j], False),
                                         scale_factor=2 ** (j - i),
                                         mode="nearest")
                else:
                    term = xs[j]
                    for k, step in enumerate(unit):
                        term = run(step[0], term, k < i - j - 1)
                if y is None:
                    y, owned = term, j != i
                elif owned:
                    y.add_(term)
                else:
                    y, owned = y + term, True
            out.append(F.relu_(y) if owned else F.relu(y))
        return out


class HigherHRNetW32(nn.Module):
    """HigherHRNet-W32; ``forward`` of normalized RGB (B, 3, H, W), H and W
    multiples of 32, returns output 0 (B, 34, H/4, W/4): 17 heatmaps then
    17 tags, and output 1 (B, 17, H/2, W/2): heatmaps.  Weights and BN
    statistics are drawn from ``seed``; float32 only."""

    topology = COCO17
    decoder = "associative_embedding"

    def __init__(self, seed: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype != torch.float32:
            raise NotImplementedError(
                "higherhrnet_w32 runs in float32 only; a bfloat16 route is "
                "a later item")
        self.dtype = dtype
        s = STEM_CHANNELS
        self.conv1, self.bn1 = _conv(3, s, 3, 2), BatchNorm(s)
        self.conv2, self.bn2 = _conv(s, s, 3, 2), BatchNorm(s)
        planes, blocks, expansion = LAYER1
        self.layer1 = nn.Sequential(*[
            Bottleneck(s if b == 0 else planes * expansion, planes, expansion)
            for b in range(blocks)])
        pre = (planes * expansion,)
        for t, (name, modules, widths) in enumerate(STAGES):
            self.add_module(f"transition{t + 1}", _transition(pre, widths))
            last = t == len(STAGES) - 1
            self.add_module(name, nn.Sequential(*[
                HighResolutionModule(widths, 1 if last and m == modules - 1
                                     else len(widths))
                for m in range(modules)]))
            pre = widths
        j = NUM_JOINTS
        self.final_layers = nn.ModuleList([
            _conv(pre[0], 2 * j, 1, bias=True),
            _conv(DECONV_CHANNELS, j, 1, bias=True)])
        self.deconv_layers = nn.ModuleList([nn.Sequential(
            nn.Sequential(nn.ConvTranspose2d(pre[0] + 2 * j, DECONV_CHANNELS,
                                             4, 2, 1, 0, bias=False),
                          BatchNorm(DECONV_CHANNELS)),
            *[nn.Sequential(BasicBlock(DECONV_CHANNELS))
              for _ in range(DECONV_BLOCKS)])])
        init_weights(self, seed)
        self.register_load_state_dict_post_hook(
            lambda module, incompatible: module.fold())

    def conv_bn_pairs(self) -> List[Tuple[nn.Module, BatchNorm]]:
        """Every conv with the BN that follows it: the blocks' ``convN`` and
        ``bnN``, and every two-entry ``Sequential`` of a conv and a BN."""
        out = [(self.conv1, self.bn1), (self.conv2, self.bn2)]
        for m in self.modules():
            if isinstance(m, (BasicBlock, Bottleneck)):
                out += m.pairs()
            elif (isinstance(m, nn.Sequential) and len(m) == 2
                  and isinstance(m[1], BatchNorm)):
                out.append((m[0], m[1]))
        return out

    def fold(self) -> None:
        """Fold every BN into its conv; after the weights or statistics
        change."""
        with torch.no_grad():
            for conv, bn in self.conv_bn_pairs():
                fold(conv, bn)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 to layer1: (B, 3, H, W) -> (B, 256, H/4, W/4)."""
        x = run(self.conv2, run(self.conv1, x, True), True)
        return self.layer1(x)

    def stages(self, x: torch.Tensor) -> torch.Tensor:
        """The transitions and stages 2-4 -> branch 0, (B, 32, H/4, W/4)."""
        ys = [x]
        for t, (name, _, widths) in enumerate(STAGES):
            trans = getattr(self, f"transition{t + 1}")
            xs = []
            for i, unit in enumerate(trans):
                src = ys[i] if i < len(ys) else ys[-1]
                if unit is None:
                    xs.append(src)
                elif i < len(ys):
                    xs.append(run(unit[0], src, True))
                else:
                    for step in unit:
                        src = run(step[0], src, True)
                    xs.append(src)
            for module in getattr(self, name):
                xs = module(xs)
            ys = xs
        return ys[0]

    def head(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The final layers and the deconv with its blocks -> the two
        outputs."""
        out0 = self.final_layers[0](feat)
        deconv = self.deconv_layers[0]
        y = run(deconv[0][0], torch.cat([feat, out0], dim=1), True)
        for block in deconv[1:]:
            y = block(y)
        return out0, self.final_layers[1](y)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with annotate(SPANS[0]):
            x = self.stem(x)
        with annotate(SPANS[1]):
            x = self.stages(x)
        with annotate(SPANS[2]):
            return self.head(x)


def _transition(pre: Sequence[int], cur: Sequence[int]) -> nn.ModuleList:
    """``_make_transition_layer``: a conv and BN where a kept branch's
    width changes (else None), a chain of stride-2 convs from the lowest
    branch for each new one."""
    out = []
    for i, c in enumerate(cur):
        if i < len(pre):
            out.append(_conv_bn(pre[i], c, 3) if pre[i] != c else None)
        else:
            out.append(nn.Sequential(*[
                _conv_bn(pre[-1], c if k == i - len(pre) else pre[-1], 3, 2)
                for k in range(i + 1 - len(pre))]))
    return nn.ModuleList(out)


def init_weights(model: HigherHRNetW32, seed: int) -> None:
    """Draw from ``seed`` (one ``torch.Generator``, module order): conv
    kernels He-normal truncated at 2 sigma (a transposed conv's fan the
    input taps that reach an output pixel), the heads' biases zero, each
    BN's gamma in [0.4, 0.8], beta and running mean in [-0.1, 0.1] and
    running var in [0.5, 1.5]; then fold."""
    gen = torch.Generator().manual_seed(int(seed) % 2**63)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                if isinstance(m, nn.ConvTranspose2d):
                    fan = w.shape[0] * w.shape[2] * w.shape[3] // 4
                else:
                    fan = w.shape[1] * w.shape[2] * w.shape[3]
                std = (2.0 / fan) ** 0.5 / 0.87962566103423978
                w.copy_(torch.randn(w.shape, generator=gen).clamp_(-2, 2)
                        * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                n = m.weight.shape[0]
                for t, (lo, hi) in ((m.weight, (0.4, 0.8)),
                                    (m.bias, (-0.1, 0.1)),
                                    (m.running_mean, (-0.1, 0.1)),
                                    (m.running_var, (0.5, 1.5))):
                    t.copy_(torch.rand(n, generator=gen) * (hi - lo) + lo)
    model.fold()
