"""Shared Convolutional-Pose-Machine building blocks (port of
``tpupose/models/cpm.py``).

Activations are NCHW inside the modules (cuDNN's layout); the public model
boundaries (``CocoPoseNet``, ``SingleBranchCPM``) convert to and from the JAX package's
channels-last layout.  Submodule names mirror the Chainer layer names
(``conv1_1`` ... ``Mconv7_stage6_L2``), so a state-dict key reads
``stem.conv1_1.conv.weight`` where the Flax tree has
``params/stem/conv1_1/conv/kernel``.

The nets take a compute ``dtype`` (float32, or bfloat16 over float32
parameters), as the Flax ones do, by explicit casts rather than
``torch.autocast``: the model casts its input to ``dtype``, each conv runs
in the dtype of its input with its weight and bias cast to it (Flax casts
input, kernel and bias), and the ReLUs, pools and concatenations that
follow stay in that dtype; ``stack_stages`` returns float32.  At float32
the casts are no-ops and the forward is the plain ``nn.Conv2d`` one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class ConvReLU(nn.Module):
    """kxk conv (symmetric ``k // 2`` padding) + optional ReLU."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel,
                              padding=kernel // 2)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv
        if x.dtype == conv.weight.dtype:
            x = conv(x)
        else:  # a compute dtype below the float32 parameters
            x = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                         padding=conv.padding)
        return F.relu(x) if self.relu else x


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pooling, floor on odd sizes like Flax VALID."""
    return F.max_pool2d(x, 2, 2)


def _chain(module: nn.Module, specs) -> None:
    """Register ``(name, in, out, k[, relu])`` ConvReLU layers in order."""
    for name, cin, cout, k, *relu in specs:
        module.add_module(name, ConvReLU(cin, cout, k, *relu))


class _Stem(nn.Module):
    """A VGG stem: its ConvReLU layers in order, a 2x2 max pool after
    conv1_2, conv2_2 and conv3_4 (stride 8)."""

    _POOL_AFTER = ("conv1_2", "conv2_2", "conv3_4")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name, layer in self.named_children():
            x = layer(x)
            if name in self._POOL_AFTER:
                x = max_pool_2x2(x)
        return x


class VGG19Stem(_Stem):
    """VGG-19 through conv4_2 plus the two CPM adapter convs: 3 -> 128
    channels at stride 8."""

    def __init__(self):
        super().__init__()
        _chain(self, [
            ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3),
            ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3),
            ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
            ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3),
            ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
            ("conv4_3_CPM", 512, 256, 3), ("conv4_4_CPM", 256, 128, 3),
        ])


class VGGFaceStem(_Stem):
    """The deeper VGG stem of FaceNet and HandNet through conv5_3_CPM: 3 ->
    128 channels at stride 8."""

    def __init__(self):
        super().__init__()
        _chain(self, [
            ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3),
            ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3),
            ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
            ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3),
            ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
            ("conv4_3", 512, 512, 3), ("conv4_4", 512, 512, 3),
            ("conv5_1", 512, 512, 3), ("conv5_2", 512, 512, 3),
            ("conv5_3_CPM", 512, 128, 3),
        ])


class Stage1Branch(nn.Sequential):
    """Stage-1 branch: 3x(3x3) + 1x1x512 + 1x1 out; ``suffix`` is
    ``"_L1"`` (PAF) or ``"_L2"`` (heatmap)."""

    def __init__(self, in_features: int, out_features: int, suffix: str):
        super().__init__()
        s = suffix
        _chain(self, [
            (f"conv5_1_CPM{s}", in_features, 128, 3),
            (f"conv5_2_CPM{s}", 128, 128, 3),
            (f"conv5_3_CPM{s}", 128, 128, 3),
            (f"conv5_4_CPM{s}", 128, 512, 1),
            (f"conv5_5_CPM{s}", 512, out_features, 1, False),
        ])


class RefineBranch(nn.Sequential):
    """Refinement-stage branch: 5x(7x7) + 1x1x128 + 1x1 out."""

    def __init__(self, in_features: int, out_features: int, stage: int,
                 suffix: str = ""):
        super().__init__()
        t = f"_stage{stage}{suffix}"
        _chain(self, [
            (f"Mconv1{t}", in_features, 128, 7),
            (f"Mconv2{t}", 128, 128, 7),
            (f"Mconv3{t}", 128, 128, 7),
            (f"Mconv4{t}", 128, 128, 7),
            (f"Mconv5{t}", 128, 128, 7),
            (f"Mconv6{t}", 128, 128, 1),
            (f"Mconv7{t}", 128, out_features, 1, False),
        ])


class Stage1SingleBranch(nn.Sequential):
    """FaceNet/HandNet stage-1 head: 1x1x512 + 1x1 out."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        _chain(self, [
            ("conv6_1_CPM", in_features, 512, 1),
            ("conv6_2_CPM", 512, out_features, 1, False),
        ])


class SingleBranchCPM(nn.Module):
    """The crop nets' topology (FaceNet, HandNet): ``VGGFaceStem``, a
    single-branch stage 1, then refine stages on concat(previous heatmap,
    feature).  Submodules are named as the Flax ones (``stem``,
    ``stage1`` ... ``stage6``); weights are drawn from ``seed`` as
    ``init_conv_weights`` says; ``dtype`` is the compute dtype."""

    num_channels: int = 0   # keypoints + background, set by the subclass

    def __init__(self, num_stages: int = 6, seed: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stages = num_stages
        self.dtype = dtype
        c = self.num_channels
        self.stem = VGGFaceStem()
        self.stage1 = Stage1SingleBranch(128, c)
        for stage in range(2, num_stages + 1):
            self.add_module(f"stage{stage}", RefineBranch(c + 128, c, stage))
        init_conv_weights(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) normalized crops -> heatmaps
        (num_stages, B, H/8, W/8, C) float32."""
        x = x.permute(0, 3, 1, 2).contiguous()
        if x.dtype != self.dtype:
            x = x.to(self.dtype)
        feature = self.stem(x)
        h = self.stage1(feature)
        heatmaps = [h]
        for stage in range(2, self.num_stages + 1):
            h = getattr(self, f"stage{stage}")(torch.cat([h, feature], dim=1))
            heatmaps.append(h)
        return stack_stages(heatmaps)


@torch.no_grad()
def init_conv_weights(model: nn.Module, seed: int) -> None:
    """Seeded draw of every conv, in module order, with Flax's default
    init (what the JAX package's random weights use): ``lecun_normal``
    kernels, a normal truncated at 2 sigma with variance 1/fan_in, and zero
    biases.  PyTorch's own default (uniform biases of +-1/sqrt(fan_in))
    leaves a 40-layer random net's maps flat and bias-dominated, with no
    peaks to calibrate."""
    gen = torch.Generator().manual_seed(seed)
    for conv in model.modules():
        if isinstance(conv, nn.Conv2d):
            fan_in = conv.weight[0].numel()
            # Flax divides by the std of a unit normal truncated at +-2.
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=gen)
            conv.bias.zero_()


def stack_stages(stage_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """NCHW per-stage outputs -> one (S, B, H, W, C) float32 tensor."""
    return torch.stack([o.float() for o in stage_outputs]).permute(
        0, 1, 3, 4, 2)
