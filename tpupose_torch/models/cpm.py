"""Shared Convolutional-Pose-Machine building blocks (port of
``tpupose/models/cpm.py``).

Activations are NCHW inside the modules (cuDNN's layout); the public model
boundary (``CocoPoseNet``) converts to and from the JAX package's
channels-last layout.  Submodule names mirror the Chainer layer names
(``conv1_1`` ... ``Mconv7_stage6_L2``), so a state-dict key reads
``stem.conv1_1.conv.weight`` where the Flax tree has
``params/stem/conv1_1/conv/kernel``.
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
        x = self.conv(x)
        return F.relu(x) if self.relu else x


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pooling, floor on odd sizes like Flax VALID."""
    return F.max_pool2d(x, 2, 2)


def _chain(module: nn.Module, specs) -> None:
    """Register ``(name, in, out, k[, relu])`` ConvReLU layers in order."""
    for name, cin, cout, k, *relu in specs:
        module.add_module(name, ConvReLU(cin, cout, k, *relu))


class VGG19Stem(nn.Module):
    """VGG-19 through conv4_2 plus the two CPM adapter convs: 3 -> 128
    channels at stride 8."""

    _POOL_AFTER = ("conv1_2", "conv2_2", "conv3_4")

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name, layer in self.named_children():
            x = layer(x)
            if name in self._POOL_AFTER:
                x = max_pool_2x2(x)
        return x


class Stage1Branch(nn.Module):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class RefineBranch(nn.Module):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


def stack_stages(stage_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """NCHW per-stage outputs -> one (S, B, H, W, C) float32 tensor."""
    return torch.stack([o.float() for o in stage_outputs]).permute(
        0, 1, 3, 4, 2)
