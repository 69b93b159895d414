"""CocoPoseNet: VGG-19 stem + stages x 2 branches (port of
``tpupose/models/posenet.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from tpupose_torch.models.cpm import (RefineBranch, Stage1Branch, VGG19Stem,
                                      init_conv_weights, stack_stages)
from tpupose_torch.topology import COCO18

NUM_PAF_CHANNELS = 38      # 19 limbs x (x, y)
NUM_HEATMAP_CHANNELS = 19  # 18 joints + background
NUM_FEATURES = 128


class CocoPoseNet(nn.Module):
    """Multi-person pose network; returns stacked per-stage PAFs/heatmaps.

    Submodules are named as the Flax ones (``stem``, ``stage1_L1``, ...,
    ``stage6_L2``).  Weights are initialised from ``seed`` through an
    explicit ``torch.Generator`` (see ``init_conv_weights``), so two
    models built with one seed are equal.  ``dtype`` is the compute dtype
    (float32 or bfloat16; the parameters stay float32, see ``cpm``).
    """

    topology = COCO18
    decoder = "paf"

    def __init__(self, num_stages: int = 6, seed: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stages = num_stages
        self.dtype = dtype
        self.stem = VGG19Stem()
        self.stage1_L1 = Stage1Branch(NUM_FEATURES, NUM_PAF_CHANNELS, "_L1")
        self.stage1_L2 = Stage1Branch(NUM_FEATURES, NUM_HEATMAP_CHANNELS,
                                      "_L2")
        cin = NUM_PAF_CHANNELS + NUM_HEATMAP_CHANNELS + NUM_FEATURES
        for stage in range(2, num_stages + 1):
            self.add_module(f"stage{stage}_L1", RefineBranch(
                cin, NUM_PAF_CHANNELS, stage, "_L1"))
            self.add_module(f"stage{stage}_L2", RefineBranch(
                cin, NUM_HEATMAP_CHANNELS, stage, "_L2"))
        init_conv_weights(self, seed)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) normalized image -> (pafs, heatmaps) where
        pafs: (num_stages, B, H/8, W/8, 38), heatmaps: (..., 19)."""
        x = x.permute(0, 3, 1, 2).contiguous()
        if x.dtype != self.dtype:
            x = x.to(self.dtype)
        feature = self.stem(x)
        h1 = self.stage1_L1(feature)
        h2 = self.stage1_L2(feature)
        pafs, heatmaps = [h1], [h2]
        for stage in range(2, self.num_stages + 1):
            h = torch.cat([h1, h2, feature], dim=1)  # [paf, heatmap, feature]
            h1 = getattr(self, f"stage{stage}_L1")(h)
            h2 = getattr(self, f"stage{stage}_L2")(h)
            pafs.append(h1)
            heatmaps.append(h2)
        return stack_stages(pafs), stack_stages(heatmaps)

