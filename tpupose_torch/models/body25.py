"""Body25Net: OpenPose's BODY_25 body model (Cao, Hidalgo, Simon, Wei,
Sheikh, "OpenPose: Realtime Multi-Person 2D Pose Estimation using Part
Affinity Fields", TPAMI 2019, section 3 and Fig. 3; the layer table of
``models/pose/body_25/pose_deploy.prototxt``).

- Stem: VGG-19 ``conv1_1`` to ``conv4_2`` with ReLU, then ``conv4_3_CPM``
  (3x3, 512 -> 256) and ``conv4_4_CPM`` (3x3, 256 -> 128) with PReLU: a
  128-channel feature at stride 8.
- A dense block of width w (``Mconv{i}_stage{s}_L{b}_{0,1,2}``): three
  3x3 PReLU convs, ``_0`` on the block's input, ``_1`` on ``_0``'s output,
  ``_2`` on ``_1``'s; its output is ``[_0, _1, _2]``, 3w channels.
- A stage: 5 dense blocks, ``Mconv6`` (1x1, 3w -> m, PReLU) and
  ``Mconv7`` (1x1, m -> out, no activation).
- The PAF stages come first (branch ``L2``, 52 channels, 26 pairs):
  stage0 on the feature (w 96, m 256), stages 1-3 on ``[feature, PAF]``
  (w 128, m 512).  Then the confidence maps (branch ``L1``, 26 channels,
  25 parts and the background): stage0 on ``[feature, last PAF]`` (w 96,
  m 256), stage1 on ``[feature, heatmap, last PAF]`` (w 128, m 512).

114 convs, 26.15 M parameters.  Module names are the prototxt's layer
names (``stem.conv4_3_CPM``, ``stage0_L2.Mconv1_stage0_L2_0``), so a
weight loader maps one to one.  The forward opens the spans ``b25.stem``,
``b25.paf_stages`` and ``b25.cm_stages``; the int8 forward
(``quant.py``) opens the same.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from tpupose_torch.models.cpm import (_Stem, _chain, init_conv_weights,
                                      stack_stages)
from tpupose_torch.topology import BODY25
from tpupose_torch.utils.profiling import annotate

NUM_FEATURES = 128
NUM_PAF_CHANNELS = BODY25.paf_channels          # 52: 26 pairs x (x, y)
NUM_HEATMAP_CHANNELS = BODY25.heatmap_channels  # 26: 25 parts + background
DENSE_BLOCKS = 5

# The stages in forward order: (module, block width w, Mconv6 width m, the
# earlier stages whose outputs follow the feature in its input, in concat
# order).  Branch L2 holds the PAFs, L1 the heatmaps.
STAGES: Tuple[Tuple[str, int, int, Tuple[str, ...]], ...] = (
    ("stage0_L2", 96, 256, ()),
    ("stage1_L2", 128, 512, ("stage0_L2",)),
    ("stage2_L2", 128, 512, ("stage1_L2",)),
    ("stage3_L2", 128, 512, ("stage2_L2",)),
    ("stage0_L1", 96, 256, ("stage3_L2",)),
    ("stage1_L1", 128, 512, ("stage0_L1", "stage3_L2")),
)
PAF_STAGES = tuple(s for s in STAGES if s[0].endswith("_L2"))
CM_STAGES = tuple(s for s in STAGES if s[0].endswith("_L1"))
SPANS = ("b25.stem", "b25.paf_stages", "b25.cm_stages")


def out_channels(module: str) -> int:
    """A stage's output channels: 52 PAF or 26 heatmap channels."""
    return NUM_PAF_CHANNELS if module.endswith("_L2") else \
        NUM_HEATMAP_CHANNELS


def stage_in_channels(prev: Tuple[str, ...]) -> Tuple[int, ...]:
    """The channels of a stage's input, one entry per concat member."""
    return (NUM_FEATURES,) + tuple(out_channels(p) for p in prev)


def stage_layers(module: str) -> Tuple[str, ...]:
    """A stage's layer names in forward order: the 15 dense convs, then
    ``Mconv6`` and ``Mconv7``."""
    t = module[len("stage"):]              # "0_L2"
    dense = tuple(f"Mconv{i}_stage{t}_{j}" for i in range(1, DENSE_BLOCKS + 1)
                  for j in range(3))
    return dense + (f"Mconv6_stage{t}", f"Mconv7_stage{t}")


class Body25Stem(_Stem):
    """VGG-19 through conv4_2 (ReLU), then the CPM convs with PReLU: 3 ->
    128 channels at stride 8."""

    def __init__(self):
        super().__init__()
        _chain(self, [
            ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3),
            ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3),
            ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
            ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3),
            ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
            ("conv4_3_CPM", 512, 256, 3, "prelu"),
            ("conv4_4_CPM", 256, 128, 3, "prelu"),
        ])


class DenseStage(nn.Module):
    """One BODY_25 stage: 5 dense blocks of width ``width``, ``Mconv6``
    (1x1, 3 width -> ``mid``, PReLU), ``Mconv7`` (1x1, mid -> ``out``)."""

    def __init__(self, module: str, in_features: int, width: int, mid: int,
                 out: int):
        super().__init__()
        names = stage_layers(module)
        specs, cin = [], in_features
        for i in range(DENSE_BLOCKS):
            specs += [(names[3 * i], cin, width, 3, "prelu"),
                      (names[3 * i + 1], width, width, 3, "prelu"),
                      (names[3 * i + 2], width, width, 3, "prelu")]
            cin = 3 * width
        specs += [(names[-2], cin, mid, 1, "prelu"),
                  (names[-1], mid, out, 1, False)]
        _chain(self, specs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self.children())
        for i in range(DENSE_BLOCKS):
            a = layers[3 * i](x)
            b = layers[3 * i + 1](a)
            c = layers[3 * i + 2](b)
            x = torch.cat([a, b, c], dim=1)
        return layers[-1](layers[-2](x))


class Body25Net(nn.Module):
    """BODY_25; returns the stacked PAF stages (4, B, H/8, W/8, 52) and
    heatmap stages (2, B, H/8, W/8, 26).  Weights and PReLU slopes are
    drawn from ``seed`` (``init_conv_weights``); ``dtype`` is the compute
    dtype (float32 or bfloat16 over float32 parameters, see ``cpm``)."""

    topology = BODY25
    decoder = "paf"

    def __init__(self, seed: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = Body25Stem()
        for module, width, mid, prev in STAGES:
            self.add_module(module, DenseStage(
                module, sum(stage_in_channels(prev)), width, mid,
                out_channels(module)))
        init_conv_weights(self, seed)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) normalized image -> (pafs, heatmaps)."""
        x = x.permute(0, 3, 1, 2).contiguous()
        if x.dtype != self.dtype:
            x = x.to(self.dtype)
        with annotate(SPANS[0]):
            feature = self.stem(x)
        outs = {}
        for span, stages in ((SPANS[1], PAF_STAGES), (SPANS[2], CM_STAGES)):
            with annotate(span):
                for module, _, _, prev in stages:
                    outs[module] = getattr(self, module)(torch.cat(
                        [feature] + [outs[p] for p in prev], dim=1)
                        if prev else feature)
        return (stack_stages([outs[s[0]] for s in PAF_STAGES]),
                stack_stages([outs[s[0]] for s in CM_STAGES]))
