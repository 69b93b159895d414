"""Plain float32 forward of the two CPM topologies, from a configuration file.

The layer table follows the published prototxts (``configs/*.json`` hold the
widths): a VGG stem with 2x2 max pools, a stage-1 head, then refine stages
whose input is the concatenation of the previous stage's outputs (PAF branch
first, then heatmap branch) and the stem feature.  Every conv is a SAME conv
with ReLU, except each branch's last 1x1 conv.  Parameters are named as the
program's ``state_dict`` names them (``stem.conv1_1.conv.weight``), which is
how the benchmark hands one set of weights to both.

Nothing here imports the program.  Activations are NCHW; the input is
(B, H, W, 3) channels-last, as the program takes it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Layer:
    module: str            # "stem", "stage1_L1", "stage3", ...
    name: str              # "conv1_1", "Mconv1_stage3_L2", ...
    groups: Tuple[int, ...]  # input channels, one entry per concat member
    cout: int
    k: int
    relu: bool
    stage: int = 0         # 0 for the stem

    @property
    def key(self) -> str:
        return f"{self.module}.{self.name}.conv"

    @property
    def path(self) -> str:
        return f"{self.module}/{self.name}"

    @property
    def cin(self) -> int:
        return sum(self.groups)


def stage_modules(cfg: dict, stage: int) -> List[Tuple[str, str, int]]:
    """(module, suffix, out channels) of each branch of ``stage``."""
    return [(f"stage{stage}{suffix}", suffix, out)
            for suffix, out in cfg["branches"]]


def layer_table(cfg: dict) -> List[Layer]:
    """Every conv of the configuration, in forward order, stage by stage
    and branch by branch."""
    layers = [Layer("stem", name, (cin,), cout, k, True)
              for name, cin, cout, k in cfg["stem"]]
    feat = cfg["stem"][-1][2]
    heads = [out for _, out in cfg["branches"]]
    for stage in range(1, cfg["num_stages"] + 1):
        for module, suffix, out in stage_modules(cfg, stage):
            if stage == 1:
                groups = (feat,)
                for name, width, k in cfg["stage1"]:
                    layers.append(Layer(module, f"{name}{suffix}", groups,
                                        width, k, True, stage))
                    groups = (width,)
                layers.append(Layer(module, f"{cfg['stage1_out']}{suffix}",
                                    groups, out, 1, False, stage))
                continue
            t = f"_stage{stage}{suffix}"
            groups = tuple(heads) + (feat,)
            width, k = cfg["refine_width"], cfg["refine_kernel"]
            for i in range(1, cfg["refine_layers"] + 1):
                layers.append(Layer(module, f"Mconv{i}{t}", groups, width, k,
                                    True, stage))
                groups = (width,)
            n = cfg["refine_layers"]
            layers.append(Layer(module, f"Mconv{n + 1}{t}", groups,
                                cfg["refine_mid_width"], 1, True, stage))
            layers.append(Layer(module, f"Mconv{n + 2}{t}",
                                (cfg["refine_mid_width"],), out, 1, False,
                                stage))
    return layers


def layer_grids(cfg: dict, input_hw: Tuple[int, int]
                ) -> List[Tuple[Layer, Tuple[int, int]]]:
    """Each layer with the (H, W) it runs at for a network input of
    ``input_hw`` (pools floor odd sizes)."""
    h, w = input_hw
    pools = set(cfg["pool_after"])
    out = []
    for layer in layer_table(cfg):
        out.append((layer, (h, w)))
        if layer.module == "stem" and layer.name in pools:
            h, w = h // 2, w // 2
    return out


def forward_macs(cfg: dict, input_hw: Tuple[int, int]) -> int:
    """Multiply-adds of one forward at ``input_hw``, from the shapes."""
    return sum(h * w * layer.k * layer.k * layer.cin * layer.cout
               for layer, (h, w) in layer_grids(cfg, input_hw))


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """``state_dict`` name -> shape, in layer order (weight, then bias)."""
    shapes = {}
    for layer in layer_table(cfg):
        shapes[f"{layer.key}.weight"] = (layer.cout, layer.cin, layer.k,
                                         layer.k)
        shapes[f"{layer.key}.bias"] = (layer.cout,)
    return shapes


def seeded_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights drawn on ``device`` from ``seed`` in one call: a unit normal
    clamped at 2 sigma, scaled per layer to lecun-normal (variance 1/fan_in,
    as Flax's truncated init), and zero biases.  Returns views of one flat
    buffer, keyed as ``param_shapes``."""
    shapes = param_shapes(cfg)
    weights = [(k, s) for k, s in shapes.items() if k.endswith(".weight")]
    total = sum(s[0] * s[1] * s[2] * s[3] for _, s in weights)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    flat.clamp_(-2.0, 2.0)
    params, pos = {}, 0
    for key, shape in shapes.items():
        if key.endswith(".bias"):
            params[key] = torch.zeros(shape, device=device)
            continue
        n = shape[0] * shape[1] * shape[2] * shape[3]
        fan_in = shape[1] * shape[2] * shape[3]
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        params[key] = flat[pos:pos + n].view(shape).mul_(std)
        pos += n
    return params


def forward(cfg: dict, params: Dict[str, torch.Tensor], x: torch.Tensor,
            hook=None) -> List[List[torch.Tensor]]:
    """x: (B, H, W, 3) normalized float input -> per stage, the branches'
    NCHW outputs (float32).  ``hook(path, tensor)``, if given, sees every
    layer's output (after its ReLU) and every branch's last output under
    the module's path, as a calibration pass needs."""
    pools = set(cfg["pool_after"])
    h = x.permute(0, 3, 1, 2).contiguous()
    table = layer_table(cfg)

    def conv(layer, inp):
        y = F.conv2d(inp, params[f"{layer.key}.weight"],
                     params[f"{layer.key}.bias"], padding=layer.k // 2)
        if layer.relu:
            y = F.relu(y)
        if hook is not None:
            hook(layer.path, y)
        return y

    i = 0
    while table[i].module == "stem":
        h = conv(table[i], h)
        if table[i].name in pools:
            h = F.max_pool2d(h, 2, 2)
        i += 1
    feature = h
    stages: List[List[torch.Tensor]] = []
    for stage in range(1, cfg["num_stages"] + 1):
        inp = feature if stage == 1 else torch.cat(stages[-1] + [feature], 1)
        outs = []
        for module, _, _ in stage_modules(cfg, stage):
            y = inp
            while i < len(table) and table[i].module == module:
                y = conv(table[i], y)
                i += 1
            if hook is not None:
                hook(module, y)
            outs.append(y)
        stages.append(outs)
    return stages


def output_convs(cfg: dict) -> List[str]:
    """The ``state_dict`` prefixes of the last stage's output convs, one
    per branch."""
    return [layer.key for layer in layer_table(cfg)
            if not layer.relu
            and layer.module.startswith(f"stage{cfg['num_stages']}")]
