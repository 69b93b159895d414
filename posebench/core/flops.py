"""Peaks of the card and the least time of the int8 conv kernels.

The peaks and ``conv7_bound`` / ``conv_s8_bound`` are frozen from
``chip_smoke.py`` (``HBM_BYTES_PER_S`` ... ``conv_s8_bound``); the layer
shapes come from the configuration (``reference/nets.py``), so the count of
work does not depend on which kernel implements a layer.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from posebench.reference import nets

# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12        # float32 outside the tensor cores, FMA = 2
PEAK_OPS_PER_S = {"f32": F32_OPS_PER_S, "int8": INT8_OPS_PER_S}


def _bound_s(n_bytes: float, ops: float, peak_ops: float) -> float:
    """The least seconds: the larger of bytes over the memory rate and
    operations over their peak."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / peak_ops)


def conv7_bound_s(b: int, h: int, w: int, channels: Tuple[int, ...],
                  o: int) -> float:
    """A 7x7 int8 layer: each input (activations, int8 weights, mults,
    bias) read once and the int8 output written once; 2 operations per
    multiply-add of the real channels."""
    c = sum(channels)
    n_bytes = b * h * w * c + 49 * c * o + 4 * o * (len(channels) + 1) \
        + b * h * w * o
    return _bound_s(n_bytes, 2 * b * h * w * o * 49 * c, INT8_OPS_PER_S)


def conv_s8_bound_s(b: int, h: int, w: int, c: int, o: int, k: int
                    ) -> float:
    """A 1x1 or 3x3 int8 layer with one input group, as ``conv7_bound_s``."""
    n_bytes = b * h * w * c + k * k * c * o + 8 * o + b * h * w * o
    return _bound_s(n_bytes, 2 * b * h * w * o * k * k * c, INT8_OPS_PER_S)


def int8_layers(cfg: dict, input_hw) -> Iterable:
    """(layer, (h, w)) of every int8 layer that is not a head: the heads
    (no ReLU) stay float32 in the w8a8 scheme."""
    return [(layer, hw) for layer, hw in nets.layer_grids(cfg, input_hw)
            if layer.relu]


def conv7_forward_bound_s(cfg: dict, input_hw, batch: int) -> float:
    """Least seconds of one forward's 7x7 int8 layers at ``batch``."""
    return sum(conv7_bound_s(batch, h, w, layer.groups, layer.cout)
               for layer, (h, w) in int8_layers(cfg, input_hw)
               if layer.k == 7)


def conv_s8_forward_bound_s(cfg: dict, input_hw, batch: int) -> float:
    """Least seconds of one forward's 1x1 and 3x3 int8 layers."""
    return sum(conv_s8_bound_s(batch, h, w, layer.cin, layer.cout, layer.k)
               for layer, (h, w) in int8_layers(cfg, input_hw)
               if layer.k != 7)


def forward_ops(cfg: dict, input_hw, batch: int = 1) -> int:
    """Operations of one forward (2 per multiply-add)."""
    return 2 * batch * nets.forward_macs(cfg, input_hw)
