"""The w8a8 int8 forward of the reference, and its int4-weight control.

The scheme, frozen from ``tpupose_torch/quant.py`` (the JAX package's
``quant.py``): symmetric per-output-channel weights; symmetric activations
``v = a * X`` with ``a = max|v| / 127`` taken over a calibration forward; the
image layer quantized losslessly as ``X = u8 - 128``; the concatenation that
enters each refine stage kept as one group per member at its own scale; each
branch's output conv (the head) in float32.  The folded epilogue of a layer
is ``y = sum_g acc_g * mult_g + bias_eff`` in float32, in group order; a
layer with ReLU stores ``clip(round(max(y, 0)), 0, 127)``.

The integer sums run as float64 convolutions of the int8 values: every
partial sum is an integer below 2**53, so they are exact whatever the
order, and they round to float32 as an int32 does.  ``bits=4`` quantizes
the weights to [-7, 7] instead: the control of the int8 cells.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from posebench.reference import nets

_EPS = 1e-12


def calibration_ranges(cfg: dict, params, frames_norm: torch.Tensor
                       ) -> Dict[str, float]:
    """``path -> max|value|`` of every layer's output (after its ReLU) and
    every branch's output, over the float32 forward of each (H, W, 3)
    normalized frame, one at a time."""
    ranges: Dict[str, float] = {}
    with torch.no_grad():
        for frame in frames_norm:
            maxes = {}
            nets.forward(cfg, params, frame[None],
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


def _layer(kernel: np.ndarray, bias: np.ndarray, groups, a_out, qmax: int):
    """One layer's int8 kernels (HWIO per group), float32 mults and bias."""
    kqs, mults = [], []
    bias_eff = (bias if a_out is None else bias / a_out).astype(np.float64)
    start = 0
    for a_in, z_in, n in groups:
        kq, ws = _quantize_kernel(kernel[:, :, start:start + n, :], qmax)
        start += n
        s_o = kq.astype(np.int64).sum(axis=(0, 1, 2)).astype(np.float64)
        mult = a_in * ws if a_out is None else a_in * ws / a_out
        bias_eff = bias_eff + z_in * s_o * mult
        kqs.append(kq)
        mults.append(mult.astype(np.float32))
    return kqs, mults, bias_eff.astype(np.float32)


def quantize(cfg: dict, params, ranges: Dict[str, float], bits: int = 8):
    """Float weights + ranges -> ``{path: (kernels, mults, bias)}`` and the
    refine stages' input scales ``{stage: (a_branch, ...)}``, on the host."""
    qmax = {8: 127, 4: 7}[bits]
    host = {k: v.detach().float().cpu().numpy() for k, v in params.items()}

    def a_of(path):
        return max(ranges[path], _EPS) / 127.0

    table = nets.layer_table(cfg)
    a_in = 1.0 / cfg["input_scale"]
    z_in = 0.5 if cfg["input_scale"] == 255.0 else 0.0
    a_feat = a_in
    layers, part_scales = {}, {}
    for i, layer in enumerate(table):
        kernel = host[f"{layer.key}.weight"].transpose(2, 3, 1, 0)
        bias = host[f"{layer.key}.bias"]
        if layer.stage == 0:
            groups = [(a_in, z_in, layer.cin)]
        elif table[i - 1].module == layer.module:
            groups = [(a_of(table[i - 1].path), 0.0, layer.cin)]
        elif layer.stage == 1:
            groups = [(a_feat, 0.0, layer.cin)]
        else:
            heads = tuple(a_of(m) for m, _, _ in
                          nets.stage_modules(cfg, layer.stage - 1))
            part_scales[layer.stage] = tuple(np.float32(a) for a in heads)
            groups = [(a, 0.0, n) for a, n in zip(heads, layer.groups[:-1])]
            groups.append((a_feat, 0.0, layer.groups[-1]))
        a_out = a_of(layer.path) if layer.relu else None
        layers[layer.path] = _layer(kernel, bias, groups, a_out, qmax)
        if layer.stage == 0:
            a_in, z_in = a_out, 0.0
            a_feat = a_out
    return layers, part_scales


def to_device(q, device):
    """The quantized layers as float64 OIHW kernels (one per group) and
    float32 mults and bias on ``device``."""
    layers, part_scales = q
    out = {}
    for path, (kqs, mults, bias) in layers.items():
        out[path] = (
            [torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
             .to(device, torch.float64) for k in kqs],
            [torch.from_numpy(m).to(device) for m in mults],
            torch.from_numpy(bias).to(device))
    scales = {s: [torch.tensor([a], dtype=torch.float32, device=device)
                  for a in v] for s, v in part_scales.items()}
    return out, scales


def _epilogue(accs: List[torch.Tensor], mults, bias, relu: bool):
    y = None
    for acc, mult in zip(accs, mults):
        part = acc.float() * mult[:, None, None]
        y = part if y is None else y + part
    y = y + bias[:, None, None]
    if not relu:
        return y
    y = torch.clamp_min(y, 0.0)
    return torch.clamp(torch.round(y), 0.0, 127.0)


def forward(cfg: dict, qdev, x_u8: torch.Tensor) -> List[torch.Tensor]:
    """(B, H, W, 3) uint8 network inputs on the device -> the last stage's
    float32 NCHW maps, one per branch.  Integer activations are held as
    float64 values."""
    layers, scales = qdev
    scale = cfg["input_scale"]
    z = 0.5 if scale == 255.0 else 0.0
    x = x_u8.float() / scale - 0.5
    xq = torch.clamp(torch.round(x / (1.0 / scale) - z), -128.0, 127.0)
    h = xq.permute(0, 3, 1, 2).contiguous().double()
    table = nets.layer_table(cfg)
    pools = set(cfg["pool_after"])

    def conv(layer, parts):
        kernels, mults, bias = layers[layer.path]
        accs = [F.conv2d(p, k, padding=layer.k // 2)
                for p, k in zip(parts, kernels)]
        y = _epilogue(accs, mults, bias, layer.relu)
        return y.double() if layer.relu else y

    i = 0
    while table[i].module == "stem":
        h = conv(table[i], [h])
        if table[i].name in pools:
            h = F.max_pool2d(h, 2, 2)
        i += 1
    feat = h
    outs: List[torch.Tensor] = []
    for stage in range(1, cfg["num_stages"] + 1):
        if stage == 1:
            parts_in = [feat]
        else:
            parts_in = [torch.clamp(torch.round(o / a), -128.0, 127.0)
                        .double() for o, a in zip(outs, scales[stage])]
            parts_in.append(feat)
        new = []
        for module, _, _ in nets.stage_modules(cfg, stage):
            parts = parts_in
            while i < len(table) and table[i].module == module:
                parts = [conv(table[i], parts)]
                i += 1
            new.append(parts[0])
        outs = new
    return outs


def build(cfg: dict, params, calib_u8: np.ndarray, device, bits: int = 8):
    """Ranges from the float32 forward of the calibration inputs (uint8
    (B, S, S, 3), already resized), then the quantized layers on
    ``device``."""
    x = torch.from_numpy(calib_u8).to(device).float() / cfg["input_scale"] \
        - 0.5
    ranges = calibration_ranges(cfg, params, x)
    return to_device(quantize(cfg, params, ranges, bits), device)

