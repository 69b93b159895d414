"""Weight loading for the torch models (port of
``tpupose/weights/chainer_npz.py``).

Two sources: the JAX package's Flax parameter tree (HWIO kernels, as numpy
arrays) and the reference's Chainer model ``.npz`` (``"<layer>/W"`` OIHW
kernels, ``"<layer>/b"`` biases).  Layer names route through the JAX
package's own ``layer_to_path``, so both packages read one file the same
way.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from tpupose.weights.chainer_npz import layer_to_path


def _conv(model: nn.Module, block: str, layer: str) -> nn.Conv2d:
    return getattr(getattr(model, block), layer).conv


def _assign(param: torch.Tensor, value: np.ndarray, what: str) -> None:
    value = torch.from_numpy(np.array(value, np.float32))  # a writable copy
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{what}: source shape {tuple(value.shape)} != "
                         f"model {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def load_flax_params(model: nn.Module, params: Mapping) -> None:
    """Copy a Flax param tree (``params[block][layer]["conv"]``, numpy or
    array-like leaves) into ``model`` in place.  Every conv of ``model``
    must be in the tree and vice versa."""
    params = params.get("params", params)
    seen = set()
    for block, layers in params.items():
        for layer, leaves in layers.items():
            conv = _conv(model, block, layer)
            kernel = np.asarray(leaves["conv"]["kernel"])   # HWIO
            _assign(conv.weight, kernel.transpose(3, 2, 0, 1),
                    f"{layer} kernel")
            _assign(conv.bias, np.asarray(leaves["conv"]["bias"]),
                    f"{layer} bias")
            seen.add(f"{block}.{layer}")
    _check_all_convs(model, seen)


def _check_all_convs(model: nn.Module, seen) -> None:
    missing = sorted(
        name.rsplit(".", 1)[0] for name, m in model.named_modules()
        if isinstance(m, nn.Conv2d)
        and name.rsplit(".", 1)[0] not in seen)
    if missing:
        raise ValueError(f"Flax tree lacks model convs: {missing[:6]}")


def load_chainer_npz(model: nn.Module, path: str) -> Dict[str, list]:
    """Load a Chainer model ``.npz`` into ``model`` in place.

    Returns a report ``{"loaded", "missing", "unused"}`` of npz keys, as
    ``tpupose.weights.load_npz_params`` does; layers missing from the file
    keep their current values."""
    with np.load(path) as archive:
        flat = {k: archive[k] for k in archive.files}
    loaded, missing = [], []
    for name, module in model.named_modules():
        if not isinstance(module, nn.Conv2d):
            continue
        layer = name.split(".")[-2]
        block, _ = layer_to_path(layer)
        if f"{block}.{layer}.conv" != name:
            raise ValueError(f"{name}: not where layer_to_path puts {layer}")
        for key, param in ((f"{layer}/W", module.weight),
                           (f"{layer}/b", module.bias)):
            if key in flat:
                _assign(param, flat.pop(key), key)
                loaded.append(key)
            else:
                missing.append(key)
    return {"loaded": loaded, "missing": missing, "unused": sorted(flat)}
