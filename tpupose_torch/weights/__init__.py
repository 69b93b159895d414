"""Weight loading and saving for the torch models (port of
``tpupose/weights/chainer_npz.py``; the Caffe reader is ``caffe.py``).

Two formats: the JAX package's Flax parameter tree (HWIO kernels, as numpy
arrays; ``load_flax_params`` and its inverse ``flax_params_from_model``)
and the reference's Chainer model ``.npz`` (``"<layer>/W"`` OIHW kernels,
``"<layer>/b"`` biases; ``load_chainer_npz`` and ``save_chainer_npz``,
which writes the keys of the JAX package's ``save_npz_params``).  Layer names route through
``layer_to_path``, the port's copy of the JAX package's, so both packages
read one file the same way (``tests/test_torch_config.py`` holds the two
equal on every CocoPoseNet layer).
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_POSE_STAGE1_RE = re.compile(r"^conv5_[1-5]_CPM(_L[12])$")
_POSE_MSTAGE_RE = re.compile(r"^Mconv[1-7]_stage([2-9])(_L[12])$")
_SINGLE_MSTAGE_RE = re.compile(r"^Mconv[1-7]_stage([2-9])$")


def layer_to_path(layer: str) -> Tuple[str, str]:
    """Map a Chainer layer name to its ``(block, layer)`` path: the conv
    lives at ``params[block][layer]["conv"]`` of a Flax tree and at
    ``model.<block>.<layer>.conv`` of the torch models."""
    m = _POSE_STAGE1_RE.match(layer)
    if m:
        return f"stage1{m.group(1)}", layer
    m = _POSE_MSTAGE_RE.match(layer)
    if m:
        return f"stage{m.group(1)}{m.group(2)}", layer
    m = _SINGLE_MSTAGE_RE.match(layer)
    if m:
        return f"stage{m.group(1)}", layer
    if layer in ("conv6_1_CPM", "conv6_2_CPM"):
        return "stage1", layer
    # Everything else (conv1_1 .. conv5_3_CPM and the *_CPM adapters) is stem.
    return "stem", layer


# Keys the reference's own converter never copies: its posenet layer list
# omits ``conv5_5_CPM_L1``, so official ``coco_posenet.npz`` files lack
# these two entries (the layer keeps its random init).  Anything else
# missing or left over means a wrong or truncated file.
EXPECTED_MISSING = {
    "posenet": frozenset({"conv5_5_CPM_L1/W", "conv5_5_CPM_L1/b"}),
}


def warn_on_load_report(report, path: str, arch: str = "posenet") -> None:
    """Warn when an npz load left layers at their random init (missing keys
    beyond the documented omission) or carried keys the model has no layer
    for (a file of another architecture)."""
    expected = EXPECTED_MISSING.get(arch, frozenset())
    missing = [k for k in report["missing"] if k not in expected]
    unused = list(report["unused"])
    if not (missing or unused):
        return
    parts = []
    if missing:
        parts.append(
            f"{len(missing)} model layers not in the file (left at "
            f"RANDOM init): {sorted(missing)[:6]}"
            + (" ..." if len(missing) > 6 else ""))
    if unused:
        parts.append(
            f"{len(unused)} file keys matched no model layer: "
            f"{unused[:6]}" + (" ..." if len(unused) > 6 else ""))
    warnings.warn(
        f"weight file {path!r} does not fully match the {arch} model — "
        + "; ".join(parts)
        + " (only the reference's documented conv5_5_CPM_L1 omission "
          "is expected for posenet)",
        RuntimeWarning, stacklevel=3)


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


def state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """A Flax param tree (``params[block][layer]["conv"]``, HWIO kernels)
    -> the torch models' ``state_dict`` keys and OIHW layout, as float32
    numpy arrays; no model is built."""
    params = params.get("params", params)
    out = {}
    for block, layers in params.items():
        for layer, leaves in layers.items():
            conv = leaves["conv"]
            out[f"{block}.{layer}.conv.weight"] = np.ascontiguousarray(
                np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1))
            out[f"{block}.{layer}.conv.bias"] = np.asarray(conv["bias"],
                                                           np.float32)
    return out


def flax_params_from_state_dict(state_dict: Mapping) -> Dict[str, dict]:
    """The inverse of ``state_dict_from_flax``: ``<block>.<layer>.conv.
    weight`` / ``.bias`` entries (OIHW; parameters or their gradients) ->
    a Flax param tree ``{block: {layer: {"conv": {"kernel", "bias"}}}}``
    of float32 numpy arrays, HWIO kernels."""
    tree: Dict[str, dict] = {}
    for name, value in state_dict.items():
        block, layer, conv, leaf = name.split(".")
        if conv != "conv" or leaf not in ("weight", "bias"):
            raise ValueError(f"{name}: not a conv parameter")
        value = value.detach().float().cpu().numpy()
        leaves = tree.setdefault(block, {}).setdefault(
            layer, {"conv": {}})["conv"]
        if leaf == "weight":
            leaves["kernel"] = np.ascontiguousarray(
                value.transpose(2, 3, 1, 0))
        else:
            leaves["bias"] = value
    return tree


def flax_params_from_model(model: nn.Module) -> Dict[str, dict]:
    """``model``'s parameters as a Flax param tree in the JAX package's
    keys and HWIO layout (numpy float32)."""
    return flax_params_from_state_dict(dict(model.named_parameters()))


def save_chainer_npz(path: str, model: nn.Module) -> None:
    """Save ``model`` as a Chainer model ``.npz``: ``"<layer>/W"`` OIHW and
    ``"<layer>/b"``, the keys ``tpupose.weights.save_npz_params`` writes."""
    flat: Dict[str, np.ndarray] = {}
    for name, module in model.named_modules():
        if isinstance(module, nn.Conv2d):
            layer = name.split(".")[-2]
            flat[f"{layer}/W"] = module.weight.detach().float().cpu().numpy()
            flat[f"{layer}/b"] = module.bias.detach().float().cpu().numpy()
    np.savez(path, **flat)
