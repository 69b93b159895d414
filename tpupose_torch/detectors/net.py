"""The network a detector runs (``DetectorNet``), below ``pose.py`` and
``crop_keypoints.py`` and above ``models/`` and ``quant.py``: built from
``models.ARCHS``, loaded and placed; quantized to w8a8 int8; run; and its
weights as a bundle stores them and as an exported program takes them.
A detector holds one as ``self.net``; what it does before and after the
network (normaliser, geometry, mesh, postprocess, tails) stays in it.

``float32_numerics`` runs convs with cuDNN's TF32 off and matmuls at
``"highest"`` float32 precision; TF32 keeps ~3 decimal digits, enough to
move peak coordinates.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call

from tpupose_torch.models import ARCHS
from tpupose_torch.ops.resize import resize_u8_linear
from tpupose_torch.parallel.spatial import spatial_halos
from tpupose_torch.quant import (calibrate_ranges, make_quant_apply,
                                 model_params, qtree_to_device, quant_apply,
                                 quantize, resolve_conv7_impl)
from tpupose_torch.weights import (load_chainer_npz, load_flax_params,
                                   warn_on_load_report)


@contextlib.contextmanager
def float32_numerics():
    """cuDNN convs without TF32 (deterministic algorithms) and float32
    matmuls at ``"highest"`` precision, restored on exit."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(old)


class DetectorNet:
    """One architecture's network on one device, float or int8."""

    def __init__(self, arch: str, device, owner: str,
                 weights_file: Optional[str] = None, params=None,
                 seed: int = 0, compute_dtype: torch.dtype = torch.float32):
        """The weights, seed and dtype as the detectors take them;
        ``owner`` names the detector in errors."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{owner}(device={device!r}): CUDA is not available")
        if (arch in ("body25", "higherhrnet_w32")
                and (params is not None or weights_file)):
            raise ValueError(f"{owner}(arch={arch!r}): no weight loader "
                             "for it yet; it runs seeded weights")
        self.arch = arch
        model = ARCHS[arch](seed=seed, dtype=compute_dtype)
        if params is not None:
            load_flax_params(model, params)
        elif weights_file:
            report = load_chainer_npz(model, weights_file)
            warn_on_load_report(report, weights_file, arch=arch)
        self.model = model.to(self.device, compute_dtype).eval()
        # set by quantize()
        self.quantized = False
        self.qtree = None
        self.quant_static = None
        self.conv7_impl = None
        self.quant_forward = None

    def quantize(self, images, size: int,
                 normalise: Callable[[torch.Tensor], torch.Tensor],
                 conv7_impl: Optional[str] = None) -> None:
        """Switch to post-training w8a8 int8 inference.  ``images``: a few
        representative HWC uint8 frames, each resized to ``size`` square on
        the host and ``normalise``d on the device; the activation ranges are
        taken over them.  ``conv7_impl``: the route
        (``quant.resolve_conv7_impl``)."""
        if self.quantized:
            raise ValueError("detector is already quantized")
        conv7_impl = resolve_conv7_impl(conv7_impl, self.device)
        frames = np.stack([resize_u8_linear(np.asarray(img), (size, size))
                           for img in images])
        with float32_numerics():
            ranges = calibrate_ranges(self.model, normalise(
                torch.from_numpy(frames).to(self.device)))
        self.qtree, self.quant_static = quantize(self.arch, self.model,
                                                 ranges)
        self.quant_forward = make_quant_apply(
            self.quant_static, qtree_to_device(self.qtree, self.quant_static,
                                               self.device, conv7_impl),
            conv7_impl)
        self.quantized = True
        self.conv7_impl = conv7_impl

    def __call__(self, x: torch.Tensor, weights=None, halo=None,
                 int8: bool = True):
        """The forward on normalized (B, H, W, 3) inputs: the int8 one when
        quantized and ``int8``, else the float model.  ``weights``: a traced
        program's weight inputs (``program_weights``' layout), or None for
        the net's own.  ``halo``: the ``SpatialSlabs`` of which ``x`` is
        this rank's slab."""
        if int8 and self.quantized:
            if weights is None:
                return self.quant_forward(x, halo)
            return quant_apply(self.quant_static, weights, x,
                               self.conv7_impl)
        if weights is not None:
            return functional_call(
                self.model, weights["f32"] if self.quantized else weights,
                (x,))
        if halo is None:
            return self.model(x)
        with spatial_halos(self.model, halo):
            return self.model(x)

    def host_weights(self, f32: bool = False):
        """The weights as host data: the float model's Flax param tree
        (numpy HWIO kernels, ``quant.model_params``); a quantized net's
        numpy int8 tree, with the float tree under ``"f32"`` if ``f32``
        (some forwards stay float: the JAX package's mixed tree)."""
        if not self.quantized:
            return {"params": model_params(self.model)}
        tree = dict(self.qtree)
        if f32:
            tree["f32"] = {"params": model_params(self.model)}
        return tree

    def program_weights(self, device=None, f32: bool = False):
        """The weights as a traced program takes them, on ``device``
        (default: the net's): the float model's ``state_dict``; a quantized
        net's ``qtree_to_device`` tree of its route, with the
        ``state_dict`` under ``"f32"`` if ``f32``."""
        device = torch.device(device or self.device)

        def state():
            return {k: v.detach().to(device)
                    for k, v in self.model.state_dict().items()}

        if not self.quantized:
            return state()
        tree = qtree_to_device(self.qtree, self.quant_static, device,
                               self.conv7_impl)
        if f32:
            tree["f32"] = state()
        return tree


class NetHolder:
    """What a detector shows of the ``DetectorNet`` it holds as
    ``self.net``: the model (which may be swapped for another module)
    and the int8 state."""

    model = property(lambda self: self.net.model,
                     lambda self, model: setattr(self.net, "model", model))
    quantized = property(lambda self: self.net.quantized)
    qtree = property(lambda self: self.net.qtree)
    quant_static = property(lambda self: self.net.quant_static)
    conv7_impl = property(lambda self: self.net.conv7_impl)
