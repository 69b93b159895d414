"""Host-to-device copies that leave the host free.

A plain ``tensor.to("cuda")`` of host memory is a synchronous copy: the
host waits for the device to drain its stream first, which serialises a
pipelined ``submit``.  ``to_device`` stages the data in pinned memory and
copies it asynchronously on the current stream (the caching host
allocator keeps the pinned block until the copy has run).  While a
program is traced (``torch.export``, ``torch.compile``: a dispatch mode
is active, or dynamo is compiling) it is the plain ``to``, so the graph
holds a constant, not a pinned buffer.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode


def to_device(data, device) -> torch.Tensor:
    """A numpy array or a CPU tensor -> the same values on ``device``,
    without a host sync on CUDA."""
    t = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data))
    device = torch.device(device)
    if (device.type != "cuda" or _get_current_dispatch_mode() is not None
            or torch.compiler.is_compiling()):
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
