"""The (data, spatial) process mesh (port of ``tpupose/parallel/mesh.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` of devices
and lets XLA's SPMD partitioner insert the collectives.  The port follows
PyTorch's idiom instead: one process (rank) per card, ``torch.distributed``
between them, NCCL on CUDA and gloo on the CPU.  Every rank calls the same
entry point with the same arguments and gets the same result as the
mesh-less call, which is what JAX's single program over a mesh returns.

The ranks form an ``(n_data, n_spatial)`` grid, row-major like JAX's
``devices.reshape(n_data, n_spatial)``; rank ``d * n_spatial + s`` sits
at coordinates ``(d, s)``.

* ``data``: the batch axis.  Each data rank takes ``B / n_data`` samples;
  gradients are summed over every rank.
* ``spatial``: the image-height axis.  Each spatial rank takes a slab of
  rows (``slab_rows``), and the convs exchange halo rows with their
  neighbours (``tpupose_torch/parallel/spatial.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

# Arrays whose axis 1 is image height (split over 'spatial' too);
# everything else splits on the batch axis only.
SPATIAL_KEYS = ("imgs", "ignore_mask")

# Rows of a slab are a multiple of this: the nets' three 2x2 pools never
# straddle a slab boundary.
SLAB_MULTIPLE = 8


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cuda",
                           timeout: Optional[float] = None) -> None:
    """``dist.init_process_group`` for this process.

    ``coordinator_address`` (``host:port`` or ``tcp://host:port``), the
    world size and this process's rank, as ``jax.distributed.initialize``
    takes them; when all three are None the ``env://`` variables that
    ``torchrun`` sets are read.  The backend is ``backend`` when given,
    else NCCL for a CUDA ``device`` and gloo for the CPU.  A CUDA device
    without CUDA raises; nothing falls back to the CPU.  ``timeout``:
    seconds a collective may wait (the backend's default when None).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed(device='cuda'): CUDA is "
                           "not available (pass device='cpu' for gloo on "
                           "the CPU)")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if coordinator_address is None:
        kwargs["init_method"] = "env://"
    else:
        if "://" not in coordinator_address:
            coordinator_address = f"tcp://{coordinator_address}"
        kwargs["init_method"] = coordinator_address
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if backend == "nccl":
        local = int(os.environ.get(
            "LOCAL_RANK", process_id if process_id is not None else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, **kwargs)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the ``(n_data, n_spatial)`` grid: its
    coordinates ``(d, s)``, its device and one process group per axis
    (``data_group``: the ranks sharing ``s``; ``spatial_group``: the ranks
    sharing ``d``).  A mesh without a process group is 1x1 and its groups
    are None."""

    n_data: int
    n_spatial: int
    rank: int
    coords: Tuple[int, int]
    device: torch.device
    data_group: Optional[object] = None
    spatial_group: Optional[object] = None

    @property
    def shape(self):
        return {DATA_AXIS: self.n_data, SPATIAL_AXIS: self.n_spatial}

    @property
    def grid(self) -> np.ndarray:
        """The ranks, (n_data, n_spatial)."""
        return np.arange(self.n_data * self.n_spatial).reshape(
            self.n_data, self.n_spatial)

    @property
    def distributed(self) -> bool:
        return self.data_group is not None


def _mesh_device(device, rank: int) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda'): CUDA is not "
                           "available (pass device='cpu')")
    if device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              device="cuda", backend: Optional[str] = None) -> Mesh:
    """Build the (data, spatial) mesh over every rank of the default
    process group; ``n_data`` defaults to ``world // n_spatial``.

    A grid larger than the world raises ``ValueError`` (as JAX's does for
    devices), and so does one smaller than it: a rank outside the grid
    would have no part of the work.  A process with no process group has
    a world of one and gets a 1x1 mesh.  ``backend``, when given, must be
    the process group's.  Every rank must call this in the same order: it
    creates every axis group on every rank (``dist.new_group``)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n_data is None:
        n_data = world // n_spatial
    if n_data < 1 or n_spatial < 1:
        raise ValueError(f"mesh {n_data}x{n_spatial}: both axes need at "
                         "least one rank")
    if n_data * n_spatial > world:
        raise ValueError(
            f"mesh {n_data}x{n_spatial} needs more than the {world} "
            "available processes")
    if n_data * n_spatial < world:
        raise ValueError(
            f"mesh {n_data}x{n_spatial} leaves ranks of the {world}-process "
            "world outside the grid")
    if backend is not None:
        have = dist.get_backend() if initialized else None
        if have != backend:
            raise RuntimeError(f"make_mesh(backend={backend!r}): the "
                               f"process group's backend is {have!r}")
    device = _mesh_device(device, rank)
    d, s = divmod(rank, n_spatial)
    data_group = spatial_group = None
    if initialized:
        grid = np.arange(world).reshape(n_data, n_spatial)
        for col in range(n_spatial):
            g = dist.new_group(grid[:, col].tolist())
            if col == s:
                data_group = g
        for row in range(n_data):
            g = dist.new_group(grid[row].tolist())
            if row == d:
                spatial_group = g
    return Mesh(n_data=n_data, n_spatial=n_spatial, rank=rank,
                coords=(d, s), device=device, data_group=data_group,
                spatial_group=spatial_group)


def slab_rows(h: int, n_spatial: int) -> List[Tuple[int, int]]:
    """Split ``h`` rows into ``n_spatial`` slabs ``[(start, stop), ...]``
    of whole blocks of 8 rows, as even as the blocks allow (40 rows over 2:
    24 + 16); rows past the last whole block go to the last slab.  Raises
    ``ValueError`` when there are fewer blocks than slabs."""
    blocks = h // SLAB_MULTIPLE
    if blocks < n_spatial:
        raise ValueError(f"{h} rows hold {blocks} blocks of "
                         f"{SLAB_MULTIPLE}: too few for {n_spatial} slabs")
    base, extra = divmod(blocks, n_spatial)
    sizes = [(base + (i < extra)) * SLAB_MULTIPLE for i in range(n_spatial)]
    sizes[-1] += h - blocks * SLAB_MULTIPLE
    bounds, start = [], 0
    for size in sizes:
        bounds.append((start, start + size))
        start += size
    return bounds


def data_part(n: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's ``[start, stop)`` of ``n`` samples split over
    ``data``; raises ``ValueError`` when ``n_data`` does not divide ``n``."""
    if n % mesh.n_data:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.n_data} data ranks")
    per = n // mesh.n_data
    return mesh.coords[0] * per, (mesh.coords[0] + 1) * per


def shard_batch(batch, mesh: Mesh, spatial_keys=SPATIAL_KEYS):
    """This rank's part of a host batch: a dict of arrays, or a
    ``TrainBatch`` (returned with ``sharded=True``).  Every array is split
    on the batch axis over ``data``; those under ``spatial_keys`` (with
    ``ndim >= 3``: (B, H, ...) image-likes) also have their rows split
    over ``spatial`` by ``slab_rows``.  Other arrays, such as the
    (B, P, 18, 3) pose tables, whose axis 1 is persons, split on the batch
    axis only."""

    def part(key, x):
        b0, b1 = data_part(x.shape[0], mesh)
        x = x[b0:b1]
        if key in spatial_keys and x.ndim >= 3:
            r0, r1 = slab_rows(x.shape[1], mesh.n_spatial)[mesh.coords[1]]
            x = x[:, r0:r1]
        return x

    if dataclasses.is_dataclass(batch):
        arrays = {f.name: getattr(batch, f.name)
                  for f in dataclasses.fields(batch)
                  if hasattr(getattr(batch, f.name), "shape")}
        return dataclasses.replace(
            batch, sharded=True, **{k: part(k, v) for k, v in arrays.items()})
    return {k: part(k, v) for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 to every
    rank (the counterpart of the JAX package's ``replicated`` sharding);
    a mesh without a process group leaves them as they are."""
    if mesh.distributed:
        for t in module.state_dict().values():
            dist.broadcast(t, src=0)
    return module


def all_gather_list(items: list, group) -> list:
    """Concatenate every rank's list of picklable ``items`` over ``group``
    in rank order (``items`` itself without a group)."""
    if group is None:
        return list(items)
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, items, group=group)
    return [x for part in out for x in part]
