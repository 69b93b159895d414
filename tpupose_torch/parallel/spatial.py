"""Row slabs and the conv halo exchange of the ``spatial`` mesh axis.

In JAX, XLA's SPMD partitioner inserts these exchanges; here the port
writes them.  Each rank of a spatial group holds a slab of the image's
rows (``mesh.slab_rows``: whole blocks of 8 rows, so the nets' three 2x2
pools stay inside a slab).  Before each conv with a kernel ``k > 1`` the
slab is extended by ``k // 2`` rows from the ranks above and below it; the
unchanged SAME conv runs on the extended slab and the extra rows of its
output are cropped.  At the image's top and bottom no rows are added, so
SAME's zero padding there is the unsharded conv's.

A slab can be thinner than the halo (8 input rows are 1 row at stride 8,
and a 7x7 conv needs 3), so the rows may come from ranks several steps
away: every rank contributes the first and the last ``k // 2`` rows of its
slab (zero-padded to ``k // 2``), one ``all_gather`` brings every rank's
bands, and each rank picks its halo rows out of them.  The backward
gathers every rank's halo gradients the same way and adds those of its own
rows.  Only ``all_gather`` is used: gloo has no ``reduce_scatter`` on CUDA
tensors, and ``torch.distributed.nn``'s autograd ``all_gather`` falls back
to ``all_to_all`` under gloo in its backward.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from tpupose_torch.models.cpm import ConvReLU
from tpupose_torch.parallel.mesh import SLAB_MULTIPLE, Mesh, slab_rows

POOLS = 3   # 2x2 pools in every net's stem: stage maps are at stride 8


class SpatialSlabs:
    """The slabs of one spatial group: this rank's ``index`` and every
    slab's input rows ``sizes``.  At a resolution 2^L below the input a
    slab has ``size >> L`` rows (every slab but the last is a multiple of
    8 rows, so the pools' floors add up to the unsharded one)."""

    def __init__(self, group, index: int, sizes: Sequence[int]):
        sizes = [int(n) for n in sizes]
        if any(n % SLAB_MULTIPLE for n in sizes[:-1]) or min(sizes) < 1:
            raise ValueError(f"slab rows {sizes}: every slab but the last "
                             f"must be a multiple of {SLAB_MULTIPLE}")
        self.group = group
        self.index = index
        self.sizes = sizes

    @classmethod
    def for_height(cls, mesh: Mesh, h: int) -> "SpatialSlabs":
        """The slabs ``slab_rows`` gives ``h`` rows over ``mesh``'s spatial
        axis."""
        return cls(mesh.spatial_group, mesh.coords[1],
                   [b - a for a, b in slab_rows(h, mesh.n_spatial)])

    @classmethod
    def gathered(cls, mesh: Mesh, rows: int, device) -> "SpatialSlabs":
        """The slabs of ``mesh``'s spatial group whose ranks hold ``rows``
        rows each, as they say (one ``all_gather`` of the counts)."""
        n = torch.tensor([rows], dtype=torch.int64, device=device)
        sizes = [torch.empty_like(n) for _ in range(mesh.n_spatial)]
        dist.all_gather(sizes, n, group=mesh.spatial_group)
        return cls(mesh.spatial_group, mesh.coords[1],
                   [int(t.item()) for t in sizes])

    def level_sizes(self, rows: int) -> List[int]:
        """Every slab's rows at the resolution where this rank's slab has
        ``rows`` rows."""
        for level in range(POOLS + 1):
            if self.sizes[self.index] >> level == rows:
                return [n >> level for n in self.sizes]
        raise ValueError(f"a slab of {self.sizes[self.index]} input rows "
                         f"has no resolution with {rows} rows")

    def offset(self, rows: int) -> int:
        """This slab's first row at the resolution where it has ``rows``."""
        return sum(self.level_sizes(rows)[:self.index])

    def _plan(self, rows: int, pad: int):
        """Indices into the gathered bands (S * 2 * pad rows) of the halo
        rows above and below this slab."""
        sizes = self.level_sizes(rows)
        offs = [sum(sizes[:q]) for q in range(len(sizes))]
        top = offs[self.index]
        bottom = top + sizes[self.index]
        total = sum(sizes)

        def src(g):
            q = max(i for i, o in enumerate(offs) if o <= g)
            local, n = g - offs[q], sizes[q]
            m = min(pad, n)
            if local >= n - m:          # in q's bottom band
                return q * 2 * pad + pad + local - (n - m)
            if local < m:               # in q's top band
                return q * 2 * pad + local
            raise AssertionError("halo row outside every band")

        above = [src(g) for g in range(max(0, top - pad), top)]
        below = [src(g) for g in range(bottom, min(total, bottom + pad))]
        return above, below

    def extend(self, x: torch.Tensor, dim: int,
               pad: int) -> Tuple[torch.Tensor, int]:
        """``x`` (this slab, rows on ``dim``) with ``pad`` halo rows from
        the neighbours above and below (fewer at the image's edges);
        returns ``(extended, rows added above)``.  Differentiable."""
        if len(self.sizes) == 1 or pad == 0:
            return x, 0
        above, below = self._plan(x.shape[dim], pad)
        ext = _HaloExchange.apply(x, self, dim, pad, above, below)
        return ext, len(above)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every slab's ``x`` concatenated on ``dim`` in row order (the
        whole image's rows on every rank of the group); not
        differentiable."""
        if len(self.sizes) == 1:
            return x
        sizes = self.level_sizes(x.shape[dim])
        most = max(sizes)
        if x.shape[dim] < most:
            shape = list(x.shape)
            shape[dim] = most - x.shape[dim]
            x = torch.cat([x, x.new_zeros(shape)], dim)
        parts = [torch.empty_like(x) for _ in sizes]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                         dim)


def _bands(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    """The first and the last ``min(pad, rows)`` rows of ``x``, each
    zero-padded to ``pad`` rows: ``2 * pad`` rows on ``dim``."""
    n = x.shape[dim]
    m = min(pad, n)
    parts = [x.narrow(dim, 0, m), None, x.narrow(dim, n - m, m), None]
    if m < pad:
        shape = list(x.shape)
        shape[dim] = pad - m
        zeros = x.new_zeros(shape)
        parts[1] = parts[3] = zeros
    return torch.cat([p for p in parts if p is not None], dim)


def _all_gather_cat(x: torch.Tensor, group, world: int,
                    dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _HaloExchange(torch.autograd.Function):
    """Slab -> slab with halo rows; the backward returns each halo row's
    gradient to the rank that owns the row."""

    @staticmethod
    def forward(ctx, x, slabs, dim, pad, above, below):
        world = len(slabs.sizes)
        bands = _all_gather_cat(_bands(x, dim, pad), slabs.group, world, dim)
        idx_a = torch.tensor(above, dtype=torch.long, device=x.device)
        idx_b = torch.tensor(below, dtype=torch.long, device=x.device)
        ctx.slabs, ctx.dim, ctx.pad = slabs, dim, pad
        ctx.rows = x.shape[dim]
        ctx.save_for_backward(idx_a, idx_b)
        return torch.cat([bands.index_select(dim, idx_a), x,
                          bands.index_select(dim, idx_b)], dim)

    @staticmethod
    def backward(ctx, grad):
        idx_a, idx_b = ctx.saved_tensors
        slabs, dim, pad, n = ctx.slabs, ctx.dim, ctx.pad, ctx.rows
        world = len(slabs.sizes)
        na, nb = idx_a.numel(), idx_b.numel()
        shape = list(grad.shape)
        shape[dim] = world * 2 * pad
        sent = grad.new_zeros(shape)
        sent.index_add_(dim, idx_a, grad.narrow(dim, 0, na))
        sent.index_add_(dim, idx_b, grad.narrow(dim, na + n, nb))
        got = _all_gather_cat(sent, slabs.group, world, dim)
        stride = world * 2 * pad
        mine = sum(got.narrow(dim, r * stride + slabs.index * 2 * pad,
                              2 * pad) for r in range(world))
        gx = grad.narrow(dim, na, n).clone()
        m = min(pad, n)
        gx.narrow(dim, 0, m).add_(mine.narrow(dim, 0, m))
        gx.narrow(dim, n - m, m).add_(mine.narrow(dim, pad, m))
        return gx, None, None, None, None, None


@contextlib.contextmanager
def spatial_halos(model: nn.Module, slabs: SpatialSlabs):
    """Inside, every ``ConvReLU`` of ``model`` whose conv has ``k > 1``
    runs on its input slab extended by ``k // 2`` halo rows and crops them
    from its output (forward hooks on the layer: the f32 route calls the
    ``nn.Conv2d``, the bf16 route ``F.conv2d`` with its weight, so the
    hooks sit on the layer that wraps both).  Activations are NCHW: rows
    are dim 2."""
    handles = []
    stacks = {}

    def pre(module, args):
        (x,) = args
        pad = module.conv.kernel_size[0] // 2
        ext, added = slabs.extend(x, 2, pad)
        stacks[module].append((added, x.shape[2]))
        return (ext,)

    def post(module, args, out):
        added, rows = stacks[module].pop()
        return out.narrow(2, added, rows)

    for module in model.modules():
        if isinstance(module, ConvReLU) and module.conv.kernel_size[0] > 1:
            stacks[module] = []
            handles.append(module.register_forward_pre_hook(pre))
            handles.append(module.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def spatial_forward(model: nn.Module, x: torch.Tensor, mesh: Mesh,
                    height: int):
    """``model`` (CocoPoseNet, FaceNet or HandNet) on this rank's slab
    ``x`` (B, rows, W, 3) of a ``height``-row input split by
    ``slab_rows`` over ``mesh``'s spatial axis: the stacked stage maps of
    this slab's rows (the unsharded forward's, sliced)."""
    with spatial_halos(model, SpatialSlabs.for_height(mesh, height)):
        return model(x)
