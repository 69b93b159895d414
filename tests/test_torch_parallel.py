"""The port's process mesh (``tpupose_torch/parallel``) on the CPU: mesh
shapes, ``shard_batch`` layouts, ``slab_rows``, and the halo exchange's
forward and backward against the unsharded conv stack, over gloo ranks.

One group of three rank processes runs every multi-process check once (a
process takes ~4 s to start here); each test function reads its part of
the ranks' results.  The ranks run this file as a script, one torch thread
each, and import no JAX.  ``run_ranks`` is shared with the other
``test_torch_parallel_*`` files.
"""

import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(script: str, world: int, outdir: str):
    """Start ``script rank world port outdir`` as ``world`` processes (one
    torch thread each); ``finish_ranks`` collects them."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(port), outdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(world)]
    return procs, outdir


def finish_ranks(started, timeout: float = 300.0):
    """Each rank's pickled result (``outdir/rank<r>.pkl``); fails with a
    rank's output when it exits non-zero or the group outlasts
    ``timeout``."""
    procs, outdir = started
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    results = []
    for r in range(len(procs)):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def run_ranks(script: str, world: int, outdir: str, timeout: float = 300.0):
    """``start_ranks`` and ``finish_ranks``."""
    return finish_ranks(start_ranks(script, world, outdir), timeout)


def rank_main(checks) -> None:
    """A rank's entry point: gloo over ``argv``'s port, ``checks(rank,
    world)``, its dict pickled to ``outdir/rank<r>.pkl``."""
    rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from tpupose_torch.parallel import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                           timeout=120)
    result = checks(rank, world)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


# ---------------------------------------------------------------------------
# the ranks' checks
# ---------------------------------------------------------------------------


class _Stack(torch.nn.Module):
    """A conv stack with every kernel size and pool the nets use: 3x3 at
    full resolution, a pool, 3x3, a pool, 3x3, a pool, two 7x7 and a 1x1
    at stride 8 (float64, so sharded and unsharded agree to ~1e-15)."""

    def __init__(self):
        super().__init__()
        from tpupose_torch.models.cpm import ConvReLU

        torch.manual_seed(0)
        self.a = ConvReLU(3, 4, 3)
        self.b = ConvReLU(4, 4, 3)
        self.c = ConvReLU(4, 4, 7)
        self.d = ConvReLU(4, 4, 7)
        self.e = ConvReLU(4, 2, 1, relu=False)
        self.double()

    def forward(self, x):
        from tpupose_torch.models.cpm import max_pool_2x2

        x = x.permute(0, 3, 1, 2)
        x = max_pool_2x2(self.a(x))
        x = max_pool_2x2(self.b(x))
        x = max_pool_2x2(self.b(x))
        return self.e(self.d(self.c(x))).permute(0, 2, 3, 1)


def _halo_case(slabs, h: int, rows):
    """The stack on this rank's slab ``rows`` of a (2, h, 13, 3) input,
    forward and backward: (max |out - unsharded rows|, max |grad - unsharded
    grad| after summing the ranks' gradients over the group)."""
    import torch.distributed as dist

    from tpupose_torch.parallel import spatial_halos

    net = _Stack()
    gen = torch.Generator().manual_seed(h)
    x = torch.randn(2, h, 13, 3, dtype=torch.float64, generator=gen)
    ref = net(x)
    w = torch.randn(ref.shape, dtype=torch.float64, generator=gen)
    (ref * w).sum().backward()
    ref_grads = [p.grad.clone() for p in net.parameters()]
    net.zero_grad()
    with spatial_halos(net, slabs):
        out = net(x[:, rows[0]:rows[1]])
    first = slabs.offset(out.shape[1])
    want = ref[:, first:first + out.shape[1]]
    (out * w[:, first:first + out.shape[1]]).sum().backward()
    grad_err = 0.0
    for p, g in zip(net.parameters(), ref_grads):
        dist.all_reduce(p.grad, group=slabs.group)
        grad_err = max(grad_err, (p.grad - g).abs().max().item())
    return (out - want).abs().max().item(), grad_err, out.shape[1]


def _checks(rank, world):
    import torch.distributed as dist

    from tpupose_torch.parallel import SpatialSlabs, make_mesh, slab_rows

    out = {}
    # make_mesh: shapes, coordinates, the default, refusals
    mesh = make_mesh(1, world, device="cpu")
    out["mesh_1x3"] = (mesh.shape, mesh.coords, mesh.grid.tolist())
    mesh_d = make_mesh(device="cpu")
    out["mesh_default"] = (mesh_d.shape, mesh_d.coords)
    refused = []
    for nd, ns in ((2, 2), (world + 1, 1), (2, 1)):
        try:
            make_mesh(nd, ns, device="cpu")
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    # all_reduce over the world and over a group of two
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    pair = dist.new_group([0, 1])
    u = torch.tensor([float(rank + 1)])
    if rank < 2:
        dist.all_reduce(u, group=pair)
    out["all_reduce"] = (t.item(), u.item())
    # the halo exchange over 3 ranks: 24 rows (a 1-row slab each at stride
    # 8, the 7x7 convs' halo from two ranks away) and 40 rows (16 + 16 + 8)
    for h in (24, 40):
        rows = slab_rows(h, world)[rank]
        out[f"halo3_{h}"] = _halo_case(
            SpatialSlabs.for_height(mesh, h), h, rows)
    # spatial_forward: the three nets (2 stages) on 24 rows, a 1-row slab
    # each at stride 8, against their unsharded forwards
    from tpupose_torch.models import CocoPoseNet, FaceNet, HandNet
    from tpupose_torch.parallel import spatial_forward

    x = torch.rand(1, 24, 16, 3, generator=torch.Generator().manual_seed(4))
    rows = slab_rows(24, world)[rank]
    for net in (CocoPoseNet, FaceNet, HandNet):
        model = net(num_stages=2, seed=3).eval()
        with torch.no_grad():
            ref, got = model(x), spatial_forward(
                model, x[:, rows[0]:rows[1]], mesh, 24)
        ref, got = (ref, got) if isinstance(ref, tuple) else ((ref,), (got,))
        out[f"forward_{net.__name__}"] = max(
            (g - r[:, :, rank:rank + 1]).abs().max().item()
            / r.abs().max().item() for g, r in zip(got, ref))
    # over 2 ranks: 40 rows as 24 + 16, and 16 rows as 8 + 8
    for h in (40, 16):
        if rank < 2:
            sizes = [b - a for a, b in slab_rows(h, 2)]
            out[f"halo2_{h}"] = _halo_case(
                SpatialSlabs(pair, rank, sizes), h, slab_rows(h, 2)[rank])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(os.path.abspath(__file__), WORLD,
                     str(tmp_path_factory.mktemp("parallel_ranks")))


# ---------------------------------------------------------------------------
# in-process: slab_rows, shard_batch, the 1x1 mesh
# ---------------------------------------------------------------------------


def _mesh(n_data, n_spatial, rank):
    from tpupose_torch.parallel import Mesh

    return Mesh(n_data=n_data, n_spatial=n_spatial, rank=rank,
                coords=divmod(rank, n_spatial), device=torch.device("cpu"))


@pytest.mark.parametrize("h, n, want", [
    (40, 2, [(0, 24), (24, 40)]),
    (368, 2, [(0, 184), (184, 368)]),
    (368, 4, [(0, 96), (96, 192), (192, 280), (280, 368)]),
    (24, 3, [(0, 8), (8, 16), (16, 24)]),
    (30, 3, [(0, 8), (8, 16), (16, 30)]),
    (16, 1, [(0, 16)]),
])
def test_slab_rows(h, n, want):
    from tpupose_torch.parallel import slab_rows

    got = slab_rows(h, n)
    assert got == want
    assert all((b - a) % 8 == 0 for a, b in got[:-1])


@pytest.mark.parametrize("h, n", [(8, 2), (15, 2), (40, 6)])
def test_slab_rows_refuses_fewer_blocks_than_slabs(h, n):
    from tpupose_torch.parallel import slab_rows

    with pytest.raises(ValueError, match="too few"):
        slab_rows(h, n)


def test_shard_batch_layouts():
    """Each rank of a 2x2 grid holds (B/2, its slab's rows, W, 3) of
    ``imgs`` and ``ignore_mask`` and (B/2, P, 18, 3) of ``poses``; the
    union over the ranks is the batch."""
    from tpupose_torch.parallel import shard_batch

    rng = np.random.RandomState(0)
    batch = {"imgs": rng.randint(0, 255, (8, 40, 16, 3)).astype(np.uint8),
             "poses": rng.rand(8, 4, 18, 3).astype(np.float32),
             "ignore_mask": rng.rand(8, 40, 16) > 0.5}
    parts = [shard_batch(batch, _mesh(2, 2, r)) for r in range(4)]
    assert parts[0]["imgs"].shape == (4, 24, 16, 3)
    assert parts[1]["imgs"].shape == (4, 16, 16, 3)
    assert parts[3]["ignore_mask"].shape == (4, 16, 16)
    assert parts[2]["poses"].shape == (4, 4, 18, 3)
    for key in ("imgs", "ignore_mask"):
        rows = [np.concatenate([parts[2 * d][key], parts[2 * d + 1][key]],
                               axis=1) for d in range(2)]
        np.testing.assert_array_equal(np.concatenate(rows), batch[key])
    np.testing.assert_array_equal(
        np.concatenate([parts[0]["poses"], parts[2]["poses"]]),
        batch["poses"])
    np.testing.assert_array_equal(parts[0]["poses"], parts[1]["poses"])


def test_shard_batch_of_a_train_batch_is_marked_sharded():
    from tpupose_torch.parallel import shard_batch
    from tpupose_torch.train.trainer import TrainBatch

    batch = TrainBatch(torch.zeros(4, 32, 32, 3, dtype=torch.uint8),
                       torch.zeros(4, 2, 18, 3),
                       torch.zeros(4, 32, 32, dtype=torch.bool))
    part = shard_batch(batch, _mesh(2, 2, 3))
    assert part.sharded and not batch.sharded
    assert tuple(part.imgs.shape) == (2, 16, 32, 3)
    assert tuple(part.poses.shape) == (2, 2, 18, 3)
    assert tuple(part.ignore_mask.shape) == (2, 16, 32)


def test_shard_batch_refuses_a_batch_the_data_axis_does_not_divide():
    from tpupose_torch.parallel import shard_batch

    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"imgs": np.zeros((3, 16, 16, 3))}, _mesh(2, 1, 0))


def test_mesh_without_a_process_group_is_1x1():
    from tpupose_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "spatial": 1}
    assert mesh.coords == (0, 0) and not mesh.distributed
    with pytest.raises(ValueError, match="needs more than the 1"):
        make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="needs more than the 1"):
        make_mesh(1, 2, device="cpu")


def test_cuda_mesh_and_init_raise_without_cuda():
    from tpupose_torch.parallel import initialize_distributed, make_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_distributed("127.0.0.1:1", 1, 0)


def test_mesh_backend_must_be_the_process_groups():
    from tpupose_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="backend is None"):
        make_mesh(device="cpu", backend="nccl")


# ---------------------------------------------------------------------------
# the rank group
# ---------------------------------------------------------------------------


def test_make_mesh_shapes_over_three_ranks(ranks):
    for r, res in enumerate(ranks):
        shape, coords, grid = res["mesh_1x3"]
        assert shape == {"data": 1, "spatial": 3}
        assert coords == (0, r) and grid == [[0, 1, 2]]
        assert res["mesh_default"] == ({"data": 3, "spatial": 1}, (r, 0))


def test_make_mesh_refuses_a_grid_the_world_does_not_fill(ranks):
    for res in ranks:
        assert len(res["refused"]) == 3
        assert "needs more than the 3" in res["refused"][0]
        assert "needs more than the 3" in res["refused"][1]
        assert "outside the grid" in res["refused"][2]


def test_multi_process_initialize_distributed_all_reduce(ranks):
    """Three processes join through ``initialize_distributed``; an
    all_reduce crosses the process boundary over the world and over a
    group of two (the counterpart of
    ``test_parallel.py::test_two_process_distributed_psum``)."""
    for r, res in enumerate(ranks):
        world_sum, pair_sum = res["all_reduce"]
        assert world_sum == 6.0
        assert pair_sum == (3.0 if r < 2 else r + 1)


@pytest.mark.parametrize("net", ["CocoPoseNet", "FaceNet", "HandNet"])
def test_spatial_forward_of_each_net_matches_its_unsharded_rows(ranks, net):
    """``spatial_forward`` runs each net (2 stages) on a 1-row-at-stride-8
    slab of 24 rows through the same modules; every stage's maps within
    1e-5 x max|ref| of the unsharded forward's row (float32 convs on
    other row extents sum in other orders)."""
    for res in ranks:
        assert res[f"forward_{net}"] <= 1e-5


@pytest.mark.parametrize("case", ["halo3_24", "halo3_40", "halo2_40",
                                  "halo2_16"])
def test_halo_exchange_matches_the_unsharded_stack(ranks, case):
    """Forward rows and summed gradients of the sharded stack equal the
    unsharded ones (float64), over 3 and 2 ranks; ``halo3_24`` and
    ``halo2_16`` have 1-row slabs at stride 8, so a 7x7 conv's halo comes
    from ranks two steps away."""
    world = 3 if case.startswith("halo3") else 2
    rows = []
    for res in ranks[:world]:
        out_err, grad_err, n = res[case]
        assert out_err < 1e-12
        assert grad_err < 1e-11
        rows.append(n)
    if case in ("halo3_24", "halo2_16"):
        assert rows == [1] * world


if __name__ == "__main__":
    rank_main(_checks)
