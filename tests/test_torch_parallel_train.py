"""The port's meshed train and eval steps, loader and train CLI on the CPU,
over gloo ranks, against one process on the whole batch and against the
JAX package's meshed step.

Two rank groups run every multi-process check once: two ranks (the 2x1
and 1x2 meshes, the train CLI) and four (the 2x2 mesh).  Each rank runs
this file as a script, one torch thread each, without JAX; the JAX step
runs here, on the 8 virtual CPU devices ``tests/conftest.py`` gives it.
CocoPoseNet has 2 stages at insize 32, B = 2 (32 rows split as 16 + 16:
2 rows a slab at stride 8).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_parallel import rank_main, run_ranks

STAGES = 2
INSIZE = 32
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _cfg():
    from tpupose_torch.config import TrainConfig

    return TrainConfig(insize=INSIZE, max_persons=2, stem_freeze_steps=1)


def _arrays(step: int, b: int = 2):
    """Batch ``step``: u8 images, two-person pose tables (one person
    partly labelled), and an ignore mask with a band across the slab
    boundary."""
    rng = np.random.RandomState(100 + step)
    poses = np.zeros((b, 2, 18, 3), np.float32)
    poses[:, :, :, :2] = rng.uniform(1, INSIZE - 2, (b, 2, 18, 2))
    poses[:, 0, :, 2] = 2
    poses[:, 1, :, 2] = (rng.rand(b, 18) < 0.5) * 2
    mask = np.zeros((b, INSIZE, INSIZE), bool)
    mask[:, 12:20, 4:14] = True
    imgs = rng.randint(0, 256, (b, INSIZE, INSIZE, 3)).astype(np.uint8)
    return imgs, poses, mask


def _batch(step: int):
    from tpupose_torch.train.trainer import TrainBatch

    return TrainBatch(*map(torch.from_numpy, _arrays(step)))


def _model():
    from tpupose_torch.models import CocoPoseNet

    return CocoPoseNet(num_stages=STAGES, seed=7)


def _params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _mesh_run(mesh):
    """STEPS meshed steps and the eval step; on rank 0 also one process on
    the same global batches: losses, the largest parameter difference,
    this rank's parameters' bytes digest, and the eval losses."""
    import hashlib

    from tpupose_torch.train import (init_train_state, make_eval_step,
                                     make_train_step)

    cfg = _cfg()
    state = init_train_state(_model(), cfg, device="cpu", mesh=mesh)
    step = make_train_step(cfg, mesh=mesh)
    losses = []
    for i in range(STEPS):
        state, m = step(state, _batch(i))
        losses.append([float(m[k]) for k in ("loss", "paf", "heat")])
    params = _params(state.model)
    out = {"losses": losses,
           "digest": hashlib.sha256(params.numpy().tobytes()).hexdigest(),
           "eval": float(make_eval_step(cfg, mesh=mesh)(
               state.model, _batch(9))["loss"])}
    if mesh.rank == 0:
        ref = init_train_state(_model(), cfg, device="cpu")
        ref_step = make_train_step(cfg)
        ref_losses = []
        for i in range(STEPS):
            ref, rm = ref_step(ref, _batch(i))
            ref_losses.append([float(rm[k])
                               for k in ("loss", "paf", "heat")])
        out.update(
            ref_losses=ref_losses,
            param_err=(params - _params(ref.model)).abs().max().item(),
            param_scale=_params(ref.model).abs().max().item(),
            ref_eval=float(make_eval_step(cfg)(ref.model,
                                               _batch(9))["loss"]))
    return out


def _remat(mesh):
    """One meshed step with ``cfg.remat`` (the forward, halo exchanges
    included, recomputed in the backward) against one without: (loss
    pair, the largest gradient difference)."""
    from tpupose_torch.train import init_train_state, make_train_step

    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(_cfg(), remat=remat)
        state = init_train_state(_model(), cfg, device="cpu", mesh=mesh)
        state, m = make_train_step(cfg, mesh=mesh)(state, _batch(0))
        runs.append((float(m["loss"]), torch.cat(
            [p.grad.reshape(-1) for p in state.model.parameters()])))
    return ((runs[0][0], runs[1][0]),
            (runs[0][1] - runs[1][1]).abs().max().item())


def _cli(rank, outdir):
    from tpupose_torch.apps import train_cli

    out = os.path.join(outdir, f"cli_rank{rank}")
    train_cli.main(["--synthetic", "--test", "--n_data", "2", "--device",
                    "cpu", "--insize", str(INSIZE), "-B", "2", "-b", "2",
                    "--iteration", "2", "--out", out])
    return sorted(os.listdir(out)) if os.path.isdir(out) else None


def _checks(rank, world):
    import sys

    from tpupose_torch.parallel import make_mesh

    out = {}
    if world == 2:
        out["2x1"] = _mesh_run(make_mesh(2, 1, device="cpu"))
        mesh = make_mesh(1, 2, device="cpu")
        out["1x2"] = _mesh_run(mesh)
        out["remat"] = _remat(mesh)
        out["cli"] = _cli(rank, sys.argv[4])
    else:
        out["2x2"] = _mesh_run(make_mesh(2, 2, device="cpu"))
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The two rank groups, one after the other (fewer processes at once
    beside the other test workers)."""
    return [run_ranks(os.path.abspath(__file__), world,
                      str(tmp_path_factory.mktemp(f"train_{world}")))
            for world in (2, 4)]


@pytest.fixture(scope="module")
def ranks2(groups):
    return groups[0]


@pytest.fixture(scope="module")
def ranks4(groups):
    return groups[1]


def _runs(ranks2, ranks4, mesh):
    return [r[mesh] for r in (ranks4 if mesh == "2x2" else ranks2)]


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
def test_meshed_steps_equal_one_process(ranks2, ranks4, mesh):
    """Each step's loss, PAF and heatmap sums within rtol 1e-6 of one
    process on the whole batch (summation order differs), and the
    parameters after the steps within 1e-6 x max |p| (rank 0's; the
    other ranks' equal them, below)."""
    run = _runs(ranks2, ranks4, mesh)[0]
    np.testing.assert_allclose(run["losses"], run["ref_losses"], rtol=1e-6)
    assert run["param_err"] <= 1e-6 * run["param_scale"]


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
def test_parameters_equal_on_every_rank(ranks2, ranks4, mesh):
    runs = _runs(ranks2, ranks4, mesh)
    assert len({run["digest"] for run in runs}) == 1
    assert len({tuple(map(tuple, run["losses"])) for run in runs}) == 1


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
def test_meshed_eval_step_equals_one_process(ranks2, ranks4, mesh):
    runs = _runs(ranks2, ranks4, mesh)
    assert len({run["eval"] for run in runs}) == 1
    np.testing.assert_allclose(runs[0]["eval"], runs[0]["ref_eval"],
                               rtol=1e-6)


def test_remat_on_a_spatial_mesh_equals_the_plain_step(ranks2):
    """``cfg.remat`` recomputes the forward, its halo exchanges too, in the
    backward: the same loss and gradients, bit for bit, on a 1x2 mesh."""
    for res in ranks2:
        (plain, remat), grad_err = res["remat"]
        assert plain == remat and grad_err == 0.0


def test_meshed_step_matches_jax_meshed_step(ranks4):
    """The port's 2x2 step against JAX's ``make_train_step(mesh=
    make_mesh(2, 2))`` from the same parameters on the same batch: the
    first step's loss at rtol 1e-5 (as ``test_train.py``'s sharded step
    against one device)."""
    import jax
    import jax.numpy as jnp

    from tpupose.config import TrainConfig as JaxTrainConfig
    from tpupose.models import CocoPoseNet as JaxCocoPoseNet
    from tpupose.parallel import make_mesh as jax_make_mesh
    from tpupose.train import trainer as jtr
    from tpupose_torch.weights import flax_params_from_model

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    jcfg = JaxTrainConfig(**dataclasses.asdict(_cfg()))
    jmodel = JaxCocoPoseNet(num_stages=STAGES)
    state, tx = jtr.init_train_state(
        jmodel, jcfg, params=flax_params_from_model(_model()),
        insize=INSIZE)
    step = jtr.make_train_step(jmodel, tx, jcfg, mesh=jax_make_mesh(2, 2),
                               donate=False)
    _, metrics = step(state, jtr.TrainBatch(*map(jnp.asarray, _arrays(0))))
    for run in ranks4:
        np.testing.assert_allclose(run["2x2"]["losses"][0][0],
                                   float(metrics["loss"]), rtol=1e-5)


def test_train_cli_over_two_ranks_writes_on_rank_zero_only(ranks2):
    """``train_cli.main([... "--n_data", "2"])`` in each of two gloo
    processes (no torchrun: the process group exists): two synthetic
    steps; rank 0 writes the log, params, snapshot and npz exports, rank 1
    writes nothing."""
    files = ranks2[0]["cli"]
    for name in ("log", "params.json", "ckpt", "posenet_final.npz"):
        assert name in files, files
    assert ranks2[1]["cli"] is None


# ---------------------------------------------------------------------------
# in-process: the GT slab, the loader's shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [(0, 3), (3, 5), (4, 5)])
def test_gt_render_of_a_slab_is_the_full_render_sliced(rows):
    from tpupose_torch.data.gt import render_heatmaps_at, render_labels_at

    _, poses, _ = _arrays(0)
    poses = torch.from_numpy(poses)
    out_hw = (5, 6)
    pafs, heat = render_labels_at(poses, 40, 48, out_hw, 7.0, 8.0)
    spafs, sheat = render_labels_at(poses, 40, 48, out_hw, 7.0, 8.0,
                                    out_rows=rows)
    # atol as the renderers' JAX parity tests (test_torch_train.py): the
    # slab's matmuls have other shapes
    torch.testing.assert_close(spafs, pafs[:, :, rows[0]:rows[1]],
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(sheat, heat[:, :, rows[0]:rows[1]],
                               rtol=0, atol=1e-5)
    shm = render_heatmaps_at(poses, 40, 48, out_hw, 7.0, out_rows=rows)
    torch.testing.assert_close(shm, heat[:, :, rows[0]:rows[1]], rtol=0,
                               atol=1e-5)


class _Indexed:
    """A dataset whose sample ``i`` carries ``i`` in every pixel."""

    cfg = None

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def sample(self, i):
        img = np.full((16, 8, 3), i, np.uint8)
        img[:, :, 1] = np.arange(16)[:, None]
        return img, np.full((1, 18, 3), i, np.float32), np.zeros((16, 8),
                                                                  bool)


@pytest.mark.parametrize("repeat", [True, False])
def test_meshed_loader_shards_union_to_the_one_process_batches(repeat):
    """Every rank of a 2x2 grid with the same seed: its data rank's
    samples of each global batch and its slab of the rows; the union over
    the ranks is the one-process batch.  Without repeat, a final partial
    batch that the data axis does not divide is dropped (11 samples, B = 4:
    two batches and a dropped tail of 3)."""
    from tpupose_torch.data.loader import BatchLoader
    from tpupose_torch.parallel import Mesh

    ds = _Indexed(11)
    n = 4 if repeat else 3
    one = BatchLoader(ds, 4, max_persons=1, repeat=repeat, seed=5)
    want = [b for _, b in zip(range(n), one)]
    one.close()
    got = {}
    for rank in range(4):
        mesh = Mesh(n_data=2, n_spatial=2, rank=rank,
                    coords=divmod(rank, 2), device=torch.device("cpu"))
        loader = BatchLoader(ds, 4, max_persons=1, repeat=repeat, seed=5,
                             mesh=mesh)
        got[rank] = [b for _, b in zip(range(n), loader)]
        loader.close()
    if not repeat:
        assert len(want) == 3 and all(len(g) == 2 for g in got.values())
        want = want[:2]
    for i, batch in enumerate(want):
        parts = [got[r][i] for r in range(4)]
        assert all(p.sharded for p in parts)
        for key in ("imgs", "ignore_mask"):
            rows = [torch.cat([getattr(parts[2 * d], key),
                               getattr(parts[2 * d + 1], key)], dim=1)
                    for d in range(2)]
            torch.testing.assert_close(torch.cat(rows), getattr(batch, key))
        torch.testing.assert_close(
            torch.cat([parts[0].poses, parts[2].poses]), batch.poses)


def test_meshed_loader_refuses_a_batch_the_data_axis_does_not_divide():
    from tpupose_torch.data.loader import BatchLoader
    from tpupose_torch.parallel import Mesh

    mesh = Mesh(n_data=2, n_spatial=1, rank=0, coords=(0, 0),
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split"):
        BatchLoader(_Indexed(8), 3, max_persons=1, mesh=mesh)


if __name__ == "__main__":
    rank_main(_checks)
