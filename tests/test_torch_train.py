"""The port's training path (``tpupose_torch.data.gt``, ``train.loss``,
``train.optimizer``, ``train.trainer``, the models' compute ``dtype``)
against the JAX package's, on the CPU, from the same numpy-seeded inputs.

Tolerances: GT maps atol 1e-5 (float32 exp and matmul orders); losses on
equal predictions rtol 1e-6 of JAX's loss evaluated in float64 on the same
float32 inputs (JAX's eager float32 mean on the CPU is itself 1.3e-6 off
that value at these sizes and 1.7e-5 at full size; torch's is 1.4e-7), and
rtol 1e-5 of JAX's float32 loss; optimizer updates rtol 1e-6, atol 1e-10; a
full step's loss rtol 1e-4 and each gradient leaf within 1e-3 x its max
|g|, both of JAX's step evaluated in float64 (see ``full_step``); bf16
forwards within 2.5e-2 x max |ref| of JAX's bf16 forward; the bf16 loss
trajectory within rtol 0.05 of f32 (the JAX package's own bound) and its
first loss within rtol 2e-2 of JAX's bf16 loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpupose.config import TrainConfig as JaxTrainConfig
from tpupose.data import gt as jgt
from tpupose.models import ARCHS as JAX_ARCHS
from tpupose.train import loss as jloss
from tpupose.train import optimizer as jopt
from tpupose.train import trainer as jtr
from tpupose_torch.config import TrainConfig
from tpupose_torch.data import gt as tgt
from tpupose_torch.models import ARCHS
from tpupose_torch.models import cpm
from tpupose_torch.train import loss as tloss
from tpupose_torch.train import optimizer as topt
from tpupose_torch.train import trainer as ttr
from tpupose_torch.weights import (flax_params_from_model,
                                   flax_params_from_state_dict)

KEYPOINTS = {"posenet": 18, "facenet": 70, "handnet": 21}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _jax_cfg(cfg: TrainConfig) -> JaxTrainConfig:
    return JaxTrainConfig(**dataclasses.asdict(cfg))


def _random_poses(rng, lead, p, k, h, w, visible_p=0.8):
    poses = np.zeros((*lead, p, k, 3), np.float32)
    poses[..., 0] = rng.uniform(0, w - 1, (*lead, p, k))
    poses[..., 1] = rng.uniform(0, h - 1, (*lead, p, k))
    poses[..., 2] = (rng.uniform(size=(*lead, p, k)) < visible_p) * 2
    return poses


def _planted_limb_poses():
    """(2, 3, 18, 3): an axis-aligned limb overlapped by another person's
    (the nonzero-count quirk), a zero-length limb, an empty row."""
    poses = _random_poses(np.random.RandomState(4), (2,), 3, 18, 40, 48)
    poses[0, 0, 1] = (20, 5, 2)    # neck
    poses[0, 0, 8] = (20, 30, 2)   # right waist: limb 0 straight down
    poses[0, 1, 1] = (22, 5, 2)
    poses[0, 1, 8] = (18, 30, 2)
    poses[1, 0, 1] = (10, 10, 2)
    poses[1, 0, 8] = (10, 10, 2)   # zero-length limb
    poses[1, 2] = 0.0              # an unlabeled (padding) row
    return poses


def _jax_vmap(fn, poses):
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(poses)))


# ---------------------------------------------------------------- GT maps


@pytest.mark.parametrize("k", [18, 70])
def test_render_heatmaps_matches_jax(k):
    poses = _random_poses(np.random.RandomState(k), (3,), 4, k, 40, 48)
    got = tgt.render_heatmaps(torch.from_numpy(poses), 40, 48, 7.0)
    ref = _jax_vmap(lambda p: jgt.render_heatmaps(p, 40, 48, 7.0), poses)
    assert got.shape == (3, k + 1, 40, 48)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["random", "planted"])
def test_render_pafs_matches_jax(case):
    poses = (_random_poses(np.random.RandomState(1), (3,), 4, 18, 40, 48)
             if case == "random" else _planted_limb_poses())
    got = tgt.render_pafs(torch.from_numpy(poses), 40, 48, 8.0)
    ref = _jax_vmap(lambda p: jgt.render_pafs(p, 40, 48, 8.0), poses)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    assert np.abs(ref).max() > 0.5  # the fields are not empty


def test_render_labels_matches_jax_and_the_numpy_oracles():
    poses = _planted_limb_poses()
    pafs, heat = tgt.render_labels(torch.from_numpy(poses), 40, 48, 7.0,
                                   8.0)
    for b in range(len(poses)):
        jp, jh = jgt.render_labels(jnp.asarray(poses[b]), 40, 48, 7.0, 8.0)
        np.testing.assert_allclose(pafs[b].numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(heat[b].numpy(), np.asarray(jh),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            pafs[b].numpy(), tgt.render_pafs_numpy(poses[b], 40, 48, 8.0),
            rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            heat[b].numpy(),
            tgt.render_heatmaps_numpy(poses[b], 40, 48, 7.0),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw, out_hw", [((56, 48), (7, 6)),
                                        ((64, 64), (8, 8))])
def test_render_at_output_res_matches_jax(hw, out_hw):
    """``render_labels_at``, ``render_pafs_at`` and ``render_heatmaps_at``
    (21 keypoints: the hand net's table) against JAX's, on a non-square,
    non-divisible grid too."""
    h, w = hw
    rng = np.random.RandomState(7)
    poses = _random_poses(rng, (2,), 4, 18, h, w)
    pafs, heat = tgt.render_labels_at(torch.from_numpy(poses), h, w, out_hw,
                                      7.0, 8.0)
    jp = _jax_vmap(lambda p: jgt.render_labels_at(p, h, w, out_hw, 7.0,
                                                  8.0)[0], poses)
    jh = _jax_vmap(lambda p: jgt.render_labels_at(p, h, w, out_hw, 7.0,
                                                  8.0)[1], poses)
    np.testing.assert_allclose(pafs.numpy(), jp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(heat.numpy(), jh, rtol=0, atol=1e-5)
    got = tgt.render_pafs_at(torch.from_numpy(poses), h, w, out_hw, 8.0)
    np.testing.assert_allclose(got.numpy(), jp, rtol=0, atol=1e-5)
    hand = _random_poses(rng, (2,), 1, 21, h, w)
    got = tgt.render_heatmaps_at(torch.from_numpy(hand), h, w, out_hw, 7.0)
    ref = _jax_vmap(lambda p: jgt.render_heatmaps_at(p, h, w, out_hw, 7.0),
                    hand)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_empty_pose_table_gives_all_background_as_jax():
    poses = np.zeros((2, 0, 18, 3), np.float32)
    pafs, heat = tgt.render_labels(torch.from_numpy(poses), 16, 24, 7.0, 8.0)
    jp, jh = jgt.render_labels(jnp.asarray(poses[0]), 16, 24, 7.0, 8.0)
    assert pafs.shape == (2, 38, 16, 24) and heat.shape == (2, 19, 16, 24)
    for b in range(2):
        np.testing.assert_array_equal(pafs[b].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(heat[b].numpy(), np.asarray(jh))
    assert (heat[:, -1] == 1).all() and (heat[:, :-1] == 0).all()


# ------------------------------------------------------------------- loss


def _stage_maps(rng, s, b, h, w, c):
    return rng.randn(s, b, h, w, c).astype(np.float32)


def _assert_loss_matches_jax(fn, jfn, arrays):
    """``fn`` on float32 tensors against ``jfn`` on float64 copies (rtol
    1e-6) and on the float32 arrays (rtol 1e-5); returns the metrics."""
    total, metrics = fn(*map(torch.from_numpy, arrays))
    with jax.enable_x64(True):
        _, exact = jfn(*(jnp.asarray(a.astype(np.float64)
                                     if a.dtype == np.float32 else a)
                         for a in arrays))
        exact = {k: np.asarray(v) for k, v in exact.items()}
    _, jmetrics = jfn(*map(jnp.asarray, arrays))
    for key in ("loss", "paf", "heat", "paf_stages", "heat_stages"):
        got = metrics[key].numpy()
        np.testing.assert_allclose(got, exact[key], rtol=1e-6, err_msg=key)
        np.testing.assert_allclose(got, np.asarray(jmetrics[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(total) == float(metrics["loss"])
    return metrics


@pytest.mark.parametrize("gt_res", ["output", "input"])
def test_compute_loss_matches_jax(gt_res):
    rng = np.random.RandomState(0)
    pafs_ys = _stage_maps(rng, 6, 2, 8, 8, 38)
    heat_ys = _stage_maps(rng, 6, 2, 8, 8, 19)
    g = 8 if gt_res == "output" else 64
    pafs_t = rng.rand(2, g, g, 38).astype(np.float32)
    heat_t = rng.rand(2, g, g, 19).astype(np.float32)
    mask = rng.rand(2, 64, 64) < 0.1
    _assert_loss_matches_jax(tloss.compute_loss, jloss.compute_loss,
                             (pafs_ys, heat_ys, pafs_t, heat_t, mask))


def test_compute_loss_single_matches_jax():
    rng = np.random.RandomState(1)
    ys = _stage_maps(rng, 6, 2, 8, 8, 71)
    gt = rng.rand(2, 8, 8, 71).astype(np.float32)
    mask = rng.rand(2, 64, 64) < 0.1
    metrics = _assert_loss_matches_jax(
        tloss.compute_loss_single, jloss.compute_loss_single,
        (ys, gt, mask))
    assert float(metrics["paf"]) == 0.0


@pytest.mark.parametrize("branches", [2, 1])
def test_masked_pixels_have_exactly_zero_gradient(branches):
    rng = np.random.RandomState(2)
    mask = np.zeros((2, 8, 8), bool)
    mask[0, 2:5, 3:7] = True
    mask[1, :, :2] = True
    heat = torch.from_numpy(_stage_maps(rng, 3, 2, 8, 8, 19)
                            ).requires_grad_()
    heat_t = torch.from_numpy(rng.rand(2, 8, 8, 19).astype(np.float32))
    if branches == 2:
        pafs = torch.from_numpy(_stage_maps(rng, 3, 2, 8, 8, 38)
                                ).requires_grad_()
        pafs_t = torch.from_numpy(rng.rand(2, 8, 8, 38).astype(np.float32))
        total, _ = tloss.compute_loss(pafs, heat, pafs_t, heat_t,
                                      torch.from_numpy(mask))
        leaves = (pafs, heat)
    else:
        total, _ = tloss.compute_loss_single(heat, heat_t,
                                             torch.from_numpy(mask))
        leaves = (heat,)
    total.backward()
    for leaf in leaves:
        grad = leaf.grad.numpy()
        assert (grad[:, mask] == 0).all()
        assert (grad[:, ~mask] != 0).mean() > 0.99


# -------------------------------------------------------------- optimizer


def test_lr_schedule_matches_optax():
    for drops in ((100_000, 200_000), (2, 4)):
        cfg = TrainConfig(lr_drop_steps=drops)
        got = topt.make_lr_schedule(cfg)
        ref = jopt.make_lr_schedule(_jax_cfg(cfg))
        for count in (0, 1, 2, 3, 4, 5, 99_999, 100_000, 100_001, 199_999,
                      200_000, 300_000):
            g = got(count)
            assert g.dtype == np.float32
            assert g == np.float32(ref(count)), (drops, count)


def _grads_like(model, rng):
    """Per-leaf gradients across scales (1e-9 to 1), some exact zeros."""
    grads = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        g = rng.standard_normal(p.shape, dtype=np.float32)
        g *= np.float32(10.0 ** -(i % 10))
        g.reshape(-1)[::97] = 0.0
        grads[name] = g
    return grads


@pytest.mark.parametrize("arch", ["posenet", "facenet"])
def test_optimizer_updates_match_optax_across_freeze_and_lr_drops(arch):
    """Six steps through the stem freeze (2 steps) and both LR drops (at 2
    and 4).  The port's parameters are zeroed before each step, so after it
    they hold that step's update exactly."""
    cfg = TrainConfig(stem_freeze_steps=2, lr_drop_steps=(2, 4))
    model = ARCHS[arch](num_stages=1, seed=0)
    tree = flax_params_from_model(model)
    tx = jopt.make_optimizer(tree, _jax_cfg(cfg), arch=arch)
    jstate = tx.init(tree)
    jupdate = jax.jit(tx.update)
    opt = topt.make_optimizer(model, cfg, arch=arch)
    rng = np.random.default_rng(3)
    frozen = {f"stem.{n}" for n in topt.FREEZE_LAYERS}
    for step in range(6):
        grads = _grads_like(model, rng)
        updates, jstate = jupdate(
            flax_params_from_state_dict(
                {n: torch.from_numpy(g) for n, g in grads.items()}),
            jstate, tree)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.zero_()
                p.grad = torch.from_numpy(grads[name])
        opt.step()
        got = flax_params_from_model(model)
        for block, layers in got.items():
            for layer, leaves in layers.items():
                for leaf in ("kernel", "bias"):
                    g = leaves["conv"][leaf]
                    r = np.asarray(updates[block][layer]["conv"][leaf])
                    np.testing.assert_allclose(
                        g, r, rtol=1e-6, atol=1e-10,
                        err_msg=f"step {step} {block}/{layer}/{leaf}")
                    live = (arch != "posenet" or step >= 2
                            or f"{block}.{layer}" not in frozen)
                    assert (np.abs(g).max() > 0) == live, (step, layer)


# --------------------------------------------------------- one full step


def _batch(rng, k, insize=32, b=2, p=2):
    poses = _random_poses(rng, (b,), p, k, insize, insize)
    return (rng.randint(0, 256, (b, insize, insize, 3)).astype(np.uint8),
            poses, rng.rand(b, insize, insize) < 0.2)


def _torch_batch(arrays):
    return ttr.TrainBatch(*map(torch.from_numpy, arrays))


@pytest.fixture(scope="module", params=["posenet", "facenet"])
def full_step(request):
    """The full-width net (6 stages) at insize 32, B = 2: JAX's loss and
    gradients from the port's seeded parameters, computed in float64 (one
    compile per arch).  JAX's own float32 gradients on the CPU are up to
    3.8e-3 x max |g| off these at CocoPoseNet's stem (1e-6 elsewhere and
    for FaceNet); the port's float32 ones are within 1.2e-6."""
    arch = request.param
    cfg = TrainConfig(insize=32, max_persons=2, stem_freeze_steps=0)
    port = ARCHS[arch](seed=3)
    tree = flax_params_from_model(port)
    arrays = _batch(np.random.RandomState(5), KEYPOINTS[arch])
    jcfg = _jax_cfg(cfg)
    with jax.enable_x64(True):
        jmodel = JAX_ARCHS[arch](dtype=jnp.float64)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, b: jtr.loss_for_batch(jmodel, p, b, jcfg),
            has_aux=True))
        (jloss_v, _), jgrads = grad_fn(
            jax.tree_util.tree_map(lambda a: a.astype(np.float64), tree),
            jtr.TrainBatch(*map(jnp.asarray, arrays)))
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    return dict(arch=arch, cfg=cfg, port=port, tree=tree, arrays=arrays,
                loss=float(jloss_v), grads=jgrads)


def _grads_tree(model):
    return flax_params_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})


def _assert_grads_close(got, ref, rel):
    for block, layers in ref.items():
        for layer, leaves in layers.items():
            for leaf, r in leaves["conv"].items():
                g = got[block][layer]["conv"][leaf]
                bound = rel * np.abs(r).max()
                err = np.abs(g - r).max()
                assert err <= bound, (block, layer, leaf, err, bound)


def test_train_step_loss_and_gradients_match_jax(full_step):
    port, cfg = full_step["port"], full_step["cfg"]
    port.zero_grad(set_to_none=True)
    total, metrics = ttr.loss_for_batch(port, _torch_batch(
        full_step["arrays"]), cfg)
    total.backward()
    np.testing.assert_allclose(total.item(), full_step["loss"], rtol=1e-4)
    _assert_grads_close(_grads_tree(port), full_step["grads"], 1e-3)


def test_remat_gradients_equal_plain(full_step):
    """``cfg.remat`` (the forward under ``torch.utils.checkpoint``) gives
    the same loss and gradients as the plain step."""
    port, cfg = full_step["port"], full_step["cfg"]
    out = []
    for remat in (False, True):
        port.zero_grad(set_to_none=True)
        total, _ = ttr.loss_for_batch(
            port, _torch_batch(full_step["arrays"]),
            dataclasses.replace(cfg, remat=remat))
        total.backward()
        out.append((total.item(), _grads_tree(port)))
    assert out[0][0] == out[1][0]
    _assert_grads_close(out[1][1], out[0][1], 1e-6)


def test_make_train_step_applies_the_optimizer(full_step):
    """The port's eager step: metrics of the pre-step parameters, the
    step count advanced, every live parameter moved by at most ~lr."""
    arch, cfg = full_step["arch"], full_step["cfg"]
    model = ARCHS[arch](seed=3)
    state = ttr.init_train_state(model, cfg, arch=arch, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = ttr.make_train_step(cfg)(
        state, _torch_batch(full_step["arrays"]))
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), full_step["loss"],
                               rtol=1e-4)
    for name, p in model.named_parameters():
        moved = (p.detach() - before[name]).abs().max().item()
        assert 0 < moved <= 1.01 * cfg.lr, name


# ------------------------------------------------------------------- bf16


def _old_convrelu_forward(self, x):
    x = self.conv(x)
    return F.relu(x) if self.relu else x


@pytest.mark.parametrize("arch", ["posenet", "facenet", "handnet"])
def test_f32_forward_is_the_plain_conv_forward_bit_for_bit(arch,
                                                           monkeypatch):
    model = ARCHS[arch](num_stages=2, seed=1)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 32, 40, 3).astype(np.float32))
    with torch.no_grad():
        new = model(x)
        monkeypatch.setattr(cpm.ConvReLU, "forward", _old_convrelu_forward)
        old = model(x)
    for n, o in zip(new if isinstance(new, tuple) else (new,),
                    old if isinstance(old, tuple) else (old,)):
        assert n.dtype == torch.float32
        assert torch.equal(n, o)


@pytest.mark.parametrize("arch", ["posenet", "facenet", "handnet"])
def test_bf16_forward_matches_jax_bf16(arch):
    """bf16 compute over float32 parameters, outputs stacked in float32:
    each stage within 2.5e-2 x max |ref| of Flax's bf16 forward (measured
    6e-3 to 1.2e-2: two bf16 roundings, 8-bit mantissas, per layer); the
    convs, ReLUs and pools run in bf16."""
    port = ARCHS[arch](num_stages=2, seed=2, dtype=torch.bfloat16)
    seen = set()
    for module in port.modules():
        if isinstance(module, (torch.nn.Conv2d, cpm.ConvReLU)):
            module.register_forward_hook(
                lambda m, args, out: seen.add(out.dtype))
    tree = flax_params_from_model(port)
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert seen == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in port.parameters())
    ref = JAX_ARCHS[arch](num_stages=2, dtype=jnp.bfloat16).apply(
        {"params": tree}, jnp.asarray(x))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and r.dtype == np.float32
        for s in range(2):
            scale = np.abs(r[s]).max()
            np.testing.assert_allclose(g[s].numpy(), r[s], rtol=0,
                                       atol=2.5e-2 * scale,
                                       err_msg=f"stage {s + 1}")


def test_bf16_loss_trajectory_tracks_f32_and_jax():
    cfg = TrainConfig(insize=32, max_persons=2, stem_freeze_steps=0)
    batch = _torch_batch(_batch(np.random.RandomState(6), 18))
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = ARCHS["posenet"](seed=4, dtype=dtype)
        state = ttr.init_train_state(model, cfg, device="cpu")
        step = ttr.make_train_step(cfg)
        losses[dtype] = []
        for _ in range(3):
            state, metrics = step(state, batch)
            losses[dtype].append(float(metrics["loss"]))
    np.testing.assert_allclose(losses[torch.bfloat16], losses[torch.float32],
                               rtol=0.05)
    assert losses[torch.float32][-1] < losses[torch.float32][0]
    tree = flax_params_from_model(ARCHS["posenet"](seed=4))
    jmodel = JAX_ARCHS["posenet"](dtype=jnp.bfloat16)
    jbatch = jtr.TrainBatch(imgs=jnp.asarray(batch.imgs.numpy()),
                            poses=jnp.asarray(batch.poses.numpy()),
                            ignore_mask=jnp.asarray(
                                batch.ignore_mask.numpy()))
    jloss_v, _ = jax.jit(lambda p, b: jtr.loss_for_batch(
        jmodel, p, b, _jax_cfg(cfg)))(tree, jbatch)
    np.testing.assert_allclose(losses[torch.bfloat16][0], float(jloss_v),
                               rtol=2e-2)
