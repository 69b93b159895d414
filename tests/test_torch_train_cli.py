"""The port's train CLI, checkpoints, weight exports and the small apps
(``tpupose_torch.apps.train_cli``, ``train.checkpoint``,
``weights.save_chainer_npz`` / ``flax_params_from_model``,
``weights.caffe``, ``apps.convert_model`` / ``plot_log`` / ``data_viz``)
on the CPU, against the JAX package's files and functions."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from test_weights import _make_caffemodel
from tpupose.config import TrainConfig as JaxTrainConfig
from tpupose.weights import load_npz_params, save_npz_params
from tpupose_torch.apps import train_cli
from tpupose_torch.config import TrainConfig
from tpupose_torch.models import ARCHS
from tpupose_torch.train import checkpoint as ckpt
from tpupose_torch.train import trainer as ttr
from tpupose_torch.weights import (flax_params_from_model, load_chainer_npz,
                                   load_flax_params, save_chainer_npz)
from tpupose_torch.weights.caffe import VGG_LAYERS, init_stem_from_caffe_vgg


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tmp_path(tmp_path):
    """A test's directory, removed when it ends: every run writes
    full-width snapshots (~200 MB for CocoPoseNet)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cli(tmp_path, *flags):
    out = tmp_path / "run"
    train_cli.main(["--synthetic", "--test", "--device", "cpu",
                    "--insize", "32", "--batchsize", "2", "--valbatchsize",
                    "2", "--out", str(out), *flags])
    return out


@pytest.mark.parametrize("arch", ["posenet", "facenet", "handnet"])
def test_train_cli_synthetic_test_run_on_the_cpu(tmp_path, arch, capsys):
    """posenet takes --test's 10 iterations (a validation, snapshot and
    npz export at 10); the crop nets 2 (the final snapshot and npz)."""
    iters = 10 if arch == "posenet" else 2
    out = _cli(tmp_path, "--arch", arch, "--iteration", str(iters))
    log = json.loads((out / "log").read_text())
    assert [e["iteration"] for e in log] == list(range(1, iters + 1))
    assert all(np.isfinite(e["main/loss"]) for e in log)
    assert ("val/loss" in log[-1]) == (iters == 10)
    if arch != "posenet":
        assert all(e["main/paf"] == 0 for e in log)
    params = json.loads((out / "params.json").read_text())
    assert params["arch"] == arch and params["device"] == "cpu"
    assert (out / "train_step.export.txt").read_text().startswith(
        "ExportedProgram")
    assert ckpt.latest_checkpoint(str(out)).endswith(f"ckpt/{iters}")
    final = out / f"{arch}_final.npz"
    model = ARCHS[arch](seed=9)
    report = load_chainer_npz(model, str(final))
    assert not report["missing"] and not report["unused"]
    assert f"done: {iters} iterations" in capsys.readouterr().out


@pytest.mark.parametrize("argv, match", [
    (["--arch", "facenet"], "cannot train on COCO"),
    (["--synthetic", "--n_data", "2"], "needs more than the 1 available"),
    (["--synthetic", "--n_spatial", "2"],
     "needs more than the 1 available"),
], ids=["facenet_without_synthetic", "n_data", "n_spatial"])
def test_train_cli_refuses_what_it_cannot_run(argv, match):
    with pytest.raises(SystemExit, match=match):
        train_cli.main(argv + ["--device", "cpu"])


def test_train_cli_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--synthetic", "--test"])


def _small_state(seed, cfg):
    return ttr.init_train_state(ARCHS["posenet"](num_stages=2, seed=seed),
                                cfg, device="cpu")


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    """Save at step 2 (the stem still frozen), restore into a fresh state
    of other weights, take steps 3-4 (the stem's first live updates):
    parameters and optimizer state bit-equal to four uninterrupted
    steps."""
    from tpupose_torch.data import BatchLoader, SyntheticCropDataset

    cfg = TrainConfig(insize=32, max_persons=1, stem_freeze_steps=2,
                      lr_drop_steps=(3,))
    batches = list(BatchLoader(SyntheticCropDataset(18, insize=32,
                                                    n_samples=8),
                               2, max_persons=1, repeat=False))
    step = ttr.make_train_step(cfg)
    full = _small_state(0, cfg)
    for batch in batches:
        full, _ = step(full, batch)

    part = _small_state(0, cfg)
    for batch in batches[:2]:
        part, _ = step(part, batch)
    path = ckpt.save_checkpoint(str(tmp_path), part)
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    resumed = ckpt.restore_checkpoint(path, _small_state(1, cfg))
    assert resumed.step == 2
    for batch in batches[2:]:
        resumed, _ = step(resumed, batch)
    assert resumed.step == full.step == 4
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = full.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k in sa["state"]:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][k][key], sb["state"][k][key])


def test_npz_export_loads_into_jax_and_jax_npz_into_the_port(tmp_path):
    model = ARCHS["posenet"](num_stages=2, seed=4)
    state = ttr.TrainState(step=7, model=model, optimizer=None)
    path = ckpt.export_model_npz(str(tmp_path), state)
    assert path.endswith("model_iter_7.npz")
    tree = flax_params_from_model(model)
    template = flax_params_from_model(ARCHS["posenet"](num_stages=2, seed=5))
    loaded, report = load_npz_params(path, template)
    assert not report["missing"] and not report["unused"]
    for block, layers in tree.items():
        for layer, leaves in layers.items():
            for leaf, value in leaves["conv"].items():
                np.testing.assert_array_equal(
                    loaded[block][layer]["conv"][leaf], value)
    # the other way: JAX's save_npz_params -> the port's loader
    jax_path = str(tmp_path / "jax.npz")
    save_npz_params(jax_path, tree)
    other = ARCHS["posenet"](num_stages=2, seed=6)
    report = load_chainer_npz(other, jax_path)
    assert not report["missing"] and not report["unused"]
    for a, b in zip(model.state_dict().values(),
                    other.state_dict().values()):
        assert torch.equal(a, b)
    # save_chainer_npz writes save_npz_params's keys and values
    save_chainer_npz(str(tmp_path / "port.npz"), model)
    with np.load(jax_path) as j, np.load(tmp_path / "port.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        for key in j.files:
            np.testing.assert_array_equal(j[key], p[key])


def test_flax_params_round_trip():
    model = ARCHS["handnet"](num_stages=2, seed=2)
    other = ARCHS["handnet"](num_stages=2, seed=3)
    load_flax_params(other, flax_params_from_model(model))
    for a, b in zip(model.state_dict().values(),
                    other.state_dict().values()):
        assert torch.equal(a, b)


def _vgg_caffemodel(path, rng):
    model = ARCHS["posenet"](num_stages=1)
    layers = {}
    for name in VGG_LAYERS:
        conv = getattr(model.stem, name).conv
        layers[name] = [rng.randn(*conv.weight.shape).astype(np.float32),
                        rng.randn(*conv.bias.shape).astype(np.float32)]
    _make_caffemodel(path, layers)
    return layers


def test_vgg_warm_start_equals_jax_and_trains_frozen(tmp_path):
    """``--vgg`` on a synthesized Caffe VGG release: the port's stem
    equals the JAX package's ``init_stem_from_caffe_vgg`` on the same
    file, and stays so through a step (the stem is frozen)."""
    from tpupose.weights.caffe import \
        init_stem_from_caffe_vgg as jax_init_stem

    path = str(tmp_path / "vgg.caffemodel")
    layers = _vgg_caffemodel(path, np.random.RandomState(0))
    model = ARCHS["posenet"](num_stages=1, seed=0)
    init_stem_from_caffe_vgg(model, path, verbose=False)
    ref = jax_init_stem(flax_params_from_model(
        ARCHS["posenet"](num_stages=1, seed=0)), path, verbose=False)
    got = flax_params_from_model(model)
    for name in VGG_LAYERS:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got["stem"][name]["conv"][leaf],
                                          ref["stem"][name]["conv"][leaf])
    out = _cli(tmp_path, "--vgg", path, "--iteration", "1")
    with np.load(out / "posenet_final.npz") as z:
        for name in VGG_LAYERS:
            np.testing.assert_array_equal(z[f"{name}/W"], layers[name][0])
            np.testing.assert_array_equal(z[f"{name}/b"], layers[name][1])


def test_convert_model_equals_jax(tmp_path):
    from tpupose.apps import convert_model as jconvert
    from tpupose_torch.apps import convert_model

    rng = np.random.RandomState(1)
    layers = {n: [rng.randn(4, 3, 3, 3).astype(np.float32),
                  rng.randn(4).astype(np.float32)]
              for n in ("conv1_1", "conv5_5_CPM_L1", "Mconv7_stage6_L2")}
    src = str(tmp_path / "m.caffemodel")
    _make_caffemodel(src, layers)
    for quirk in ([], ["--reference-quirk"]):
        convert_model.main(["posenet", src, str(tmp_path / "port.npz"),
                            *quirk])
        jconvert.main(["posenet", src, str(tmp_path / "jax.npz"), *quirk])
        with np.load(tmp_path / "port.npz") as p, \
                np.load(tmp_path / "jax.npz") as j:
            assert sorted(p.files) == sorted(j.files)
            assert ("conv5_5_CPM_L1/W" in p.files) == (not quirk)
            for key in p.files:
                np.testing.assert_array_equal(p[key], j[key])


def test_plot_log_writes_the_loss_history(tmp_path):
    pytest.importorskip("matplotlib")
    from tpupose_torch.apps import plot_log

    (tmp_path / "log").write_text(json.dumps([
        {"iteration": 1, "main/loss": 1.0},
        {"iteration": 2, "main/loss": 0.5, "val/loss": 0.7}]))
    plot_log.main([str(tmp_path)])
    assert (tmp_path / "loss_history.png").stat().st_size > 0


def test_data_viz_panel_equals_jax():
    pytest.importorskip("cv2")
    from tpupose.apps import data_viz as jviz
    from tpupose_torch.apps import data_viz

    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)
    poses = np.zeros((2, 18, 3), np.float32)
    poses[..., 0] = rng.uniform(0, 63, (2, 18))
    poses[..., 1] = rng.uniform(0, 47, (2, 18))
    poses[..., 2] = 2
    mask = rng.rand(48, 64) < 0.1
    got = data_viz.render_panel(img, poses, mask, TrainConfig())
    want = jviz.render_panel(img, poses, mask, JaxTrainConfig())
    assert got.shape == (48, 128, 3)
    # u8 overlays of float maps within atol 1e-5: at most one step
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        JaxTrainConfig())
