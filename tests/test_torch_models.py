"""Parity of the torch CocoPoseNet (``tpupose_torch.models``) with the Flax
one, and of the port's weight loaders, on the CPU in float32."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpupose.models import CocoPoseNet as FlaxPoseNet
from tpupose.weights import save_npz_params
from tpupose_torch.models import CocoPoseNet
from tpupose_torch.weights import load_chainer_npz, load_flax_params


def _flax(num_stages, insize, seed=0):
    model = FlaxPoseNet(num_stages=num_stages)
    x = jnp.zeros((1, insize, insize, 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), x)
    return model, jax.tree_util.tree_map(np.asarray, params)


def _forward(model, x):
    with torch.no_grad():
        return [t.numpy() for t in model(torch.from_numpy(x))]


@pytest.fixture(scope="module")
def two_stage():
    model, params = _flax(2, 32)
    port = CocoPoseNet(num_stages=2, seed=1)
    load_flax_params(port, params)
    return model, params, port


@pytest.mark.parametrize("hw", [(32, 32), (48, 64)])
def test_posenet_stages_match_flax(two_stage, hw):
    model, params, port = two_stage
    x = np.random.RandomState(hw[1]).randn(2, *hw, 3).astype(np.float32)
    ref = [np.asarray(t) for t in model.apply(params, jnp.asarray(x))]
    got = _forward(port, x)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (2, 2, hw[0] // 8, hw[1] // 8, r.shape[-1])
        for s in range(2):
            # float32 convs in other summation orders (XLA vs oneDNN)
            # through 16-21 layers: relative to each stage's scale.
            scale = max(np.abs(r[s]).max(), 1e-3)
            np.testing.assert_allclose(g[s], r[s], rtol=0,
                                       atol=1e-4 * scale,
                                       err_msg=f"stage {s + 1}")


def test_chainer_npz_round_trip_gives_same_outputs(two_stage, tmp_path):
    """JAX ``save_npz_params`` -> port ``load_chainer_npz``: every key
    loads and the outputs equal those of the Flax-tree load bit for bit."""
    _, params, port = two_stage
    path = str(tmp_path / "posenet.npz")
    save_npz_params(path, params["params"])
    other = CocoPoseNet(num_stages=2, seed=2)
    report = load_chainer_npz(other, path)
    assert not report["missing"] and not report["unused"]
    assert len(report["loaded"]) == 2 * (12 + 10 + 14)
    x = np.random.RandomState(0).randn(1, 32, 40, 3).astype(np.float32)
    for g, r in zip(_forward(other, x), _forward(port, x)):
        np.testing.assert_array_equal(g, r)


def test_chainer_npz_reports_missing_and_unused(two_stage, tmp_path):
    _, params, _ = two_stage
    path = str(tmp_path / "partial.npz")
    save_npz_params(path, params["params"])
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    del flat["conv5_5_CPM_L1/W"], flat["conv5_5_CPM_L1/b"]
    flat["Mconv1_stage9_L1/W"] = np.zeros(1, np.float32)
    np.savez(path, **flat)
    model = CocoPoseNet(num_stages=2, seed=3)
    before = model.stage1_L1.conv5_5_CPM_L1.conv.weight.clone()
    report = load_chainer_npz(model, path)
    assert report["missing"] == ["conv5_5_CPM_L1/W", "conv5_5_CPM_L1/b"]
    assert report["unused"] == ["Mconv1_stage9_L1/W"]
    assert torch.equal(model.stage1_L1.conv5_5_CPM_L1.conv.weight, before)


def test_load_flax_params_rejects_shape_mismatch_and_gaps(two_stage):
    _, params, _ = two_stage
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(CocoPoseNet(num_stages=2), jax.tree_util.tree_map(
            lambda a: a[..., :1] if a.ndim == 4 else a, params))
    with pytest.raises(ValueError, match="lacks"):
        load_flax_params(CocoPoseNet(num_stages=3), params)


def test_module_names_follow_chainer_layers():
    keys = set(CocoPoseNet().state_dict())
    for expected in ["stem.conv1_1.conv.weight", "stem.conv4_4_CPM.conv.bias",
                     "stage1_L1.conv5_5_CPM_L1.conv.weight",
                     "stage6_L2.Mconv7_stage6_L2.conv.bias",
                     "stage2_L1.Mconv1_stage2_L1.conv.weight"]:
        assert expected in keys, expected
    assert len(keys) == 2 * (12 + 10 + 5 * 14)


def test_seeded_init_is_deterministic():
    a, b, c = (CocoPoseNet(num_stages=2, seed=s) for s in (5, 5, 6))
    for (name, ta), tb, tc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(ta, tb), name
        if name.endswith("weight"):      # biases start at zero, as in Flax
            assert not torch.equal(ta, tc), name
