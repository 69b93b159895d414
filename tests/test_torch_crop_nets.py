"""Parity of the port's crop nets and their host-side pieces with the JAX
package's, on the CPU: FaceNet and HandNet (``tpupose_torch/models/``), the
weight loads into them, ``global_argmax_keypoints``, the crop cascade
(``detectors/crops.py``) and the uint8 resize the crop detectors feed the
nets with (``resize_u8_linear`` against ``cv2.resize``).

Tolerances: the nets' maps within 1e-4 x max|ref| per stage (float32 convs
in other summation orders through 52 layers); loaded weights, argmax
coordinates and validity, crop boxes and crops, and resized pixels exact;
argmax scores 2e-6 (the JAX blur may contract a multiply-add).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from tpupose.detectors import crops as jcrops
from tpupose.models import FaceNet as FlaxFaceNet
from tpupose.models import HandNet as FlaxHandNet
from tpupose.ops import peaks as jpeaks
from tpupose.weights import save_npz_params
from tpupose_torch.detectors import crops as tcrops
from tpupose_torch.models import ARCHS
from tpupose_torch.ops import peaks as tpeaks
from tpupose_torch.ops.resize import resize_u8_linear
from tpupose_torch.weights import (load_chainer_npz, load_flax_params,
                                   warn_on_load_report)

FLAX = {"facenet": FlaxFaceNet, "handnet": FlaxHandNet}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["facenet", "handnet"])
def crop_net(request):
    """(arch, Flax model, its numpy params, the port's model loaded with
    them)."""
    arch = request.param
    model = FLAX[arch]()
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(len(arch)), jnp.zeros((1, 32, 32, 3))))
    port = ARCHS[arch](seed=1)
    load_flax_params(port, params)
    return arch, model, params, port


def test_crop_net_stages_match_flax(crop_net):
    arch, model, params, port = crop_net
    x = np.random.RandomState(3).uniform(-0.5, 0.5, (2, 64, 64, 3)).astype(
        np.float32)
    ref = np.asarray(model.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    channels = {"facenet": 71, "handnet": 22}[arch]
    assert got.shape == ref.shape == (6, 2, 8, 8, channels)
    for s in range(6):
        np.testing.assert_allclose(got[s], ref[s], rtol=0,
                                   atol=1e-4 * np.abs(ref[s]).max(),
                                   err_msg=f"stage {s + 1}")


def test_flax_load_sets_every_conv(crop_net):
    arch, _, params, port = crop_net
    convs = [(name, m) for name, m in port.named_modules()
             if isinstance(m, nn.Conv2d)]
    assert len(convs) == 52
    for name, conv in convs:
        block, layer, _ = name.split(".")
        leaves = params["params"][block][layer]["conv"]
        np.testing.assert_array_equal(
            conv.weight.detach().numpy(),
            leaves["kernel"].transpose(3, 2, 0, 1), err_msg=name)
        np.testing.assert_array_equal(conv.bias.detach().numpy(),
                                      leaves["bias"], err_msg=name)


def test_chainer_npz_round_trip_loads_every_key(crop_net, tmp_path,
                                                recwarn):
    """JAX ``save_npz_params`` -> port ``load_chainer_npz``: every key
    loads, none is left over, the load report does not warn, and the
    model's outputs equal the Flax-tree load's bit for bit."""
    arch, _, params, port = crop_net
    path = str(tmp_path / f"{arch}.npz")
    save_npz_params(path, params["params"])
    other = ARCHS[arch](seed=2)
    report = load_chainer_npz(other, path)
    assert report["missing"] == [] and report["unused"] == []
    assert len(report["loaded"]) == 2 * 52
    warn_on_load_report(report, path, arch=arch)
    assert not [w for w in recwarn if w.category is RuntimeWarning]
    x = torch.from_numpy(np.random.RandomState(4).uniform(
        -0.5, 0.5, (1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(other(x), port(x))


# ------------------------------------------------------- global argmax


def _assert_argmax_equal(got, ref, thresh):
    x, y, score, valid = got
    jx, jy, jscore, jvalid = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(x.numpy(), jx)
    np.testing.assert_array_equal(y.numpy(), jy)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_allclose(score.numpy(), jscore, rtol=0, atol=2e-6)
    assert x.dtype == y.dtype == torch.int64 and valid.dtype == torch.bool


@pytest.mark.parametrize("shape, thresh", [((70, 40, 36), 0.1),
                                           ((21, 96, 80), 0.3),
                                           ((5, 1, 9), 0.2)])
def test_global_argmax_keypoints_matches_jax(shape, thresh):
    """Channels of rising amplitude, so some clear the threshold and some
    do not."""
    rng = np.random.RandomState(shape[1])
    amp = np.linspace(0.05, 1.2, shape[0])[:, None, None]
    hm = (rng.rand(*shape) * amp).astype(np.float32)
    ref = jpeaks.global_argmax_keypoints(jnp.asarray(hm), 2.5, thresh)
    got = tpeaks.global_argmax_keypoints(torch.from_numpy(hm), 2.5, thresh)
    _assert_argmax_equal(got, ref, thresh)
    assert 0 < int(got[3].sum()) < shape[0]


def test_global_argmax_keypoints_planted_ties_match_jax():
    """Exact ties after the blur: two equal isolated peaks, two equal
    plateaus and a flat map.  Both take the first maximum in row-major
    order."""
    hm = np.zeros((4, 48, 40), np.float32)
    hm[0, 30, 5] = hm[0, 12, 30] = 1.0       # (12, 30) comes first
    hm[1, 20:23, 8:11] = hm[1, 20:23, 25:28] = 0.5
    hm[2] = 0.2                              # every pixel ties
    hm[3, 40, 30] = hm[3, 40, 10] = 0.7      # same row: x 10 first
    ref = jpeaks.global_argmax_keypoints(jnp.asarray(hm), 2.5, 0.05)
    got = tpeaks.global_argmax_keypoints(torch.from_numpy(hm), 2.5, 0.05)
    _assert_argmax_equal(got, ref, 0.05)
    assert got[0].tolist() == [30, 9, 0, 10]
    assert got[1].tolist() == [12, 21, 0, 40]


# ---------------------------------------------------------- crop cascade


def _poses(rng, n, hw=(120, 160)):
    """Random person poses over an (H, W) image, joints missing at random
    and some off the image."""
    poses = np.zeros((n, 18, 3))
    poses[:, :, 0] = rng.uniform(-20, hw[1] + 20, (n, 18))
    poses[:, :, 1] = rng.uniform(-20, hw[0] + 20, (n, 18))
    poses[:, :, 2] = 2 * (rng.rand(n, 18) < 0.8)
    poses[:, :, :2] *= poses[:, :, 2:] > 0
    return poses


def test_crops_match_jax():
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    poses = _poses(rng, 12)
    poses[0, :, 2] = 0                       # nobody visible
    poses[1, :, 2] = 0
    poses[1, [0, 14, 16], 2] = 2             # nose, right eye and ear only
    poses[2, 3, 2] = 0                       # a wrist without its elbow
    poses[2, 4, :] = (150, 100, 2)
    for pose in poses:
        unit = tcrops.get_unit_length(pose)
        assert unit == jcrops.get_unit_length(pose)
        got, ref = tcrops.crop_face(img, pose, unit), jcrops.crop_face(
            img, pose, unit)
        assert got[1] == ref[1]
        if ref[0] is None:
            assert got[0] is None
        else:
            np.testing.assert_array_equal(got[0], ref[0])
        got, ref = tcrops.crop_hands(img, pose, unit), jcrops.crop_hands(
            img, pose, unit)
        for side in ("left", "right"):
            assert (got[side] is None) == (ref[side] is None)
            if ref[side] is not None:
                assert got[side]["bbox"] == ref[side]["bbox"]
                np.testing.assert_array_equal(got[side]["img"],
                                              ref[side]["img"])
        got, ref = tcrops.crop_person(img, pose, unit), jcrops.crop_person(
            img, pose, unit)
        assert got[1] == ref[1]
        if ref[0] is not None:
            np.testing.assert_array_equal(got[0], ref[0])
    for rect in ((10, 20, 30, 40), (140, 100, 50, 30), (0, 0, 5, 7)):
        got, ref = tcrops.crop_face_haar(img, rect), jcrops.crop_face_haar(
            img, rect)
        assert got[1] == ref[1]
        np.testing.assert_array_equal(got[0], ref[0])


# ------------------------------------------------ the crop resize vs cv2


@pytest.mark.parametrize("hw", [
    (100, 100), (50, 70), (200, 150), (8, 300),     # upscales
    (400, 300), (1000, 800), (500, 736),            # downscales
    (736, 736), (736, 368),                         # exact 2x down
    (1472, 1472),                                   # exact 4x down
    (369, 367), (123, 457), (3, 5),                 # odd sizes
    (1, 40), (40, 1), (1, 1), (367, 1), (1, 368),   # one pixel wide
    (368, 368)])                                    # no resize
def test_resize_u8_linear_to_the_crop_size_is_cv2_bit_for_bit(hw):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(hw[0] * 7 + hw[1])
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    for crop in (img, img[:, ::-1]):         # and the left-hand mirror
        np.testing.assert_array_equal(resize_u8_linear(crop, (368, 368)),
                                      cv2.resize(crop, (368, 368)))
