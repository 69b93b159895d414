"""Parity of the port's conv-mode peak NMS (``nms_mode="conv"``: the
reference's GPU branch, a zero-padded ``ksize`` Gaussian and the ``>=``
neighbour rule) with the JAX package's, on the CPU.

Masks and peak tables must be equal, plateaus included; smoothed values
agree within 2e-6 (XLA on the CPU may contract a multiply-add into an FMA,
the port never does; 1 ulp of a value <= 1 is < 2e-7, a map's values
reach ~3).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpupose.config import NUM_JOINTS, NUM_LIMBS, InferenceConfig
from tpupose.ops import gaussian as jgauss
from tpupose.ops import peaks as jpeaks
from tpupose.ops import postprocess as jpost
from tpupose_torch.ops import gaussian as tgauss
from tpupose_torch.ops import peaks as tpeaks
from tpupose_torch.ops import postprocess as tpost

from test_postprocess import _render_scene
from test_torch_ops import (_assert_peaks_equal, _np, _planted_heatmaps, _t,
                            assert_pose_results_equal)

CONV = InferenceConfig(nms_mode="conv", max_peaks_per_joint=8,
                       max_subsets=32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _plateau_heatmaps(rng, j=7, h=40, w=52):
    """Flat-topped plateaus on zero maps (a 2-pixel run, 2x2 and 3x1 blocks
    of one value) and a corner peak, some on the border; a noise map; an
    empty one."""
    hm = np.zeros((j, h, w), np.float32)
    hm[0, 20, 30:32] = 3.0
    hm[1, 5:7, 5:7] = 2.0
    hm[2, 0, 10:13] = 1.5          # on the top border
    hm[3, 39, 51] = 2.5            # corner
    hm[4, 10:13, 0] = 1.25         # on the left border
    hm[5] = rng.rand(h, w) * 0.5   # noise
    return hm


@pytest.mark.parametrize("ksize", [17, 16, 5, 4, 1])
def test_conv_kernel_matches_jax(ksize):
    np.testing.assert_array_equal(
        tgauss.conv_gaussian_kernel_1d(2.5, ksize),
        jgauss.conv_gaussian_kernel_1d(2.5, ksize))


@pytest.mark.parametrize("ksize", [17, 16, 3, 2])
@pytest.mark.parametrize("hw", [(46, 62), (7, 9)])
def test_conv_blur_matches_jax(ksize, hw):
    x = np.random.RandomState(ksize).rand(5, *hw).astype(np.float32) * 3
    ref = np.asarray(jgauss.gaussian_blur_conv_zero(jnp.asarray(x), 2.5,
                                                    ksize))
    got = tgauss.gaussian_blur_conv_zero(_t(x), 2.5, ksize)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)


def test_conv_blur_rejects_empty_kernel():
    with pytest.raises(ValueError, match="ksize >= 1"):
        tgauss.gaussian_blur_conv_zero(torch.zeros(1, 4, 4), 2.5, 0)


@pytest.mark.parametrize("ksize", [17, 16, 5])
def test_conv_blur_is_bit_symmetric_on_a_plateau(ksize):
    """Two equal neighbours in a zero map blur to bit-equal values (each is
    the sum of the same two tap products, added in the other order), so
    the ``>=`` rule keeps both: the plateau ties of the reference's GPU
    path.  Planted in the middle, on a border and vertically."""
    x = np.zeros((3, 31, 37), np.float32)
    pairs = (((0, 15, 20), (0, 15, 21)), ((1, 0, 5), (1, 0, 6)),
             ((2, 9, 36), (2, 10, 36)))
    for (a, b), v in zip(pairs, (3.0, 2.5, 2.0)):
        x[a] = x[b] = v
    got = tgauss.gaussian_blur_conv_zero(_t(x), 2.5, ksize).numpy()
    mask = tpeaks.nms_mask_ge(torch.from_numpy(got), 0.05).numpy()
    for a, b in pairs:
        assert got[a] == got[b] > 0.05
        assert mask[a] and mask[b]


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_mask_ge_matches_jax(seed):
    rng = np.random.RandomState(seed)
    hm = _plateau_heatmaps(rng)
    smoothed = jgauss.gaussian_blur_conv_zero(jnp.asarray(hm), 2.5, 17)
    ref = np.asarray(jpeaks.nms_mask_ge(smoothed, 0.05))
    got = tpeaks.nms_mask_ge(_t(smoothed), 0.05).numpy()
    np.testing.assert_array_equal(got, ref)
    # the plateaus emit every tied pixel, the strict rule none
    assert got[0, 20, 30] and got[0, 20, 31]
    assert not tpeaks.nms_mask(_t(smoothed), 0.05).numpy()[0, 20, 30]


@pytest.mark.parametrize("make, max_peaks", [
    (_plateau_heatmaps, 8), (_planted_heatmaps, 8), (_planted_heatmaps, 2)],
    ids=["plateaus", "planted", "saturated"])
def test_find_peaks_conv_matches_jax(make, max_peaks):
    hm = make(np.random.RandomState(3))
    ref = jpeaks.find_peaks(jnp.asarray(hm), 2.5, 0.05, max_peaks,
                            mode="conv", ksize=17)
    got = tpeaks.find_peaks(_t(hm), 2.5, 0.05, max_peaks, mode="conv",
                            ksize=17)
    _assert_peaks_equal(got, ref)
    assert int(got.valid.sum()) > 0


def test_find_peaks_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown peak NMS mode"):
        tpeaks.find_peaks(torch.zeros(2, 8, 8), 2.5, 0.05, 4, mode="gpu")


def test_postprocess_respects_nms_mode():
    """The port's counterpart of ``tests/test_postprocess.py``'s case: a
    2-pixel plateau is two peaks under the ``>=`` rule, none under the
    strict one, and both results equal JAX's."""
    h, w = 46, 62
    heatmaps = np.zeros((NUM_JOINTS + 1, h, w), np.float32)
    heatmaps[0, 20, 30] = 3.0
    heatmaps[0, 20, 31] = 3.0
    pafs = np.zeros((2 * NUM_LIMBS, h, w), np.float32)
    cfg = InferenceConfig(nms_mode="conv")
    got = tpost.postprocess_pose(_t(pafs), _t(heatmaps), w, cfg)
    ref = jpost.postprocess_pose(jnp.asarray(pafs), jnp.asarray(heatmaps), w,
                                 cfg)
    assert int(got.num_peaks) == 2
    assert_pose_results_equal(got, ref)
    scipy_mode = tpost.postprocess_pose(_t(pafs), _t(heatmaps), w,
                                        InferenceConfig())
    assert int(scipy_mode.num_peaks) == 0


@pytest.mark.parametrize("seed, n_people, ksize", [(9, 3, 17), (12, 2, 16)])
def test_postprocess_conv_mode_matches_jax(seed, n_people, ksize):
    pafs, heatmaps = _render_scene(np.random.RandomState(seed),
                                   n_people=n_people)
    img_len = heatmaps.shape[2]
    cfg = dataclasses.replace(CONV, ksize=ksize)
    got = tpost.postprocess_pose(_t(pafs), _t(heatmaps), img_len, cfg)
    ref = jpost.postprocess_pose(jnp.asarray(pafs), jnp.asarray(heatmaps),
                                 img_len, cfg)
    assert_pose_results_equal(got, ref)
    assert int(_np(got.valid).sum()) >= 1
