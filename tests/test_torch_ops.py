"""Parity of the torch port's ops (``tpupose_torch.ops``) with the JAX
package's, on the CPU.

Inputs are made with numpy from a seed and handed to both.  Outputs decided
by integers or comparisons (masks, peak tables, slots, subsets) must be
equal; float outputs carry the tolerance stated at each check.  The JAX
blur+NMS runs as its own tests run it here: the Pallas kernel in interpret
mode.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpupose.config import (LIMBS_FROM, LIMBS_TO, NUM_JOINTS, NUM_LIMBS,
                            InferenceConfig)
from tpupose.ops import gaussian as jgauss
from tpupose.ops import grouping as jgroup
from tpupose.ops import paf as jpaf
from tpupose.ops import peaks as jpeaks
from tpupose.ops import postprocess as jpost
from tpupose.ops import resize as jresize
from tpupose.ops.pallas.blur_nms import blur_nms_pallas
from tpupose_torch.ops import blur_nms as tblur
from tpupose_torch.ops import gaussian as tgauss
from tpupose_torch.ops import grouping as tgroup
from tpupose_torch.ops import paf as tpaf
from tpupose_torch.ops import peaks as tpeaks
from tpupose_torch.ops import postprocess as tpost
from tpupose_torch.ops import resize as tresize

from oracles import oracle_connections, oracle_peaks
from test_postprocess import _peaks_from_oracle, _render_scene

CFG = InferenceConfig(max_peaks_per_joint=8, max_subsets=32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _planted_heatmaps(rng, j=18, h=46, w=62):
    """The maps of ``tests/test_pallas.py``: noise plus sharp peaks."""
    hm = rng.rand(j, h, w).astype(np.float32) * 0.3
    for c in range(j):
        for _ in range(3):
            y, x = rng.randint(2, h - 2), rng.randint(2, w - 2)
            hm[c, y, x] += rng.uniform(0.5, 1.0)
    return hm


def _torch_peaks(p):
    return tpeaks.Peaks(x=_t(p.x), y=_t(p.y), score=_t(p.score),
                        valid=_t(p.valid), dropped=torch.tensor(0))


def _assert_peaks_equal(got, ref):
    for name in ("x", "y", "valid"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    # Smoothed values: XLA on the CPU may contract a multiply-add into an
    # FMA, the port never does; 1 ulp of a value <= 1 is < 2e-7.
    np.testing.assert_allclose(_np(got.score), _np(ref.score), atol=2e-6)
    assert int(got.dropped) == int(ref.dropped)


# --------------------------------------------------------------- resize


@pytest.mark.parametrize("method", ["linear_align_corners",
                                    "linear_half_pixel", "cubic_half_pixel"])
@pytest.mark.parametrize("in_hw,out_hw", [((6, 8), (46, 62)),
                                          ((46, 62), (23, 17))])
def test_resize_hw_matches_jax(method, in_hw, out_hw):
    rng = np.random.RandomState(0)
    x = rng.randn(2, *in_hw, 5).astype(np.float32)
    ref = np.asarray(jresize.resize_hw(jnp.asarray(x), out_hw, method))
    got = tresize.resize_hw(_t(x), out_hw, method).numpy()
    assert got.shape == ref.shape
    # float32 matmuls in another summation order; |x| <~ 4.
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_compute_optimal_size_matches_jax():
    for h, w in [(480, 640), (640, 480), (96, 128), (1080, 1920), (7, 3),
                 (368, 368), (100, 130)]:
        for target in (368, 320, 96, 88):
            assert (tresize.compute_optimal_size(h, w, target)
                    == jresize.compute_optimal_size(h, w, target))


# The compiled host resize and its numpy plain version, both held to cv2.
U8_LINEAR = pytest.mark.parametrize(
    "resize_u8_linear", [tresize.resize_u8_linear,
                         tresize.resize_u8_linear_plain],
    ids=["compiled", "plain"])


@U8_LINEAR
@pytest.mark.parametrize("hw,size", [
    ((480, 640), (496, 368)), ((480, 640), (432, 320)),
    ((100, 130), (96, 72)), ((37, 53), (48, 64)), ((5, 7), (2, 3)),
])
def test_resize_u8_linear_matches_cv2(hw, size, resize_u8_linear):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(hw[0])
    for shape in (hw + (3,), hw):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        ref = cv2.resize(img, size)
        got = resize_u8_linear(img, size)
        assert got.shape == ref.shape and got.dtype == np.uint8
        # cv2's fixed-point arithmetic is emulated; at most 1 LSB apart.
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@U8_LINEAR
def test_resize_u8_linear_same_size_is_copy(resize_u8_linear):
    img = np.random.RandomState(0).randint(0, 256, (9, 11, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(resize_u8_linear(img, (11, 9)), img)


# ------------------------------------------------------ gaussian, NMS


@pytest.mark.parametrize("shape", [(18, 46, 62), (3, 7, 9), (2, 1, 30)])
def test_gaussian_blur_reflect_matches_jax(shape):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    ref = np.asarray(jgauss.gaussian_blur_reflect(jnp.asarray(x), 2.5))
    got = tgauss.gaussian_blur_reflect(_t(x), 2.5).numpy()
    # Same tap order; 1 ulp where XLA fuses a multiply-add.
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_nms_mask_matches_jax():
    rng = np.random.RandomState(2)
    s = rng.rand(4, 9, 11).astype(np.float32)
    s[0, 3, 3] = s[0, 3, 4] = 2.0     # plateau: strict rule emits neither
    s[1, 0, 0] = 2.0                  # corner peak against zero borders
    ref = np.asarray(jpeaks.nms_mask(jnp.asarray(s), 0.05))
    np.testing.assert_array_equal(tpeaks.nms_mask(_t(s), 0.05).numpy(), ref)


def _pallas_cases():
    rng = np.random.RandomState(0)
    planted = _planted_heatmaps(rng)
    small = np.random.RandomState(1).rand(3, 7, 9).astype(np.float32)
    tiled = _planted_heatmaps(np.random.RandomState(3), j=4, h=46, w=30)
    for c in range(4):
        for y in (15, 16, 31, 32):
            tiled[c, y, 5 + 3 * c] += 1.0
    return {"planted_18x46x62": (planted, 256), "small_3x7x9": (small, 256),
            "row_tiled_4x46x30": (tiled, 16)}


@pytest.mark.parametrize("case", ["planted_18x46x62", "small_3x7x9",
                                  "row_tiled_4x46x30"])
def test_blur_nms_reference_matches_pallas(case):
    hm, tile_h = _pallas_cases()[case]
    ref_s, ref_m = blur_nms_pallas(jnp.asarray(hm), 2.5, 0.05,
                                   interpret=True, tile_h=tile_h)
    got_s, got_m = tblur.blur_nms_reference(_t(hm), 2.5, 0.05)
    assert got_m.dtype == torch.bool
    # atol of tests/test_pallas.py: the interpreter may contract FMAs.
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=2e-6)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))


def test_blur_nms_routes_cpu_tensors_to_plain_version():
    hm = _t(_planted_heatmaps(np.random.RandomState(4), j=2))
    before = tblur.blur_nms.launches
    s, m = tblur.blur_nms(hm, 2.5, 0.05)
    rs, rm = tblur.blur_nms_reference(hm, 2.5, 0.05)
    assert torch.equal(s, rs) and torch.equal(m, rm)
    assert tblur.blur_nms.launches == before


# ------------------------------------------------------------- peaks


@pytest.mark.parametrize("seed,max_peaks", [(0, 8), (1, 2), (2, 64)])
def test_find_peaks_matches_jax(seed, max_peaks):
    hm = _planted_heatmaps(np.random.RandomState(seed))
    ref = jpeaks.find_peaks(jnp.asarray(hm), 2.5, 0.05, max_peaks,
                            use_pallas=False)
    got = tpeaks.find_peaks(_t(hm), 2.5, 0.05, max_peaks)
    _assert_peaks_equal(got, ref)
    if max_peaks == 2:
        assert int(got.dropped) > 0   # the saturation counter is exercised


@pytest.mark.parametrize("sigma", [5.0, 8.0])
def test_find_peaks_above_the_unrolled_radius_matches_jax(sigma):
    """sigma 5 and 8 (radius 20 and 32: the CUDA kernel's run-time-tap
    path on the card) through the plain version, against JAX's."""
    hm = _planted_heatmaps(np.random.RandomState(int(sigma)))
    ref = jpeaks.find_peaks(jnp.asarray(hm), sigma, 0.05, 16,
                            use_pallas=False)
    got = tpeaks.find_peaks(_t(hm), sigma, 0.05, 16)
    _assert_peaks_equal(got, ref)
    assert int(got.valid.sum()) > 0


def test_extract_peaks_tiny_map_pads_table():
    mask = np.zeros((2, 2, 3), bool)
    mask[0, 1, 2] = mask[1, 0, 0] = True
    sm = np.random.RandomState(0).rand(2, 2, 3).astype(np.float32)
    ref = jpeaks.extract_peaks(jnp.asarray(mask), jnp.asarray(sm), 8)
    got = tpeaks.extract_peaks(_t(mask), _t(sm), 8)
    _assert_peaks_equal(got, ref)


# ------------------------------------------------------ connections


def _scene_peaks(seed, n_people):
    rng = np.random.RandomState(seed)
    pafs, heatmaps = _render_scene(rng, n_people=n_people)
    ref_peaks = oracle_peaks(heatmaps[:-1], CFG)
    return pafs, heatmaps, ref_peaks, _peaks_from_oracle(
        ref_peaks, CFG.max_peaks_per_joint)


@pytest.mark.parametrize("seed", [7, 21, 22, 23, 24])
def test_connections_match_jax(seed):
    pafs, heatmaps, ref_peaks, jp = _scene_peaks(seed, 1 + seed % 4)
    img_len = heatmaps.shape[2]
    ref = jpaf.compute_connections(
        jnp.asarray(pafs), jp, jnp.float32(img_len), CFG,
        jnp.asarray(LIMBS_FROM), jnp.asarray(LIMBS_TO))
    got = tpaf.compute_connections(_t(pafs), _torch_peaks(jp), img_len,
                                   CFG, LIMBS_FROM, LIMBS_TO)
    for name in ("a_slot", "b_slot", "valid"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(ref, name)))
    # Means of 10 float32 products, summed in another order.
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score),
                               atol=1e-5)
    # and against the reference-semantics oracle
    conns = oracle_connections(pafs, ref_peaks, img_len, CFG)
    assert [int(v) for v in got.valid.sum(1)] == [len(c) for c in conns]


def test_greedy_match_planted_ties_match_jax():
    """Quantized scores force exact ties; the first-max (a-major) rule of
    ``torch.argmax`` must reproduce the JAX matcher limb by limb."""
    rng = np.random.RandomState(0)
    n_limbs, k = 24, 8
    score = rng.randint(0, 4, (n_limbs, k, k)).astype(np.float32) / 4.0
    n_a = rng.randint(0, k + 1, n_limbs)
    n_b = rng.randint(0, k + 1, n_limbs)
    valid = rng.rand(n_limbs, k, k) < rng.uniform(0.2, 0.9, (n_limbs, 1, 1))
    for l in range(n_limbs):
        valid[l, n_a[l]:, :] = False
        valid[l, :, n_b[l]:] = False
    got = tpaf.greedy_match(_t(score), _t(valid), _t(n_a), _t(n_b))
    for l in range(n_limbs):
        ref = jpaf.greedy_match(jnp.asarray(score[l]), jnp.asarray(valid[l]),
                                jnp.int32(n_a[l]), jnp.int32(n_b[l]))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[l].numpy(), np.asarray(r),
                                          err_msg=f"limb {l}")


# --------------------------------------------------------- grouping


def _oracle_connections_table(ref_conns, k):
    a = np.full((NUM_LIMBS, k), -1, np.int32)
    b = np.full((NUM_LIMBS, k), -1, np.int32)
    s = np.zeros((NUM_LIMBS, k), np.float32)
    v = np.zeros((NUM_LIMBS, k), bool)
    for l, conns in enumerate(ref_conns):
        for i, (ia, ib, sc) in enumerate(conns):
            a[l, i], b[l, i], s[l, i], v[l, i] = ia, ib, sc, True
    return a, b, s, v


def _assert_subsets_equal(got, ref):
    for name in ("joint_slot", "valid", "spawns_suppressed"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    # Running float32 sums of the same terms in the same order.
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score),
                               atol=1e-5)
    np.testing.assert_allclose(got.count.numpy(), np.asarray(ref.count),
                               atol=1e-5)


@pytest.mark.parametrize("trial", range(5))
def test_grouping_matches_jax_and_numpy_oracle(trial):
    pafs, heatmaps, ref_peaks, jp = _scene_peaks(100 + trial, 2 + trial % 3)
    img_len = heatmaps.shape[2]
    ref_conns = oracle_connections(pafs, ref_peaks, img_len, CFG)
    a, b, s, v = _oracle_connections_table(ref_conns, CFG.max_peaks_per_joint)
    jconn = jpaf.Connections(a_slot=jnp.asarray(a), b_slot=jnp.asarray(b),
                             score=jnp.asarray(s), valid=jnp.asarray(v))
    tconn = tpaf.Connections(a_slot=_t(a).long(), b_slot=_t(b).long(),
                             score=_t(s), valid=_t(v))
    ref = jgroup.group_keypoints(jconn, jp, CFG)
    got = tgroup.group_keypoints(tconn, _torch_peaks(jp), CFG)
    _assert_subsets_equal(got, ref)

    oracle = jgroup.group_keypoints_numpy(ref_conns, np.asarray(jp.score),
                                          CFG)
    rows = sorted(tuple(r["j"]) for r in oracle)
    got_rows = sorted(tuple(int(x) for x in got.joint_slot[i])
                      for i in range(CFG.max_subsets) if bool(got.valid[i]))
    assert got_rows == rows and len(rows) > 0

    poses, pv = tgroup.subsets_to_poses(got, _torch_peaks(jp))
    rposes, rpv = jgroup.subsets_to_poses(ref, jp)
    np.testing.assert_array_equal(poses.numpy(), np.asarray(rposes))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rpv))


def test_grouping_merge_fill_and_capacity_match_jax():
    """Hand-made connections that hit every case: spawn, attach, fill of
    two subsets that share a joint, merge of two disjoint subsets (with the
    count += score quirk), a non-spawning limb, and spawns refused by a
    full table."""
    k = 8
    a = np.full((NUM_LIMBS, k), -1, np.int32)
    b = np.full((NUM_LIMBS, k), -1, np.int32)
    s = np.zeros((NUM_LIMBS, k), np.float32)
    v = np.zeros((NUM_LIMBS, k), bool)

    def add(limb, i, ia, ib, sc):
        a[limb, i], b[limb, i], s[limb, i], v[limb, i] = ia, ib, sc, True

    for i in range(4):
        add(0, i, i, i, 0.9 - 0.1 * i)  # neck->r-hip: 4 spawns
    add(1, 0, 0, 0, 0.7)      # r-hip->r-knee: attach to subset 0
    add(3, 0, 5, 1, 0.6)      # neck->l-hip: spawn subset 4
    add(6, 0, 5, 2, 0.5)      # neck->r-shoulder: attach to subset 4
    add(6, 1, 1, 2, 0.4)      # subsets 1 and 4 share the neck: fill
    add(6, 2, 6, 6, 0.45)     # spawn subset 5
    add(9, 0, 6, 6, 0.8)      # r-shoulder->r-ear: attach to subset 5
    add(9, 1, 7, 7, 0.8)      # no match, and limb 9 never spawns
    add(15, 0, 6, 6, 0.55)    # nose->r-eye: spawn subset 6
    add(17, 0, 6, 6, 0.65)    # r-eye in 6, r-ear in 5, disjoint: merge
    x = np.tile(np.arange(k, dtype=np.float32) * 5, (NUM_JOINTS, 1))
    score = np.random.RandomState(0).uniform(0.1, 0.9, (NUM_JOINTS, k)
                                             ).astype(np.float32)
    jp = jpeaks.Peaks(x=jnp.asarray(x), y=jnp.asarray(x),
                      score=jnp.asarray(score),
                      valid=jnp.ones((NUM_JOINTS, k), bool))
    for cap, suppressed in ((2, True), (8, False)):
        cfg = InferenceConfig(max_peaks_per_joint=k, max_subsets=cap,
                              n_subset_limbs_thresh=2,
                              subset_score_thresh=0.05)
        ref = jgroup.group_keypoints(
            jpaf.Connections(*[jnp.asarray(t) for t in (a, b, s, v)]), jp,
            cfg)
        got = tgroup.group_keypoints(
            tpaf.Connections(_t(a).long(), _t(b).long(), _t(s), _t(v)),
            _torch_peaks(jp), cfg)
        _assert_subsets_equal(got, ref)
        assert (int(got.spawns_suppressed) > 0) == suppressed
    merged = got.joint_slot[5].numpy()
    assert list(merged[[1, 2, 0, 14, 16]]) == [6] * 5    # subset 6 merged
    assert not bool(got.valid[6])


# ------------------------------------------------------ postprocess


@pytest.mark.parametrize("seed,n_people", [(9, 3), (10, 1), (11, 4)])
def test_postprocess_pose_matches_jax(seed, n_people):
    pafs, heatmaps = _render_scene(np.random.RandomState(seed),
                                   n_people=n_people)
    img_len = heatmaps.shape[2]
    ref = jpost.postprocess_pose(jnp.asarray(pafs), jnp.asarray(heatmaps),
                                 img_len, CFG, use_pallas=False)
    got = tpost.postprocess_pose(_t(pafs), _t(heatmaps), img_len, CFG)
    assert_pose_results_equal(got, ref)
    assert bool(got.valid.any())


def assert_pose_results_equal(got, ref):
    """Equal ``PoseResult``s: every field exact except the scores, which
    are float32 sums of terms that may differ by an ulp (atol 1e-5)."""
    for name in ("poses", "valid", "num_peaks", "peaks_dropped",
                 "spawns_suppressed"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(_np(got.scores), _np(ref.scores), atol=1e-5)
