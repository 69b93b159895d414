"""Parity of the port's w8a8 int8 forward (``tpupose_torch/quant.py``,
``ops/conv7.py``, ``ops/requant.py``) with the JAX package's, on the CPU.

The integer parts are exact, so the port is held to the JAX package bit for
bit wherever the float32 epilogue runs as separate operations on both
sides: the Pallas kernels in interpret mode, and ``quant_apply`` run op by
op (no ``jax.jit``).  A jitted XLA program may fuse the epilogue into
contracted multiply-adds, which moves a value at a .5 rounding boundary by
one int8 step; the tests that go through such a program state their bound.

Tolerances: calibration ranges rtol 1e-5 (float32 forwards in other
summation orders); quantized trees, conv and requant outputs, and the int8
forward's maps exact; pose tables within 5e-3 (float32 map resizes in other
summation orders, as ``tests/test_torch_detector.py``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpupose.config import InferenceConfig
from tpupose_torch import quant as tq
from tpupose_torch.detectors import net as tnet
from tpupose_torch.detectors import pose as tpose
from tpupose_torch.detectors.pose import PoseDetector
from tpupose_torch.ops.conv7 import (K_STEP, NUM_SMS, TAPS_PER_STEP,
                                     TILE_N, TILE_ROWS, TILE_W, blocks,
                                     check_inputs, check_kernel_limits,
                                     conv7_s8, conv7_s8_reference,
                                     im2col_acc_s8, pack_conv7_weights,
                                     pick_tile, smem_bytes)
from tpupose_torch.ops.requant import (requant_epilogue,
                                       requant_epilogue_reference)

CFG = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                      n_subset_limbs_thresh=2, subset_score_thresh=0.05)


def _frame(seed=0, hw=(96, 128)):
    return np.random.RandomState(seed).randint(0, 256, hw + (3,)).astype(
        np.uint8)


def _calib_frames():
    return [_frame(0), _frame(0)[:, ::-1]]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_detector():
    from tpupose.detectors import PoseDetector as JaxPoseDetector
    from tpupose.utils.calibrate import calibrate_output_convs

    jdet = JaxPoseDetector("posenet", cfg=CFG)
    assert calibrate_output_convs(jdet, _frame())
    return jdet


@pytest.fixture(scope="module")
def params(jax_detector):
    return jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jax_detector.variables))


@pytest.fixture(scope="module")
def jax_ranges(jax_detector):
    from tpupose.detectors.pose import preprocess_u8
    from tpupose.quant import calibrate_ranges

    frames = np.stack([_frame(3, (32, 32)), _frame(4, (32, 32))])
    return calibrate_ranges(jax_detector.model, jax_detector.variables,
                            preprocess_u8(jnp.asarray(frames)))


@pytest.fixture(scope="module")
def cpu_detector(params):
    """A float32 CPU detector; the tests that call its ``quantize`` expect
    it to raise before anything changes."""
    return PoseDetector(params=params, cfg=CFG, device="cpu")


@pytest.fixture(scope="module")
def quantized_detector(params):
    det = PoseDetector(params=params, cfg=CFG, device="cpu")
    det.quantize(_calib_frames())
    return det


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# ---------------------------------------------------------------------------
# calibration and the quantized tree
# ---------------------------------------------------------------------------


def test_calibrate_ranges_match_jax(cpu_detector, jax_ranges):
    frames = np.stack([_frame(3, (32, 32)), _frame(4, (32, 32))])
    ranges = tq.calibrate_ranges(
        cpu_detector.model, torch.from_numpy(frames).float() / 255.0 - 0.5)
    assert set(ranges) == set(jax_ranges)
    for path, ref in jax_ranges.items():
        np.testing.assert_allclose(ranges[path], ref, rtol=1e-5,
                                   err_msg=path)


def test_quantize_tree_equals_jax(jax_detector, cpu_detector, jax_ranges):
    from tpupose.quant import quantize as jax_quantize

    jtree, jstatic = jax_quantize("posenet", jax_detector.variables,
                                  jax_ranges)
    jtree = _np_tree(jtree)
    qtree, static = tq.quantize("posenet", cpu_detector.model, jax_ranges)
    assert dataclasses.asdict(static) == dataclasses.asdict(jstatic)
    assert set(qtree["qlayers"]) == set(jtree["qlayers"])
    assert len(qtree["qlayers"]) == 92
    for path, ref in jtree["qlayers"].items():
        got = qtree["qlayers"][path]
        for key in ("kernel_q", "mult"):
            assert len(got[key]) == len(ref[key])
            for a, b in zip(got[key], ref[key]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=f"{path} {key}")
        np.testing.assert_array_equal(got["bias_eff"], ref["bias_eff"],
                                      err_msg=path)
    assert qtree["part_scales"] == jtree["part_scales"]
    assert static.layer_meta["stage2_L1/Mconv1_stage2_L1"]["splits"] == (
        38, 19, 128)


# ---------------------------------------------------------------------------
# the integer convolution, conv7 and the requantize epilogue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b, h, w, c, k, o", [
    (1, 9, 11, 3, 3, 64),     # conv1_1: K = 27 pads to 32
    (2, 5, 4, 64, 3, 19),     # N = 19 pads to 24; B*H*W = 40
    (1, 3, 4, 38, 7, 128),    # M = 12 < 17 pads; 38 channels
    (1, 6, 7, 128, 1, 38),    # a 1x1 head, N = 38 pads to 40
])
def test_im2col_acc_equals_integer_conv(b, h, w, c, k, o):
    from jax import lax

    rng = np.random.RandomState(k * 100 + c)
    x = rng.randint(-128, 128, (b, h, w, c)).astype(np.int8)
    kq = rng.randint(-127, 128, (k, k, c, o)).astype(np.int8)
    ref = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kq), window_strides=(1, 1),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = im2col_acc_s8(torch.from_numpy(x), torch.from_numpy(kq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _conv7_case(seed, b, h, w, channels):
    rng = np.random.RandomState(seed)
    parts = [rng.randint(0, 128, (b, h, w, c)).astype(np.int8)
             for c in channels]
    kernels = [rng.randint(-127, 128, (7, 7, c, 128)).astype(np.int8)
               for c in channels]
    mults = [(np.abs(rng.randn(128)) * 1e-4 + 1e-5).astype(np.float32)
             for _ in channels]
    bias = (rng.randn(128) * 0.01).astype(np.float32)
    return parts, kernels, mults, bias


def _torch_all(*arrays):
    return [[torch.from_numpy(a) for a in arr] if isinstance(arr, list)
            else torch.from_numpy(arr) for arr in arrays]


@pytest.mark.parametrize("seed, b, h, w, channels", [
    (1, 1, 6, 9, (38, 19, 128)),  # Mconv1: three concat groups
    (2, 1, 92, 92, 8),            # a tall grid at reduced width
    (3, 2, 5, 7, 128),            # a grid smaller than the window, B = 2
], ids=["groups3", "tall", "small_batched"])
def test_conv7_reference_equals_jax_kernel_and_qconv(seed, b, h, w,
                                                     channels):
    from tpupose.ops.pallas.conv7 import conv7_s8 as jax_conv7
    from tpupose.quant import _qconv

    channels = channels if isinstance(channels, tuple) else (channels,)
    parts, kernels, mults, bias = _conv7_case(seed, b, h, w, channels)
    got = conv7_s8_reference(*_torch_all(parts, kernels, mults, bias))
    assert got.dtype == torch.int8 and tuple(got.shape) == (b, h, w, 128)
    pallas = jax_conv7(parts, kernels, mults, bias, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    meta = {"ksize": 7, "relu": True, "f32_out": False}
    spec = {"kernel_q": tuple(kernels), "mult": tuple(mults),
            "bias_eff": bias}
    xla = _qconv(tuple(jnp.asarray(p) for p in parts), spec, meta, "xla")
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    # the wrapper takes the plain version on CPU tensors
    via_wrapper = conv7_s8(*_torch_all(parts, kernels, mults, bias))
    assert torch.equal(via_wrapper, got)
    assert (got.numpy() > 0).mean() > 0.2


@pytest.mark.parametrize("groups, relu, lo", [
    (1, True, 0.0), (3, True, 0.0), (3, False, -128.0)])
def test_requant_reference_vs_jax_kernel(groups, relu, lo):
    """s8 equal, except at most one LSB on elements whose pre-round value
    lies within 1e-4 of a .5 boundary (a float32 epilogue in another
    rounding order could move those)."""
    from tpupose.ops.pallas.requant import requant_epilogue as jax_requant

    rng = np.random.RandomState(groups + 10 * relu)
    shape = (1, 23, 31, 128)
    accs = [rng.randint(-2**20, 2**20, shape).astype(np.int32)
            for _ in range(groups)]
    mults = [(np.abs(rng.randn(128)) * 1e-4).astype(np.float32)
             for _ in range(groups)]
    bias = rng.randn(128).astype(np.float32)
    got = requant_epilogue_reference(*_torch_all(accs, mults, bias),
                                     relu=relu, lo=lo).numpy()
    ref = np.asarray(jax_requant([jnp.asarray(a) for a in accs],
                                 [jnp.asarray(m) for m in mults],
                                 jnp.asarray(bias), relu=relu, lo=lo,
                                 interpret=True))
    y = sum(a.astype(np.float64) * m for a, m in zip(accs, mults)) + bias
    near_half = np.abs(np.abs(y - np.floor(y)) - 0.5) < 1e-4
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert not diff[~near_half].any()
    assert got.min() == (0 if relu else -128) and got.max() == 127
    via_wrapper = requant_epilogue(*_torch_all(accs, mults, bias),
                                   relu=relu, lo=lo)
    np.testing.assert_array_equal(via_wrapper.numpy(), got)


def test_pack_conv7_weights_layout():
    """Row (tap, o) of the kernel's layout holds input channels 0..C-1 of
    output o at tap dy * 7 + dx, K contiguous, zero up to a multiple of
    32."""
    rng = np.random.RandomState(7)
    kq = rng.randint(-127, 128, (7, 7, 19, 64)).astype(np.int8)
    packed = pack_conv7_weights(torch.from_numpy(kq)).numpy()
    assert packed.shape == (49, 64, 32) and packed.dtype == np.int8
    for dy, dx, o in ((0, 0, 0), (3, 5, 17), (6, 6, 63)):
        np.testing.assert_array_equal(packed[dy * 7 + dx, o, :19],
                                      kq[dy, dx, :, o])
    assert not packed[:, :, 19:].any()
    want = kq.reshape(49, 19, 64).transpose(0, 2, 1)
    np.testing.assert_array_equal(packed[:, :, :19], want)
    assert pack_conv7_weights(torch.zeros(7, 7, 128, 128,
                                          dtype=torch.int8)).shape == (
        49, 128, 128)


def _emulate_kernel_acc(x, packed, tile):
    """numpy emulation of the CUDA kernel's K loop for one group: per block
    tile of ``TILE_ROWS[tile]`` x ``TILE_W`` pixels and ``TILE_N`` channels,
    the haloed input tile (zero outside the image and past C, channels
    padded to C_pad); per step of ``TAPS_PER_STEP`` taps, warp kw takes tap
    ``TAPS_PER_STEP * step + kw``: the tile shifted by (dy, dx), one k32
    step at a time, @ packed[tap]^T into its own partial sum; the partials
    are then added, and pixels outside the image dropped."""
    b, h, w, c = x.shape
    o, cp = packed.shape[1:]
    rows = TILE_ROWS[tile]
    tiles_h, tiles_w = -(-h // rows), -(-w // TILE_W)
    xp = np.zeros((b, tiles_h * rows + 6, tiles_w * TILE_W + 6, cp),
                  np.int64)
    xp[:, 3:3 + h, 3:3 + w, :c] = x
    acc = np.zeros((b, tiles_h * rows, tiles_w * TILE_W, o), np.int64)
    for ty in range(tiles_h):
        for tx in range(tiles_w):
            y0, x0 = ty * rows, tx * TILE_W
            halo = xp[:, y0:y0 + rows + 6, x0:x0 + TILE_W + 6]
            for n0 in range(0, o, TILE_N):
                partial = np.zeros((TAPS_PER_STEP, b, rows, TILE_W, TILE_N),
                                   np.int64)
                for step in range(-(-49 // TAPS_PER_STEP)):
                    for kw in range(TAPS_PER_STEP):
                        tap = step * TAPS_PER_STEP + kw
                        if tap >= 49:
                            continue
                        dy, dx = divmod(tap, 7)
                        a = halo[:, dy:dy + rows, dx:dx + TILE_W]
                        wt = packed[tap, n0:n0 + TILE_N].astype(np.int64)
                        for kb in range(0, cp, K_STEP):
                            partial[kw] += (a[..., kb:kb + K_STEP]
                                            @ wt[:, kb:kb + K_STEP].T)
                acc[:, y0:y0 + rows, x0:x0 + TILE_W,
                    n0:n0 + TILE_N] = partial.sum(0)
    return acc[:, :h, :w]


@pytest.mark.parametrize("b, h, w, channels, tile", [
    (1, 9, 13, (38, 19, 128), 0),   # Mconv1's groups, a ragged 4x16 tile
    (1, 9, 13, (38, 19, 128), 1),
    (2, 5, 4, (38, 19, 128), 0),    # a grid smaller than the window
    (1, 3, 2, (128,), 1),
], ids=["mconv1_4x16", "mconv1_8x16", "small_batched", "tiny"])
def test_kernel_k_loop_emulation_equals_im2col(b, h, w, channels, tile):
    rng = np.random.RandomState(h * w + tile)
    for c in channels:
        x = rng.randint(-128, 128, (b, h, w, c)).astype(np.int8)
        kq = rng.randint(-127, 128, (7, 7, c, 64)).astype(np.int8)
        packed = pack_conv7_weights(torch.from_numpy(kq)).numpy()
        got = _emulate_kernel_acc(x, packed, tile)
        ref = im2col_acc_s8(torch.from_numpy(x), torch.from_numpy(kq))
        np.testing.assert_array_equal(got, ref.numpy().astype(np.int64))


@pytest.mark.parametrize("b, h, w, o, rows", [
    (1, 23, 31, 128, 4), (1, 46, 62, 128, 8), (1, 69, 92, 128, 8),
    (1, 92, 123, 128, 8), (2, 23, 31, 128, 4), (2, 46, 62, 128, 8),
    (1, 5, 7, 64, 4)])
def test_pick_tile_takes_8_rows_from_half_a_wave(b, h, w, o, rows):
    tile = pick_tile(b, h, w, o)
    assert TILE_ROWS[tile] == rows
    assert (blocks(b, h, w, o, TILE_ROWS.index(8)) >= NUM_SMS // 2) == (
        rows == 8)
    assert smem_bytes((38, 19, 128), tile) <= smem_bytes((38, 19, 128))


def _bad_conv7_inputs(case):
    parts, kernels, mults, bias = _torch_all(
        *_conv7_case(0, 1, 5, 6, (38, 128)))
    if case == "height":
        parts[1] = parts[1][:, :4].contiguous()
    elif case == "kernel":
        kernels[0] = kernels[0][:, :, :37]
    elif case == "mult_dtype":
        mults[1] = mults[1].double()
    elif case == "groups":
        mults = mults[:1]
    return parts, kernels, mults, bias


@pytest.mark.parametrize("case", ["height", "kernel", "mult_dtype",
                                  "groups"])
def test_conv7_rejects_inputs_that_do_not_fit(case):
    with pytest.raises(ValueError, match="conv7_s8"):
        check_inputs(*_bad_conv7_inputs(case))
    with pytest.raises(ValueError, match="conv7_s8"):
        conv7_s8(*_bad_conv7_inputs(case))


def test_conv7_kernel_limits():
    check_kernel_limits((38, 19, 128), 128)
    check_kernel_limits((128,), 96)
    check_kernel_limits((288,), 64)          # the widest C that fits
    # the largest tile: (8 + 6) x 22 pixels at a stride of C_pad + 16
    # bytes, then the int32 partial sums of 4 x 4 warps, which outgrow the
    # ring of 3 x 4 x 32 weight rows
    assert smem_bytes((38, 19, 128)) == 14 * 22 * 144 + 4 * 4 * 32 * 32 * 4
    assert smem_bytes((38, 19), 0) == 10 * 22 * 80 + 4 * 2 * 32 * 32 * 4
    assert smem_bytes((128,), 0) == (10 * 22 + 3 * 4 * 32) * 144
    with pytest.raises(ValueError, match="shared memory"):
        check_kernel_limits((38, 320), 128)
    with pytest.raises(ValueError, match="shared memory"):
        check_kernel_limits((38, 8192), 128)
    with pytest.raises(ValueError, match="multiple of 32"):
        check_kernel_limits((128,), 48)
    with pytest.raises(ValueError, match="groups"):
        check_kernel_limits((8,) * 5, 128)


# ---------------------------------------------------------------------------
# the whole int8 forward and the detector
# ---------------------------------------------------------------------------


def test_quant_forward_equals_jax(jax_detector, params, jax_ranges):
    """The full int8 forward on one tree at 88x104, against the JAX
    ``quant_apply`` run op by op: every stage's maps equal."""
    from tpupose.detectors.pose import preprocess_u8
    from tpupose.quant import quant_apply, quantize as jax_quantize

    jtree, static = jax_quantize("posenet", jax_detector.variables,
                                 jax_ranges)
    img = _frame(15, (88, 104))
    jpafs, jhms = quant_apply(static, jtree,
                              preprocess_u8(jnp.asarray(img))[None])
    tree = tq.qtree_to_device(_np_tree(jtree), static, "cpu")
    x = tpose.preprocess_u8(torch.from_numpy(img))[None]
    with torch.no_grad():
        pafs, hms = tq.quant_apply(static, tree, x)
    assert tuple(pafs.shape) == (6, 1, 11, 13, 38)
    np.testing.assert_array_equal(pafs.numpy(), np.asarray(jpafs))
    np.testing.assert_array_equal(hms.numpy(), np.asarray(jhms))
    with torch.no_grad():
        via_kernel_route = tq.make_quant_apply(static, tree, "kernel")(x)
    assert torch.equal(via_kernel_route[0], pafs)


def test_quantized_detector_matches_jax(params, quantized_detector,
                                        monkeypatch):
    """``quantize()`` on the same calibration frames builds the JAX
    detector's tree (kernels equal; scales from the port's own float32
    calibration within 1e-5).  Fed the same ranges, the two quantized
    detectors give the same pose tables (the JAX one run op by op)."""
    from tpupose.detectors import PoseDetector as JaxPoseDetector
    import tpupose.quant as jq

    seen = {}
    jax_calibrate = jq.calibrate_ranges

    def keep_ranges(*args, **kwargs):
        seen["ranges"] = jax_calibrate(*args, **kwargs)
        return seen["ranges"]

    monkeypatch.setattr(jq, "calibrate_ranges", keep_ranges)
    jdet = JaxPoseDetector("posenet", cfg=CFG, params=params)
    jdet.quantize(_calib_frames())
    jtree = _np_tree(jdet.variables)

    own = quantized_detector
    assert own.conv7_impl == "im2col" and own._quant_min_side == 0
    for path, ref in jtree["qlayers"].items():
        got = own.qtree["qlayers"][path]
        for a, b in zip(got["kernel_q"], ref["kernel_q"]):
            np.testing.assert_array_equal(a, b, err_msg=path)
        for a, b in zip(got["mult"], ref["mult"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=path)

    monkeypatch.setattr(tnet, "calibrate_ranges",
                        lambda model, frames: seen["ranges"])
    det = PoseDetector(params=params, cfg=CFG, device="cpu")
    det.quantize(_calib_frames())
    for path, ref in jtree["qlayers"].items():
        np.testing.assert_array_equal(det.qtree["qlayers"][path]["bias_eff"],
                                      ref["bias_eff"], err_msg=path)
    with jax.disable_jit():
        ref_poses, ref_scores = jdet(_frame(1))
    poses, scores = det(_frame(1))
    assert len(poses) >= 1
    _assert_pose_tables_match(poses, scores, ref_poses, ref_scores)


def _assert_pose_tables_match(got_poses, got_scores, ref_poses, ref_scores,
                              atol=5e-3):
    assert len(got_poses) == len(ref_poses)
    remaining = list(range(len(ref_poses)))
    for gp, gs in zip(got_poses, got_scores):
        match = next((i for i in remaining
                      if np.abs(ref_poses[i] - gp).max() <= atol
                      and abs(ref_scores[i] - gs) <= atol), None)
        assert match is not None, f"unmatched pose (score {gs})"
        remaining.remove(match)


@pytest.mark.parametrize("conv7_impl, error", [
    ("kernel", "CUDA kernel"), ("xla", "no int8 convolution"),
    ("pallas", "unknown conv7_impl")])
def test_quantize_rejects_routes_a_cpu_detector_cannot_run(cpu_detector,
                                                           conv7_impl,
                                                           error):
    with pytest.raises(ValueError, match=error):
        cpu_detector.quantize([_frame()], conv7_impl=conv7_impl)
    assert not cpu_detector.quantized


def test_quantized_detector_runs_im2col_and_rejects_a_second_quantize(
        quantized_detector):
    assert quantized_detector.conv7_impl == "im2col"
    poses, _ = quantized_detector(_frame(1))
    assert poses.shape[1:] == (18, 3) and len(poses) >= 1
    with pytest.raises(ValueError, match="already quantized"):
        quantized_detector.quantize(_calib_frames())


def test_min_side_mixed_precision(params, cpu_detector, quantized_detector):
    """Forwards whose input's short side is below ``min_side`` keep the
    float32 model bit for bit; the others run int8."""
    mixed = PoseDetector(params=params, cfg=CFG, device="cpu")
    mixed.quantize(_calib_frames(), min_side=64)
    small = torch.from_numpy(_frame(11, (48, 48))).float() / 255.0 - 0.5
    large = torch.from_numpy(_frame(11, (96, 96))).float() / 255.0 - 0.5
    with torch.no_grad():
        for x, same_as, differs_from in (
                (small[None], cpu_detector, quantized_detector),
                (large[None], quantized_detector, cpu_detector)):
            got = mixed._forward(x)[1]
            assert torch.equal(got, same_as._forward(x)[1])
            assert not torch.equal(got, differs_from._forward(x)[1])
    poses, _ = mixed(_frame(1))
    assert poses.shape[1:] == (18, 3)


def test_precise_quantized_detect_batch_equals_call(params):
    cfg = dataclasses.replace(CFG, scales=(1.0, 1.5))
    det = PoseDetector(params=params, cfg=cfg, precise=True, device="cpu")
    det.quantize(_calib_frames())
    frames = np.stack([_frame(0), _frame(1)])
    batch = det.detect_batch(frames)
    for frame, (poses, scores) in zip(frames, batch):
        ref_poses, ref_scores = det(frame)
        _assert_pose_tables_match(poses, scores, ref_poses, ref_scores,
                                  atol=1e-4)
    assert sum(len(p) for p, _ in batch) >= 1
