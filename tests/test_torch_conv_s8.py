"""The port's fused int8 1x1/3x3 convolution (``tpupose_torch/ops/
conv_s8.py``) against the JAX package, on the CPU.

``conv_s8_reference`` is held bit for bit to ``tpupose/quant.py::_qconv``
run op by op (its XLA conv route with the epilogue as separate operations);
the kernel's packed weight layout and its K schedule (units of one tap and
32 channels split over the K warps, partial sums added) are emulated in
numpy and held to the integer convolution; the wrapper's limits raise on
every device; and the int8 forward's kernel route equals its im2col route
on CPU tensors.  Every comparison is exact: the integer parts are exact and
both sides round the float32 epilogue in the same order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpupose_torch import quant as tq
from tpupose_torch.detectors.pose import PoseDetector
from tpupose_torch.ops.conv7 import MAX_SMEM_BYTES, im2col_acc_s8
from tpupose_torch.ops.conv_s8 import (NUM_SMS, STAGES, TILE_W, TILES,
                                       UNIT_K, UNITS_PER_WARP, blocks, c_pad,
                                       check_inputs, check_kernel_limits,
                                       conv_s8, conv_s8_reference,
                                       pack_conv_s8_weights, pick_tile,
                                       smem_bytes)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _case(seed, b, h, w, c, o, k):
    """Seeded int8 input (the input layer's full [-128, 127]), kernel,
    mult and bias; the mult puts the epilogue's values around [-60, 120],
    so the ReLU, the rounding and both clips all act."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (b, h, w, c)).astype(np.int8)
    kq = rng.randint(-127, 128, (k, k, c, o)).astype(np.int8)
    acc_std = 74.0 * 73.0 * np.sqrt(k * k * c)
    mult = (rng.uniform(0.5, 1.5, o) * 40.0 / acc_std).astype(np.float32)
    bias = rng.uniform(-20.0, 40.0, o).astype(np.float32)
    return x, kq, mult, bias


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b, h, w, c, o, k, relu", [
    (1, 9, 11, 3, 64, 3, True),       # conv1_1: C = 3 pads to 32
    (2, 7, 5, 64, 32, 3, False),      # B = 2, relu off
    (1, 33, 47, 128, 64, 3, True),    # odd grid, several tiles
    (1, 6, 9, 128, 64, 1, True),      # Mconv6's 1x1
    (2, 5, 3, 32, 96, 1, False),      # 1x1, B = 2, relu off
], ids=["c3", "batched_norelu", "odd_grid", "1x1", "1x1_batched_norelu"])
def test_conv_s8_reference_equals_jax_qconv(b, h, w, c, o, k, relu):
    from tpupose.quant import _qconv

    x, kq, mult, bias = _case(b * h * w + k, b, h, w, c, o, k)
    got = conv_s8_reference(*_torch(x, kq, mult, bias), relu=relu)
    assert got.dtype == torch.int8 and tuple(got.shape) == (b, h, w, o)
    meta = {"ksize": k, "relu": relu, "f32_out": False}
    spec = {"kernel_q": (kq,), "mult": (mult,), "bias_eff": bias}
    ref = _qconv((jnp.asarray(x),), spec, meta, "xla")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the wrapper takes the plain version on CPU tensors
    assert torch.equal(conv_s8(*_torch(x, kq, mult, bias), relu=relu), got)
    out = got.numpy()
    assert 0.2 < (out > 0).mean() < 0.9 and out.min() == 0
    assert out.max() == 127


def _unpack(packed, channels):
    """The inverse of ``pack_conv_s8_weights``: (k*k, O, C_pad) -> HWIO."""
    taps, o, _ = packed.shape
    k = int(round(taps ** 0.5))
    return packed[:, :, :channels].transpose(1, 2).reshape(k, k, channels, o)


@pytest.mark.parametrize("k, c, o", [(3, 3, 64), (3, 40, 32), (1, 128, 64),
                                     (1, 19, 96)])
def test_pack_conv_s8_weights_layout_round_trips(k, c, o):
    """Row (tap, o) of the kernel's layout holds input channels 0..C-1 of
    output o at tap dy * k + dx, zero up to a multiple of 32; unpacking
    gives HWIO back."""
    kq = np.random.RandomState(c).randint(-127, 128, (k, k, c, o)).astype(
        np.int8)
    packed = pack_conv_s8_weights(torch.from_numpy(kq))
    assert packed.dtype == torch.int8
    assert tuple(packed.shape) == (k * k, o, c_pad(c))
    assert packed.shape[2] % UNIT_K == 0
    p = packed.numpy()
    for dy, dx, n in ((0, 0, 0), (k - 1, 0, o // 2), (k - 1, k - 1, o - 1)):
        np.testing.assert_array_equal(p[dy * k + dx, n, :c], kq[dy, dx, :, n])
    assert not p[:, :, c:].any()
    np.testing.assert_array_equal(_unpack(packed, c).numpy(), kq)


def _emulate_kernel_acc(x, packed, k, tile):
    """numpy emulation of the CUDA kernel's K loop: per block tile of
    ``rows`` x ``TILE_W`` pixels and ``tile_n`` channels, the haloed input
    tile (zero outside the image and past C, channels padded to C_pad);
    K cut into units (tap, 32-channel chunk) in tap-major order; per ring
    stage of ``warps_k * UNITS_PER_WARP`` units, K warp kw takes units
    ``d * warps_k + kw`` of the stage, each the tile shifted by the tap and
    cut to the chunk @ packed[tap, channels, chunk]^T into its own partial
    sum; the partials are then added, and pixels outside the image dropped.
    Returns the accumulator and the units each K warp took."""
    b, h, w, c = x.shape
    taps, o, cp = packed.shape
    rows, warps_k, tile_n = TILES[tile]
    r = k // 2
    chunks = cp // UNIT_K
    units = taps * chunks
    stage_units = warps_k * UNITS_PER_WARP
    tiles_h, tiles_w = -(-h // rows), -(-w // TILE_W)
    xp = np.zeros((b, tiles_h * rows + 2 * r, tiles_w * TILE_W + 2 * r, cp),
                  np.int64)
    xp[:, r:r + h, r:r + w, :c] = x
    acc = np.zeros((b, tiles_h * rows, tiles_w * TILE_W, o), np.int64)
    taken = [0] * warps_k
    for ty in range(tiles_h):
        for tx in range(tiles_w):
            y0, x0 = ty * rows, tx * TILE_W
            halo = xp[:, y0:y0 + rows + 2 * r, x0:x0 + TILE_W + 2 * r]
            for n0 in range(0, o, tile_n):
                partial = np.zeros((warps_k, b, rows, TILE_W, tile_n),
                                   np.int64)
                taken = [0] * warps_k
                for step in range(-(-units // stage_units)):
                    for d in range(UNITS_PER_WARP):
                        for kw in range(warps_k):
                            u = step * stage_units + d * warps_k + kw
                            if u >= units:
                                continue
                            taken[kw] += 1
                            tap, chunk = divmod(u, chunks)
                            dy, dx = divmod(tap, k)
                            ks = slice(chunk * UNIT_K, (chunk + 1) * UNIT_K)
                            a = halo[:, dy:dy + rows, dx:dx + TILE_W, ks]
                            wt = packed[tap, n0:n0 + tile_n, ks]
                            partial[kw] += a @ wt.astype(np.int64).T
                acc[:, y0:y0 + rows, x0:x0 + TILE_W,
                    n0:n0 + tile_n] = partial.sum(0)
    return acc[:, :h, :w], taken


@pytest.mark.parametrize("b, h, w, c, k, tile, taken", [
    (1, 9, 13, 64, 3, 0, [5, 5, 4, 4]),    # 18 units over 4 K warps
    (1, 9, 13, 3, 3, 1, [3, 2, 2, 2]),     # conv1_1: 9 units of C_pad 32
    (2, 5, 20, 128, 1, 1, [1, 1, 1, 1]),   # a 1x1 layer keeps 4 K warps
    (1, 11, 17, 96, 3, 2, [14, 13]),       # 27 units over 2 K warps
    (1, 18, 7, 64, 3, 4, [18]),            # one K warp, two ring stages
    (2, 3, 2, 40, 1, 3, [2]),              # 40 channels pad to 64
], ids=["4x16_3x3", "c3_8x16", "1x1_8x16", "8x16_2kw", "16x16_1kw",
        "1x1_c40"])
def test_kernel_k_schedule_emulation_equals_im2col(b, h, w, c, k, tile,
                                                   taken):
    rng = np.random.RandomState(h * w + tile)
    x = rng.randint(-128, 128, (b, h, w, c)).astype(np.int8)
    kq = rng.randint(-127, 128, (k, k, c, 64)).astype(np.int8)
    packed = pack_conv_s8_weights(torch.from_numpy(kq)).numpy()
    got, per_warp = _emulate_kernel_acc(x, packed, k, tile)
    assert per_warp == taken
    ref = im2col_acc_s8(torch.from_numpy(x), torch.from_numpy(kq))
    np.testing.assert_array_equal(got, ref.numpy().astype(np.int64))


def _bad_inputs(case):
    x, kq, mult, bias = _torch(*_case(0, 1, 6, 7, 64, 64, 3))
    if case == "rank":
        x = x[0]
    elif case == "dtype":
        x = x.int()
    elif case == "outputs":
        x, kq, mult, bias = _torch(*_case(0, 1, 6, 7, 64, 48, 3))
    elif case == "ksize":
        x, kq, mult, bias = _torch(*_case(0, 1, 6, 7, 64, 64, 5))
    elif case == "kernel_channels":
        kq = kq[:, :, :32]
    elif case == "mult_dtype":
        mult = mult.double()
    elif case == "shared_memory":
        x, kq, mult, bias = _torch(*_case(0, 1, 3, 4, 2048, 32, 3))
    return x, kq, mult, bias


@pytest.mark.parametrize("case, match", [
    ("rank", "int8 \\(B, H, W, C\\)"), ("dtype", "int8 \\(B, H, W, C\\)"),
    ("outputs", "multiple of 32"), ("ksize", "k in \\(1, 3\\)"),
    ("kernel_channels", "kernel"), ("mult_dtype", "float32"),
    ("shared_memory", "shared memory")])
def test_conv_s8_rejects_what_the_kernel_cannot_take(case, match):
    with pytest.raises(ValueError, match=f"conv_s8: .*{match}"):
        conv_s8(*_bad_inputs(case))
    if case in ("rank", "dtype", "kernel_channels", "mult_dtype"):
        with pytest.raises(ValueError, match="conv_s8"):
            check_inputs(*_bad_inputs(case))


def test_smem_budget_and_tiles():
    """The shared-memory budget of ``csrc/conv_s8.cu`` at each tile, and
    the widest layer of the net (512 channels, 3x3) within a block's limit
    at every tile."""
    # 4 x 16 tile, 3x3 at 64 channels: 6 x 18 pixels at stride 80, the ring
    # of 3 stages x 32 rows x (16 units of 32 bytes + 16), 18 unit offsets
    assert smem_bytes(64, 3, 0) == 6 * 18 * 80 + 3 * 32 * 528 + 4 * 18
    # 8 x 16 tile with 4 K warps: the partial sums outgrow the ring
    assert smem_bytes(512, 3, 1) == (10 * 18 * 528 + 4 * 4 * 2 * 4 * 4 * 32
                                     * 4 + 4 * 144)
    # 16 x 16 tile, one K warp, 1x1 at 128 channels: no halo
    assert smem_bytes(128, 1, 4) == 16 * 16 * 144 + 3 * 64 * 144 + 4 * 4
    assert smem_bytes(512, 3) == max(smem_bytes(512, 3, t)
                                     for t in range(len(TILES)))
    assert smem_bytes(512, 3) <= MAX_SMEM_BYTES
    check_kernel_limits(512, 512, 3)
    assert STAGES == 3
    for rows, warps_k, tile_n in TILES:
        assert rows % 2 == 0 and tile_n % 32 == 0
        assert (rows // 2) * warps_k * 32 <= 1024


# Every conv_s8 layer of the fast int8 path at 368x496 (B, H, W, C, O, k)
FAST_PATH_LAYERS = [
    (1, 368, 496, 3, 64, 3), (1, 368, 496, 64, 64, 3),
    (1, 184, 248, 64, 128, 3), (1, 184, 248, 128, 128, 3),
    (1, 92, 124, 128, 256, 3), (1, 92, 124, 256, 256, 3),
    (1, 46, 62, 256, 512, 3), (1, 46, 62, 512, 512, 3),
    (1, 46, 62, 512, 256, 3), (1, 46, 62, 256, 128, 3),
    (1, 46, 62, 128, 128, 3), (1, 46, 62, 128, 512, 1),
    (1, 46, 62, 128, 128, 1), (2, 736, 984, 64, 64, 3),
    (2, 23, 31, 128, 128, 1)]


@pytest.mark.parametrize("layer", FAST_PATH_LAYERS,
                         ids=lambda s: "x".join(map(str, s)))
def test_pick_tile_fits_the_layer(layer):
    b, h, w, c, o, k = layer
    tile = pick_tile(b, h, w, c, o, k)
    assert 0 <= tile < len(TILES)
    assert o % TILES[tile][2] == 0
    assert smem_bytes(c, k, tile) <= MAX_SMEM_BYTES
    assert blocks(b, h, w, o, tile) >= 1
    if blocks(b, h, w, o, 4) >= 2 * NUM_SMS:
        assert TILES[tile][0] >= 8


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(tq, name)

    def wrapped(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(tq, name, wrapped)
    return calls


def test_quant_apply_kernel_route_equals_im2col_on_cpu(monkeypatch):
    """The whole int8 CocoPoseNet forward on CPU tensors: the kernel route
    (30 conv_s8 layers, 50 conv7 layers, no requant epilogue) equals the
    im2col route (80 requant epilogues) bit for bit."""
    model = PoseDetector(device="cpu", seed=0).model
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.randint(0, 256, (2, 40, 48, 3)).astype(
        np.float32)) / 255.0 - 0.5
    ranges = tq.calibrate_ranges(model, frames)
    qtree, static = tq.quantize("posenet", model, ranges)
    tree = tq.qtree_to_device(qtree, static, "cpu", pack_kernels=True)
    assert sum("conv_s8_packed" in s for s in tree["qlayers"].values()) == 30
    assert sum("conv7_packed" in s for s in tree["qlayers"].values()) == 50
    calls = {name: _counting(monkeypatch, name)
             for name in ("conv_s8", "conv7_s8", "requant_epilogue")}
    with torch.no_grad():
        got = tq.quant_apply(static, tree, frames, "kernel")
        counts = {name: len(c) for name, c in calls.items()}
        ref = tq.quant_apply(static, tree, frames, "im2col")
    assert counts == {"conv_s8": 30, "conv7_s8": 50, "requant_epilogue": 0}
    assert len(calls["requant_epilogue"]) == 80
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got[1].abs().max() > 0
