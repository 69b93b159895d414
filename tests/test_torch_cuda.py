"""Tests of the port that need an NVIDIA GPU; they skip without one.

This file imports neither JAX nor the JAX test helpers, so it also runs on
a machine without JAX:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Each kernel must equal its plain PyTorch version bit for bit (it rounds
every product and sum as PyTorch's eager ops do), the detector on the card
must find the pose table the CPU finds from the same weights, and the card's
int8 forward must equal the CPU's int8 forward bit for bit.
"""

import collections

import numpy as np
import pytest
import torch

from tpupose_torch.config import InferenceConfig
from tpupose_torch.detectors.pose import PoseDetector
from tpupose_torch.ops import blur_nms as bn
from tpupose_torch.ops import conv7 as c7
from tpupose_torch.ops import conv_s8 as cs
from tpupose_torch.ops import requant as rq
from tpupose_torch.utils.calibrate import calibrate_output_convs

from postprocess_cases import (FOLD_CASES, MATCH_CASES, WIDE_SLOTS,
                               crowd_tables, fold_tables, match_tables)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planted(rng, j, h, w):
    hm = rng.rand(j, h, w).astype(np.float32) * 0.3
    for c in range(j):
        for _ in range(3):
            y, x = rng.randint(2, h - 2), rng.randint(2, w - 2)
            hm[c, y, x] += rng.uniform(0.5, 1.0)
    return hm


@pytest.mark.parametrize("shape", [(18, 320, 432), (18, 480, 640),
                                   (18, 46, 62), (3, 7, 9), (18, 584, 584),
                                   (18, 321, 433), (2, 5, 300), (2, 300, 5),
                                   (144, 320, 432)])
def test_blur_nms_kernel_matches_reference(cuda_device, shape):
    x = torch.from_numpy(_planted(np.random.RandomState(5), *shape)).to(
        cuda_device)
    before = bn.blur_nms.launches
    s, m = bn.blur_nms(x, 2.5, 0.05)
    rs, rm = bn.blur_nms_reference(x, 2.5, 0.05)
    torch.cuda.synchronize()
    assert bn.blur_nms.launches == before + 1
    assert torch.equal(s, rs)
    assert torch.equal(m, rm)


def test_blur_nms_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(2, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        bn.blur_nms(x.double(), 2.5, 0.05)
    with pytest.raises(ValueError, match="contiguous"):
        bn.blur_nms(x.transpose(1, 2), 2.5, 0.05)


def test_cuda_detector_matches_cpu(cuda_device):
    """Same weights on the card and the CPU: the maps agree to float32
    noise, and the card's postprocess on those maps gives the CPU's pose
    table.  (Whole pose tables from the two forwards are not compared: a
    1e-5 map difference may flip a near-threshold peak or limb.)"""
    from tpupose_torch.detectors.pose import results_to_host
    from tpupose_torch.ops.postprocess import postprocess_pose

    cfg = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    frame = np.random.RandomState(0).randint(0, 256, (96, 128, 3)).astype(
        np.uint8)
    cpu = PoseDetector(cfg=cfg, device="cpu", seed=0)
    assert calibrate_output_convs(cpu, frame)
    card = PoseDetector(cfg=cfg, device=cuda_device, seed=1)
    card.model.load_state_dict(cpu.model.state_dict())
    (paf, hm), _ = card.compute_maps(frame)
    (cpaf, chm), _ = cpu.compute_maps(frame)
    for got, ref in ((paf, cpaf), (hm, chm)):
        # float32 in other summation orders; TF32 would miss by ~1e-3.
        scale = ref.abs().max().item()
        assert (got.cpu() - ref).abs().max().item() <= 1e-4 * scale

    before = bn.blur_nms.launches
    with torch.no_grad():
        on_card, on_cpu = (results_to_host([postprocess_pose(
            p, h, paf.shape[-1], cfg)])[0] for p, h in ((paf, hm),
                                                         (paf.cpu(), hm.cpu())))
    assert bn.blur_nms.launches == before + 1
    for name in ("poses", "valid", "num_peaks", "peaks_dropped",
                 "spawns_suppressed"):
        np.testing.assert_array_equal(getattr(on_card, name),
                                      getattr(on_cpu, name), err_msg=name)
    np.testing.assert_allclose(on_card.scores, on_cpu.scores, atol=1e-5)
    assert on_card.valid.sum() >= 1
    poses, _ = card(frame)
    assert poses.shape[0] >= 1


def _conv7_case(rng, b, h, w, channels, device, o=128):
    def put(a):
        return torch.from_numpy(a).to(device)

    parts = [put(rng.randint(0, 128, (b, h, w, c)).astype(np.int8))
             for c in channels]
    kernels = [put(rng.randint(-127, 128, (7, 7, c, o)).astype(np.int8))
               for c in channels]
    mults = [put((np.abs(rng.randn(o)) * 1e-4 + 1e-5).astype(np.float32))
             for _ in channels]
    bias = put((rng.randn(o) * 0.01).astype(np.float32))
    return parts, kernels, mults, bias


PYRAMID_GRIDS = ((23, 31), (46, 62), (69, 92), (92, 123))
MCONV1 = (38, 19, 128)


@pytest.mark.parametrize("bhw, channels", [
    *[((b, *hw), channels) for hw in PYRAMID_GRIDS
      for channels in (MCONV1, (128,)) for b in (1, 2, 3)],
    ((1, 47, 61), MCONV1), ((2, 47, 61), (128,)),   # ragged tiles
    ((1, 5, 7), (128,)), ((3, 5, 7), MCONV1)])      # smaller than the window
def test_conv7_kernel_matches_reference(cuda_device, bhw, channels):
    parts, kernels, mults, bias = _conv7_case(
        np.random.RandomState(sum(bhw)), *bhw, channels, cuda_device)
    before = c7.conv7_s8.launches
    got = c7.conv7_s8(parts, kernels, mults, bias)
    ref = c7.conv7_s8_reference(parts, kernels, mults, bias)
    torch.cuda.synchronize()
    assert c7.conv7_s8.launches == before + 1
    assert torch.equal(got, ref)
    cpu = c7.conv7_s8_reference([p.cpu() for p in parts],
                                [k.cpu() for k in kernels],
                                [m.cpu() for m in mults], bias.cpu())
    assert torch.equal(ref.cpu(), cpu)
    assert 0.2 < (cpu > 0).float().mean().item() < 0.8


@pytest.mark.parametrize("tile", range(len(c7.TILE_ROWS)))
@pytest.mark.parametrize("channels, o", [(MCONV1, 128), ((128,), 128),
                                         ((128,), 64), ((40, 16), 32)])
def test_conv7_kernel_every_tile_matches_reference(cuda_device, tile,
                                                   channels, o):
    """Each block tile of the kernel, also at O = 64 and 32 and with a group
    of 16 channels (whole 16-byte chunks, zero-padded to 32), on a grid
    that is a multiple of no tile; relu off."""
    parts, kernels, mults, bias = _conv7_case(
        np.random.RandomState(tile), 2, 19, 37, channels, cuda_device, o)
    bias = bias - 0.3
    got = c7.conv7_s8(parts, kernels, mults, bias, relu=False, tile=tile)
    ref = c7.conv7_s8_reference(parts, kernels, mults, bias, relu=False)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_conv7_rejects_what_the_kernel_does_not_take(cuda_device):
    parts, kernels, mults, bias = _conv7_case(
        np.random.RandomState(0), 1, 8, 8, (128,), cuda_device)
    buf = torch.zeros(parts[0].numel() + 1, dtype=torch.int8,
                      device=cuda_device)
    shifted = buf[1:].view(parts[0].shape)
    with pytest.raises(ValueError, match="aligned"):
        c7.conv7_s8([shifted], kernels, mults, bias)
    with pytest.raises(ValueError, match="contiguous"):
        c7.conv7_s8([parts[0].transpose(1, 2)], kernels, mults, bias)
    with pytest.raises(ValueError, match="tile"):
        c7.conv7_s8(parts, kernels, mults, bias, tile=len(c7.TILE_ROWS))
    with pytest.raises(ValueError, match="packed"):
        c7.conv7_s8(parts, kernels, mults, bias,
                    packed=[c7.pack_conv7_weights(kernels[0]).view(
                        torch.int32)])


def _conv_s8_case(rng, b, h, w, c, o, k, device):
    """Inputs over the input layer's [-128, 127]; the mult puts the
    epilogue's values around [-60, 120], so every clip acts."""
    def put(a):
        return torch.from_numpy(a).to(device)

    acc_std = 74.0 * 73.0 * (k * k * c) ** 0.5
    return (put(rng.randint(-128, 128, (b, h, w, c)).astype(np.int8)),
            put(rng.randint(-127, 128, (k, k, c, o)).astype(np.int8)),
            put((rng.uniform(0.5, 1.5, o) * 40.0 / acc_std).astype(
                np.float32)),
            put(rng.uniform(-20.0, 40.0, o).astype(np.float32)))


# Every distinct conv_s8 layer of the fast int8 path at 368x496 (stem,
# stage 1, Mconv6) as (B, H, W, C, O, k), and conv1_2 at the precise path's
# largest canvas.
CONV_S8_LAYERS = [
    (1, 368, 496, 3, 64, 3), (1, 368, 496, 64, 64, 3),
    (1, 184, 248, 64, 128, 3), (1, 184, 248, 128, 128, 3),
    (1, 92, 124, 128, 256, 3), (1, 92, 124, 256, 256, 3),
    (1, 46, 62, 256, 512, 3), (1, 46, 62, 512, 512, 3),
    (1, 46, 62, 512, 256, 3), (1, 46, 62, 256, 128, 3),
    (1, 46, 62, 128, 128, 3), (1, 46, 62, 128, 512, 1),
    (1, 46, 62, 128, 128, 1), (2, 736, 984, 64, 64, 3)]


@pytest.mark.parametrize("layer", CONV_S8_LAYERS,
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_s8_kernel_matches_reference(cuda_device, layer):
    x, kq, mult, bias = _conv_s8_case(np.random.RandomState(sum(layer)),
                                      *layer, cuda_device)
    before = cs.conv_s8.launches
    got = cs.conv_s8(x, kq, mult, bias)
    ref = cs.conv_s8_reference(x, kq, mult, bias)
    torch.cuda.synchronize()
    assert cs.conv_s8.launches == before + 1
    assert torch.equal(got, ref)
    assert 0.2 < (ref > 0).float().mean().item() < 0.9


@pytest.mark.parametrize("tile", range(len(cs.TILES)))
@pytest.mark.parametrize("c, o, k", [(3, 64, 3), (64, 64, 3), (128, 128, 3),
                                     (40, 64, 1), (128, 512, 1)])
def test_conv_s8_kernel_every_tile_matches_reference(cuda_device, tile, c,
                                                     o, k):
    """Each block tile of the kernel on a grid that is a multiple of no
    tile, at B = 2 and no activation (a signed store); 40 channels stage
    as whole 16-byte chunks zero-padded to 64."""
    x, kq, mult, bias = _conv_s8_case(np.random.RandomState(tile), 2, 19,
                                      37, c, o, k, cuda_device)
    got = cs.conv_s8(x, kq, mult, bias, act="none", tile=tile)
    ref = cs.conv_s8_reference(x, kq, mult, bias, act="none")
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("act", ["none", "relu", "prelu"])
@pytest.mark.parametrize("channels, o, k", [
    ((64,), 64, 3), ((128, 52), 128, 3), ((128, 26, 52), 96, 3),
    ((96, 96, 96), 256, 1)], ids=["g1", "g2", "g3", "g3_1x1"])
def test_conv_s8_kernel_groups_and_activations_match_plain(
        cuda_device, channels, o, k, act):
    """The kernel over G input groups (BODY_25's concatenations) and each
    activation at every tile it takes, on a ragged grid at B = 2, against
    its plain version; PReLU slopes of both signs."""
    rng = np.random.RandomState(len(channels) + k)
    cases = [_conv_s8_case(rng, 2, 19, 37, c, o, k, cuda_device)
             for c in channels]
    parts, kernels = [c[0] for c in cases], [c[1] for c in cases]
    mults, bias = [c[2] for c in cases], cases[0][3] - 20.0
    slope = (torch.from_numpy(rng.uniform(-0.5, 1.5, o).astype(np.float32))
             .to(cuda_device) if act == "prelu" else None)
    ref = cs.conv_s8_reference(parts, kernels, mults, bias, act, slope)
    tiles = [t for t, (_, _, n) in enumerate(cs.TILES) if o % n == 0
             and (len(channels) == 1 or t in cs.GROUPED_TILES)]
    for tile in tiles:
        got = cs.conv_s8(parts, kernels, mults, bias, act, slope, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), cs.TILES[tile]
    if len(channels) > 1:
        with pytest.raises(ValueError, match="groups take"):
            cs.conv_s8(parts, kernels, mults, bias, act, slope, tile=3)


def test_conv_s8_rejects_what_the_kernel_does_not_take(cuda_device):
    x, kq, mult, bias = _conv_s8_case(np.random.RandomState(0), 1, 8, 8,
                                      64, 32, 3, cuda_device)
    buf = torch.zeros(x.numel() + 1, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        cs.conv_s8(buf[1:].view(x.shape), kq, mult, bias)
    with pytest.raises(ValueError, match="contiguous"):
        cs.conv_s8(x.transpose(1, 2), kq, mult, bias)
    with pytest.raises(ValueError, match="tile"):
        cs.conv_s8(x, kq, mult, bias, tile=len(cs.TILES))
    with pytest.raises(ValueError, match="tile"):   # 64-channel tile, O 32
        cs.conv_s8(x, kq, mult, bias, tile=4)
    with pytest.raises(ValueError, match="packed"):
        cs.conv_s8(x, kq, mult, bias,
                   packed=cs.pack_conv_s8_weights(kq).view(torch.int32))
    with pytest.raises(ValueError, match="multiple of 32"):
        cs.conv_s8(x, kq[..., :24], mult[:24], bias[:24])


@pytest.mark.parametrize("shape, groups, relu, lo", [
    ((1, 368, 496, 64), 1, True, 0.0), ((1, 184, 248, 64), 1, True, 0.0),
    ((2, 736, 984, 64), 1, True, 0.0), ((1, 46, 62, 128), 1, True, 0.0),
    ((1, 46, 62, 128), 3, False, -128.0)])
def test_requant_kernel_matches_reference(cuda_device, shape, groups, relu,
                                          lo):
    rng = np.random.RandomState(groups)
    accs = [torch.from_numpy(rng.randint(-2**20, 2**20, shape).astype(
        np.int32)).to(cuda_device) for _ in range(groups)]
    mults = [torch.from_numpy((np.abs(rng.randn(shape[-1])) * 1e-4).astype(
        np.float32)).to(cuda_device) for _ in range(groups)]
    bias = torch.from_numpy(rng.randn(shape[-1]).astype(np.float32)).to(
        cuda_device)
    before = rq.requant_epilogue.launches
    got = rq.requant_epilogue(accs, mults, bias, relu, lo)
    ref = rq.requant_epilogue_reference(accs, mults, bias, relu, lo)
    torch.cuda.synchronize()
    assert rq.requant_epilogue.launches == before + 1
    assert torch.equal(got, ref)
    assert got.min().item() == lo and got.max().item() == 127


@pytest.mark.parametrize("act", ["none", "prelu"])
@pytest.mark.parametrize("shape, groups", [
    ((1, 46, 82, 96), 1), ((1, 46, 82, 128), 3), ((2, 19, 37, 256), 2)])
def test_requant_kernel_activations_match_reference(cuda_device, shape,
                                                    groups, act):
    """The kernel's signed stores (BODY_25's im2col route): PReLU with
    slopes of both signs, and no activation, each in [-127, 127], against
    the plain version bit for bit; one launch, counted under its act."""
    rng = np.random.RandomState(groups + len(act))
    accs = [torch.from_numpy(rng.randint(-2**20, 2**20, shape).astype(
        np.int32)).to(cuda_device) for _ in range(groups)]
    mults = [torch.from_numpy((np.abs(rng.randn(shape[-1])) * 1e-4).astype(
        np.float32)).to(cuda_device) for _ in range(groups)]
    bias = torch.from_numpy(rng.randn(shape[-1]).astype(np.float32)).to(
        cuda_device)
    slope = (torch.from_numpy(rng.uniform(-0.5, 1.5, shape[-1]).astype(
        np.float32)).to(cuda_device) if act == "prelu" else None)
    before = rq.requant_epilogue.shapes[(shape, groups, act, -127.0)]
    got = rq.act_epilogue(accs, mults, bias, act, slope)
    ref = rq.act_epilogue_reference(accs, mults, bias, act, slope)
    torch.cuda.synchronize()
    assert rq.requant_epilogue.shapes[(shape, groups, act, -127.0)] == \
        before + 1
    assert torch.equal(got, ref)
    assert got.min().item() == -127 and got.max().item() == 127
    if act == "prelu":
        with pytest.raises(ValueError, match="slope"):
            rq.act_epilogue(accs, mults, bias, act, None)


@pytest.mark.parametrize("m, k, n", [
    (5, 27, 19), (16, 8, 8), (17, 27, 64), (40, 576, 38), (713, 64, 40),
    (2852, 32, 128), (2852, 6272, 128), (524289, 27, 64)])
def test_int_mm_padding_is_exact(cuda_device, m, k, n):
    """``torch._int_mm`` on CUDA asks for K, N multiples of 8 and rejects
    some shapes whose M is not a multiple of 32; the helper pads with zeros
    and cuts the result back."""
    rng = np.random.RandomState(m)
    a = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-128, 128, (k, n)).astype(np.int8))
    got = c7.int_mm(a.to(cuda_device), b.to(cuda_device)).cpu()
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got.double(), a.double() @ b.double())


def test_int8_forward_on_the_card_equals_the_cpu(cuda_device):
    """The whole int8 CocoPoseNet forward, kernel route on the card (every
    int8 layer but the heads on conv7 or conv_s8) against the plain route on
    the CPU, same tree: every stage's maps equal."""
    from tpupose_torch import quant as tq

    model = PoseDetector(device="cpu", seed=0).model
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.randint(0, 256, (2, 64, 80, 3)).astype(
        np.float32)) / 255.0 - 0.5
    ranges = tq.calibrate_ranges(model, frames)
    qtree, static = tq.quantize("posenet", model, ranges)
    card = tq.make_quant_apply(static, tq.qtree_to_device(
        qtree, static, cuda_device, "kernel"), "kernel")
    host = tq.make_quant_apply(static, tq.qtree_to_device(qtree, static,
                                                          "cpu"))
    c7.conv7_s8.launches = cs.conv_s8.launches = 0
    rq.requant_epilogue.launches = 0
    with torch.no_grad():
        pafs, hms = card(frames.to(cuda_device))
        torch.cuda.synchronize()
        assert (c7.conv7_s8.launches, cs.conv_s8.launches,
                rq.requant_epilogue.launches) == (50, 30, 0)
        cpafs, chms = host(frames)
    assert torch.equal(pafs.cpu(), cpafs)
    assert torch.equal(hms.cpu(), chms)


def test_body25_int8_im2col_route_on_the_card_equals_the_cpu(cuda_device):
    """BODY_25's int8 forward on the im2col route on the card: every one
    of its 108 non-head layers finishes on ``csrc/requant.cu`` (98 of them
    with the PReLU epilogue), no conv kernel runs, and every stage's maps
    equal the kernel route's and the CPU's."""
    from tpupose_torch import quant as tq
    from tpupose_torch.models.body25 import Body25Net

    model = Body25Net(seed=3).eval()
    rng = np.random.RandomState(5)
    frames = torch.from_numpy(rng.randint(0, 256, (2, 64, 96, 3)).astype(
        np.float32)) / 255.0 - 0.5
    ranges = tq.calibrate_ranges(model, frames)
    qtree, static = tq.quantize("body25", model, ranges)
    tree = tq.qtree_to_device(qtree, static, cuda_device, "kernel")
    host = tq.qtree_to_device(qtree, static, "cpu")
    x = frames[:1]
    c7.conv7_s8.launches = cs.conv_s8.launches = 0
    rq.requant_epilogue.launches = 0
    rq.requant_epilogue.shapes.clear()
    with torch.no_grad():
        im2col = tq.quant_apply(static, tree, x.to(cuda_device), "im2col")
        torch.cuda.synchronize()
        assert (c7.conv7_s8.launches, cs.conv_s8.launches,
                rq.requant_epilogue.launches) == (0, 0, 108)
        acts = collections.Counter()
        for (_, _, act, _), n in rq.requant_epilogue.shapes.items():
            acts[act] += n
        assert acts == {"prelu": 98, "relu": 10}
        kernel = tq.quant_apply(static, tree, x.to(cuda_device), "kernel")
        cpu = tq.quant_apply(static, host, x, "im2col")
    for i, k, c in zip(im2col, kernel, cpu):
        assert torch.equal(i, k)
        assert torch.equal(i.cpu(), c)
    assert float(im2col[1][-1].abs().max()) > 0


def test_quantized_precise_detector_on_the_card(cuda_device):
    cfg = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    frame = np.random.RandomState(0).randint(0, 256, (96, 128, 3)).astype(
        np.uint8)
    det = PoseDetector(cfg=cfg, device=cuda_device, seed=0, precise=True)
    assert calibrate_output_convs(det, frame)
    det.quantize([frame, frame[:, ::-1]])
    assert det.conv7_impl == "kernel"
    c7.conv7_s8.shapes.clear()
    poses, _ = det(frame)
    batch = det.detect_batch(np.stack([frame, frame]))
    assert len({key[1:3] for key in c7.conv7_s8.shapes}) == 4
    for got, _ in batch:
        assert got.shape == poses.shape
    with pytest.raises(ValueError, match="already quantized"):
        det.quantize([frame])


# ---------------------------------------------------------------------------
# blur_nms above radius 16, find_peaks and the matcher's ties on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, sigma", [
    ((18, 320, 432), 5.0), ((18, 320, 432), 8.0),    # radius 20 and 32
    ((3, 7, 9), 4.25), ((2, 33, 131), 6.0),          # 17; ragged, 24
    ((2, 5, 300), 7.0), ((2, 300, 5), 7.75),         # thin: 28, 31
    ((1, 20, 30), 63.75)])                           # radius 255, the last
def test_blur_nms_kernel_above_radius_16_matches_reference(cuda_device,
                                                           shape, sigma):
    x = torch.from_numpy(_planted(np.random.RandomState(7), *shape)).to(
        cuda_device)
    before = bn.blur_nms.launches
    s, m = bn.blur_nms(x, sigma, 0.05)
    rs, rm = bn.blur_nms_reference(x, sigma, 0.05)
    torch.cuda.synchronize()
    assert bn.blur_nms.launches == before + 1
    assert torch.equal(s, rs)
    assert torch.equal(m, rm)


def test_blur_nms_names_its_radius_limit(cuda_device):
    x = torch.zeros(1, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="radii up to 255"):
        bn.blur_nms(x, 64.0, 0.05)


def test_find_peaks_at_sigma_5_on_the_card_equals_the_cpu(cuda_device):
    from tpupose_torch.ops.peaks import find_peaks

    hm = torch.from_numpy(_planted(np.random.RandomState(8), 18, 46, 62))
    before = bn.blur_nms.launches
    got = find_peaks(hm.to(cuda_device), 5.0, 0.05, 32)
    ref = find_peaks(hm, 5.0, 0.05, 32)
    assert bn.blur_nms.launches == before + 1
    for name in ("x", "y", "score", "valid", "dropped"):
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name)), name
    assert int(ref.valid.sum()) > 0


def test_greedy_match_planted_ties_on_the_card_equal_the_cpu(cuda_device):
    """The ties of ``tests/test_torch_ops.py``'s planted-tie case: the
    card's first-max rule picks the CPU's pairs limb by limb."""
    from tpupose_torch.ops.paf import greedy_match

    rng = np.random.RandomState(0)
    n_limbs, k = 24, 8
    score = rng.randint(0, 4, (n_limbs, k, k)).astype(np.float32) / 4.0
    n_a = rng.randint(0, k + 1, n_limbs)
    n_b = rng.randint(0, k + 1, n_limbs)
    valid = rng.rand(n_limbs, k, k) < rng.uniform(0.2, 0.9, (n_limbs, 1, 1))
    for l in range(n_limbs):
        valid[l, n_a[l]:, :] = False
        valid[l, :, n_b[l]:] = False
    args = [torch.from_numpy(a) for a in (score, valid, n_a, n_b)]
    ref = greedy_match(*args)
    got = greedy_match(*[a.to(cuda_device) for a in args])
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def test_global_argmax_ties_on_the_card_take_the_first(cuda_device):
    from tpupose_torch.ops.peaks import global_argmax_keypoints

    hm = np.zeros((3, 40, 50), np.float32)
    hm[0, 10, 12] = hm[0, 30, 40] = 1.0     # two equal peaks
    hm[1] = 0.25                            # flat: every pixel ties
    hm[2, 20, 25] = 0.5
    x = torch.from_numpy(hm)
    ref = global_argmax_keypoints(x, 2.5, 0.01)
    got = global_argmax_keypoints(x.to(cuda_device), 2.5, 0.01)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert ref[0].tolist() == [12, 0, 25] and ref[1].tolist() == [10, 0, 20]


# ---------------------------------------------------------------------------
# the crop nets' kernel shapes and detectors
# ---------------------------------------------------------------------------

# (group channels) of the refine stages' Mconv1: FaceNet, HandNet; then the
# 128 -> 128 Mconv2-5
CROP_CONV7_GROUPS = [(71, 128), (22, 128), (128,)]


@pytest.mark.parametrize("tile", range(len(c7.TILE_ROWS)))
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("channels", CROP_CONV7_GROUPS,
                         ids=lambda c: "-".join(map(str, c)))
def test_conv7_kernel_at_the_crop_nets_shapes(cuda_device, tile, b,
                                              channels):
    parts, kernels, mults, bias = _conv7_case(
        np.random.RandomState(b + tile), b, 46, 46, channels, cuda_device)
    got = c7.conv7_s8(parts, kernels, mults, bias, tile=tile)
    ref = c7.conv7_s8_reference(parts, kernels, mults, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# The crop nets' conv_s8 layers that the pose net has not: the stem's
# 512 -> 512 3x3 at 46x46, conv5_3_CPM and conv6_1_CPM; and the input
# layer at 368x368, at B = 1 and 8.
CROP_CONV_S8_LAYERS = [
    (1, 46, 46, 512, 512, 3), (8, 46, 46, 512, 512, 3),
    (1, 46, 46, 512, 128, 3), (8, 46, 46, 512, 128, 3),
    (1, 46, 46, 128, 512, 1), (8, 368, 368, 3, 64, 3)]


@pytest.mark.parametrize("layer", CROP_CONV_S8_LAYERS,
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_s8_kernel_at_the_crop_nets_shapes(cuda_device, layer):
    x, kq, mult, bias = _conv_s8_case(np.random.RandomState(sum(layer)),
                                      *layer, cuda_device)
    o = layer[4]
    for tile, (_, _, tile_n) in enumerate(cs.TILES):
        if o % tile_n:
            continue
        got = cs.conv_s8(x, kq, mult, bias, tile=tile)
        ref = cs.conv_s8_reference(x, kq, mult, bias)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), cs.TILES[tile]


def _crop_detector_pair(arch, cuda_device, size=64):
    from tpupose_torch.config import FaceConfig, HandConfig
    from tpupose_torch.detectors import FaceDetector, HandDetector
    from tpupose_torch.utils.calibrate import calibrate_crop_output_conv

    cls, cfg = {"facenet": (FaceDetector, FaceConfig(img_size=size)),
                "handnet": (HandDetector, HandConfig(img_size=size))}[arch]
    rng = np.random.RandomState(len(arch))
    crops = [rng.randint(0, 256, (40 + 9 * i, 50 - 4 * i, 3)).astype(
        np.uint8) for i in range(3)]
    cpu = cls(cfg=cfg, device="cpu", seed=0)
    calibrate_crop_output_conv(cpu, crops)
    card = cls(cfg=cfg, device=cuda_device, seed=1)
    card.model.load_state_dict(cpu.model.state_dict())
    return cpu, card, crops


@pytest.mark.parametrize("arch", ["facenet", "handnet"])
def test_crop_detector_on_the_card_matches_the_cpu(cuda_device, arch):
    """float32 maps within 1e-4 x max|ref| of the CPU's; after
    ``quantize`` (kernel route on the card: 25 conv7 and 21 conv_s8
    launches per forward, no requant) every stage's int8 maps equal the
    CPU's int8 forward on the same tree."""
    from tpupose_torch import quant as tq

    cpu, card, crops = _crop_detector_pair(arch, cuda_device)
    flips = [False, True, False]
    imgs = card.prepare_crops(crops, flips)
    got, ref = card.forward_maps(imgs), cpu.forward_maps(imgs)
    scale = ref.abs().max().item()
    assert (got.cpu() - ref).abs().max().item() <= 1e-4 * scale
    keypoints = card.detect_crops(crops, flips)
    assert len(keypoints) == 3 and any(k is not None for k in keypoints[0])

    card.quantize(crops)
    assert card.conv7_impl == "kernel"
    c7.conv7_s8.launches = cs.conv_s8.launches = 0
    rq.requant_epilogue.launches = 0
    got = card.forward_maps(imgs)
    torch.cuda.synchronize()
    assert (c7.conv7_s8.launches, cs.conv_s8.launches,
            rq.requant_epilogue.launches) == (25, 21, 0)
    host = tq.make_quant_apply(card.quant_static, tq.qtree_to_device(
        card.qtree, card.quant_static, "cpu"))
    with torch.no_grad():
        ref = host(torch.from_numpy(imgs).float() / 256.0 - 0.5)
    assert torch.equal(got.cpu(), ref)


RESIZE_CASES = [(s, s) for s in (1, 2, 64, 100, 157, 192, 368, 500)] + [
    (37, 120), (120, 37), (1, 200), (200, 1), (480, 640)]


def _resize_images(hws, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in hws]


def _resize_on_card(images, mirrors, size, device):
    from tpupose_torch.ops import resize as rs

    packed, descriptors = rs.pack_u8_images(images, mirrors, pin_memory=True)
    assert packed.is_pinned()
    packed = packed.to(device, non_blocking=True)
    before = (rs.resize_u8_linear_batch.launches,
              rs.resize_u8_linear_batch.images)
    got = rs.resize_u8_linear_batch(packed, descriptors, size)
    plain = rs.resize_u8_linear_batch_plain(packed, descriptors, size)
    torch.cuda.synchronize()
    want = np.stack([rs.resize_u8_linear(img[:, ::-1] if m else img, size)
                     for img, m in zip(images, mirrors)])
    assert got.device == packed.device and plain.device == packed.device
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    return (rs.resize_u8_linear_batch.launches - before[0],
            rs.resize_u8_linear_batch.images - before[1])


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("hw", RESIZE_CASES)
def test_resize_u8_kernel_equals_plain_and_numpy(cuda_device, hw, mirror):
    assert _resize_on_card(_resize_images([hw], sum(hw)), [mirror],
                           (368, 368), cuda_device) == (1, 1)


@pytest.mark.parametrize("size", [(368, 368), (496, 368), (45, 37)])
def test_resize_u8_kernel_on_a_hand_request(cuda_device, size):
    """The hand cell's request: 8 crops of 64-192 px, 4 mirrored, in one
    launch; also to a frame-sized and a ragged output."""
    sides = np.random.RandomState(11).randint(64, 193, 8)
    images = _resize_images([(int(s), int(s)) for s in sides], 12)
    assert _resize_on_card(images, [i % 2 == 0 for i in range(8)], size,
                           cuda_device) == (1, 8)


def test_resize_u8_kernel_takes_more_items_than_a_launch_holds(
        cuda_device):
    from tpupose_torch.ops.resize import MAX_ITEMS

    n = 2 * MAX_ITEMS + 3
    rng = np.random.RandomState(13)
    images = _resize_images([tuple(hw) for hw in rng.randint(1, 90, (n, 2))],
                            14)
    mirrors = [bool(m) for m in rng.randint(0, 2, n)]
    assert _resize_on_card(images, mirrors, (64, 48), cuda_device) == (3, n)


def test_resize_u8_kernel_refuses_what_it_does_not_take(cuda_device):
    from tpupose_torch.ops import resize as rs

    packed = torch.zeros(12, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="outside"):
        rs.resize_u8_linear_batch(packed, [(4, 2, 2, False)], (8, 8))
    with pytest.raises(ValueError, match="uint8"):
        rs.resize_u8_linear_batch(packed.int(), [(0, 2, 2, False)], (8, 8))
    with pytest.raises(ValueError, match="size"):
        rs.resize_u8_linear_batch(packed, [(0, 2, 2, False)],
                                  (rs.MAX_OUT_W + 1, 8))


@pytest.mark.parametrize("arch", ["facenet", "handnet"])
def test_crop_detector_resizes_on_the_card_once_a_request(cuda_device, arch):
    """``submit_crops`` uploads the raw crops and resizes them in one
    launch; quantized, the card's keypoints equal a CPU twin's on the same
    int8 tree (its inputs resized by the plain version)."""
    import copy

    from tpupose_torch import quant as tq
    from tpupose_torch.ops import resize as rs

    _, card, crops = _crop_detector_pair(arch, cuda_device)
    crops = (crops * 3)[:8]
    flips = [i % 2 == 1 for i in range(8)]
    card.quantize(crops[:3])
    twin = copy.copy(card)
    twin.device = torch.device("cpu")
    twin.net = copy.copy(card.net)
    twin.net.quant_forward = tq.make_quant_apply(
        card.quant_static, tq.qtree_to_device(card.qtree, card.quant_static,
                                              "cpu"))
    before = (rs.resize_u8_linear_batch.launches,
              rs.resize_u8_linear_batch.images)
    pending = card.submit_crops(crops, flips)
    torch.cuda.synchronize()
    assert (rs.resize_u8_linear_batch.launches - before[0],
            rs.resize_u8_linear_batch.images - before[1]) == (1, 8)
    got = card.collect_crops(pending)
    ref = twin.detect_crops(crops, flips)
    assert rs.resize_u8_linear_batch.launches - before[0] == 1
    assert any(k is not None for crop in ref for k in crop)
    for g, r in zip(got, ref):
        for gk, rk in zip(g, r):
            assert (gk is None) == (rk is None)
            if rk is not None:
                assert gk[:2] == rk[:2]
                assert abs(gk[2] - rk[2]) <= 1e-5 * max(abs(rk[2]), 1.0)


# --- the crop tail kernel (csrc/crop_tail.cu) --------------------------------


def _crop_tail_maps(b, h, w, c, seed, device, plateau=False):
    """Seeded (B, h, w, C) float32 crop maps, a few peaks a channel; or, as
    a plateau, one value a channel, where the first maximum moves with any
    change in the order of the arithmetic."""
    if plateau:
        values = 0.1 + 0.0371 * np.arange(c, dtype=np.float32)
        maps = np.broadcast_to(values, (b, h, w, c)).copy()
    else:
        rng = np.random.RandomState(seed)
        maps = rng.rand(b, h, w, c).astype(np.float32) * 0.2
        for i in range(b):
            for ch in range(c):
                maps[i, rng.randint(0, h), rng.randint(0, w), ch] += \
                    rng.uniform(0.2, 1.0)
    return torch.from_numpy(maps).to(device)


def _tails_on_card(maps, targets, flips, sigma=2.5, thresh=0.1):
    """The kernel's rows bit-equal to the plain version's on the card;
    returns the launches it took."""
    from tpupose_torch.ops import crop_tail as ct

    before = ct.crop_tails.launches
    got = ct.crop_tails(maps, targets, flips, sigma, thresh)
    launches = ct.crop_tails.launches - before
    plain = ct.crop_tails_plain(maps, targets, flips, sigma, thresh)
    torch.cuda.synchronize()
    assert got.device == maps.device and got.shape == plain.shape
    assert torch.equal(got, plain)
    return launches


def _crop_tail_case(case):
    rng = np.random.RandomState(len(case))
    if case == "hand":      # the hand cell's: 8 crops of 64-192 px
        sides = rng.randint(64, 193, 8)
        return [(int(s), int(s)) for s in sides], [i % 2 == 0
                                                   for i in range(8)], 22
    if case == "face":
        return ([tuple(int(v) for v in hw)
                 for hw in rng.randint(40, 300, (8, 2))],
                [False, True] * 4, 71)
    if case == "below_radius":
        return [(3, 5), (1, 1), (7, 2), (1, 20)], [True, False, True,
                                                   True], 22
    return [(2048, 48), (31, 2048)], [False, True], 22    # the longest side


@pytest.mark.parametrize("plateau", [False, True])
@pytest.mark.parametrize("case", ["hand", "face", "below_radius",
                                  "side_2048"])
def test_crop_tail_kernel_equals_plain(cuda_device, case, plateau):
    targets, flips, c = _crop_tail_case(case)
    maps = _crop_tail_maps(len(targets), 46, 46, c, len(case), cuda_device,
                           plateau)
    assert _tails_on_card(maps, targets, flips) == 1


@pytest.mark.parametrize("n", [64, 65])
def test_crop_tail_kernel_takes_more_crops_than_a_launch_holds(cuda_device,
                                                               n):
    rng = np.random.RandomState(n)
    targets = [tuple(int(v) for v in hw) for hw in rng.randint(1, 60, (n, 2))]
    flips = [bool(f) for f in rng.randint(0, 2, n)]
    maps = _crop_tail_maps(n, 46, 46, 22, n, cuda_device)
    assert _tails_on_card(maps, targets, flips) == -(-n // 64)


@pytest.mark.parametrize("sigma", [8.0, 11.9])
def test_crop_tail_kernel_at_wide_radii(cuda_device, sigma):
    """Radii 32 and 48, the largest: the block's shared memory grows with
    the tile's halo (218,500 bytes at radius 48 and the largest plane)."""
    maps = _crop_tail_maps(2, 46, 46, 22, 3, cuda_device)
    assert _tails_on_card(maps, [(64, 97), (5, 150)], [True, False],
                          sigma=sigma) == 1


def test_crop_tail_on_a_cuda_tensor_never_falls_back(cuda_device,
                                                     monkeypatch):
    from tpupose_torch.ops import crop_tail as ct

    def no_plain(*args):
        raise AssertionError("a CUDA tensor took the plain version")

    maps = _crop_tail_maps(2, 46, 46, 22, 4, cuda_device)
    want = ct.crop_tails_plain(maps, [(64, 64), (9, 9)], [True, False],
                               2.5, 0.1)
    monkeypatch.setattr(ct, "crop_tails_plain", no_plain)
    got = ct.crop_tails(maps, [(64, 64), (9, 9)], [True, False], 2.5, 0.1)
    assert torch.equal(got, want)

    def broken():
        raise RuntimeError("no kernel")

    monkeypatch.setattr(ct, "_library", broken)
    with pytest.raises(RuntimeError, match="no kernel"):
        ct.crop_tails(maps, [(64, 64), (9, 9)], [True, False], 2.5, 0.1)
    with pytest.raises(ValueError, match="target size"):
        ct.crop_tails(maps, [(64, 64), (9, ct.MAX_SIDE + 1)],
                      [True, False], 2.5, 0.1)


def test_crop_tails_op_launches_the_kernel_on_the_card(cuda_device):
    from tpupose_torch.ops import crop_tail as ct
    from tpupose_torch.ops import library  # noqa: F401  registers the ops

    maps = _crop_tail_maps(3, 46, 46, 22, 6, cuda_device)
    targets, flips = [(64, 64), (9, 150), (192, 100)], [True, False, True]
    before = ct.crop_tails.launches
    got = torch.ops.tpupose.crop_tails(
        maps, [v for hw in targets for v in hw], flips, 2.5, 0.1)
    assert ct.crop_tails.launches == before + 1
    assert torch.equal(got, ct.crop_tails(maps, targets, flips, 2.5, 0.1))


@pytest.mark.parametrize("arch", ["facenet", "handnet"])
def test_crop_detector_runs_its_tails_in_one_launch_a_request(cuda_device,
                                                              arch):
    """``submit_crops`` runs every crop's tail in one ``crop_tails``
    launch, and its rows equal a CPU twin's tails on the same maps bit for
    bit; a crop bundle's per-crop tail program equals them too."""
    import copy

    from tpupose_torch.ops import crop_tail as ct

    _, card, crops = _crop_detector_pair(arch, cuda_device)
    crops = (crops * 3)[:8]
    flips = [i % 2 == 1 for i in range(8)]
    maps = card.forward_maps(card.prepare_crops(crops, flips))[-1]
    hws = [c.shape[:2] for c in crops]
    before = ct.crop_tails.launches
    rows, _ = card.submit_tails(maps, hws, flips)
    assert ct.crop_tails.launches - before == 1
    twin = copy.copy(card)
    twin.device = torch.device("cpu")
    ref, _ = twin.submit_tails(maps.cpu(), hws, flips)
    assert torch.equal(rows.cpu(), ref)
    for i in (0, 5):
        target, _ = card._tail_target(hws[i])
        assert torch.equal(card._tail_fn(target, flips[i])(maps[i]),
                           rows[i])
    before = ct.crop_tails.launches
    card.detect_crops(crops, flips)
    assert ct.crop_tails.launches - before == 1


def _tiny_frames():
    return [np.zeros(s, np.uint8) for s in ((1, 1, 3), (16, 9, 3),
                                            (9, 16, 3))]


@pytest.mark.parametrize("mode", ["fast", "precise", "int8"])
def test_tiny_frames_give_empty_tables_on_the_card(cuda_device, mode):
    cfg = InferenceConfig(img_size=96, heatmap_size=88)
    det = PoseDetector(cfg=cfg, device=cuda_device, seed=0,
                       precise=mode == "precise")
    if mode == "int8":
        det.quantize([np.random.RandomState(0).randint(
            0, 256, (64, 64, 3)).astype(np.uint8)])
    for frame in _tiny_frames():
        for poses, scores in (det(frame), det.detect_batch(frame[None])[0]):
            assert poses.shape == (0, 18, 3) and scores.shape == (0,)


def test_detect_precise_equals_call_on_the_card(cuda_device):
    cfg = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    frame = np.random.RandomState(0).randint(0, 256, (96, 128, 3)).astype(
        np.uint8)
    det = PoseDetector(cfg=cfg, device=cuda_device, seed=0, precise=True)
    assert calibrate_output_convs(det, frame)
    got, ref = det.detect_precise(frame), det(frame)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


# --- the serving path: custom ops and bundles on the card -------------------


def test_custom_ops_equal_their_wrappers_on_the_card(cuda_device):
    """Each ``tpupose::*`` kernel op launches its wrapper's kernel (counted
    by the wrapper) and equals the wrapper bit for bit."""
    from tpupose_torch.ops import library  # noqa: F401  registers the ops

    ops = torch.ops.tpupose
    rng = np.random.RandomState(11)
    x = torch.from_numpy(_planted(rng, 18, 46, 62)).to(cuda_device)
    before = bn.blur_nms.launches
    got, ref = ops.blur_nms(x, 2.5, 0.05), bn.blur_nms(x, 2.5, 0.05)
    assert bn.blur_nms.launches == before + 2
    assert all(torch.equal(g, r) for g, r in zip(got, ref))

    parts, kernels, mults, bias = _conv7_case(rng, 1, 23, 31, MCONV1,
                                              cuda_device)
    packed = [c7.pack_conv7_weights(k) for k in kernels]
    before = c7.conv7_s8.launches
    got = ops.conv7_s8(parts, kernels, mults, bias, True, packed)
    assert c7.conv7_s8.launches == before + 1
    assert torch.equal(got, c7.conv7_s8(parts, kernels, mults, bias,
                                        packed=packed))

    xq, kq, mult, bias = _conv_s8_case(rng, 1, 46, 62, 128, 128, 3,
                                       cuda_device)
    before = cs.conv_s8.launches
    got = ops.conv_s8([xq], [kq], [mult], bias, "relu", None,
                      [cs.pack_conv_s8_weights(kq)])
    assert cs.conv_s8.launches == before + 1
    assert torch.equal(got, cs.conv_s8(xq, kq, mult, bias))

    accs = [torch.from_numpy(rng.randint(-2**20, 2**20, (1, 46, 62, 64))
                             .astype(np.int32)).to(cuda_device)
            for _ in range(2)]
    rmults = [torch.full((64,), 1e-5, device=cuda_device)] * 2
    rbias = torch.zeros(64, device=cuda_device)
    before = rq.requant_epilogue.launches
    got = ops.requant_epilogue(accs, rmults, rbias, True, 0.0)
    assert rq.requant_epilogue.launches == before + 1
    assert torch.equal(got, rq.requant_epilogue(accs, rmults, rbias, True))
    slope = torch.from_numpy(rng.uniform(-0.5, 1.5, 64).astype(
        np.float32)).to(cuda_device)
    before = rq.requant_epilogue.launches
    got = ops.act_epilogue(accs, rmults, rbias, "prelu", slope)
    assert rq.requant_epilogue.launches == before + 1
    assert torch.equal(got, rq.act_epilogue(accs, rmults, rbias, "prelu",
                                            slope))
    torch.cuda.synchronize()


def test_fold_and_matcher_ops_equal_their_functions_on_the_card(
        cuda_device):
    from tpupose_torch.config import LIMBS_FROM, LIMBS_TO
    from tpupose_torch.ops import library
    from tpupose_torch.ops.grouping import group_keypoints
    from tpupose_torch.ops.paf import compute_connections, greedy_match
    from tpupose_torch.ops.peaks import find_peaks

    cfg = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    frame = np.random.RandomState(0).randint(0, 256, (96, 128, 3)).astype(
        np.uint8)
    det = PoseDetector(cfg=cfg, device=cuda_device, seed=0)
    assert calibrate_output_convs(det, frame)
    (paf, hm), _ = det.compute_maps(frame)
    with torch.no_grad():
        peaks = find_peaks(hm[:-1], cfg.gaussian_sigma,
                           cfg.heatmap_peak_thresh, cfg.max_peaks_per_joint)
        conns = compute_connections(paf, peaks, paf.shape[-1], cfg,
                                    LIMBS_FROM, LIMBS_TO)
        with library.traced_ops():
            folded = library.group_keypoints(conns, peaks, cfg)
        ref = group_keypoints(conns, peaks, cfg)
        score = torch.rand(19, 32, 32, device=cuda_device)
        valid = score > 0.3
        n_a, n_b = valid.any(dim=2).sum(dim=1), valid.any(dim=1).sum(dim=1)
        got_m = torch.ops.tpupose.greedy_match(score, valid, n_a, n_b)
        ref_m = greedy_match(score, valid, n_a, n_b)
    assert all(torch.equal(g, r) for g, r in zip(folded, ref))
    assert int(ref.valid.sum()) >= 1
    assert all(torch.equal(g, r) for g, r in zip(got_m, ref_m))


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_cuda_bundle_equals_live_detector(cuda_device, mode, tmp_path):
    """A CUDA bundle exported and loaded in this process gives the live
    detector's pose tables and batched results, and its int8 program runs
    conv7 and conv_s8 through their ops (50 and 30 launches a forward)."""
    from tpupose_torch.serving import ServingPoseDetector, save_bundle

    cfg = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    frames = np.random.RandomState(0).randint(
        0, 256, (2, 96, 128, 3)).astype(np.uint8)
    det = PoseDetector(cfg=cfg, device=cuda_device, seed=0)
    assert calibrate_output_convs(det, frames[0])
    if mode == "int8":
        det.quantize([frames[0], frames[0][:, ::-1]])
    save_bundle(det, str(tmp_path), [(96, 128)], platforms=("cuda",),
                batch_sizes=(2,))
    srv = ServingPoseDetector(str(tmp_path))
    launches = (c7.conv7_s8.launches, cs.conv_s8.launches,
                bn.blur_nms.launches)
    got = srv(frames[0])
    torch.cuda.synchronize()
    grew = [c7.conv7_s8.launches - launches[0],
            cs.conv_s8.launches - launches[1],
            bn.blur_nms.launches - launches[2]]
    assert grew == ([50, 30, 1] if mode == "int8" else [0, 0, 1])
    ref = det(frames[0])
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    for g, r in zip(srv.detect_batch(frames), det.detect_batch(frames)):
        np.testing.assert_array_equal(g[0], r[0])
        np.testing.assert_array_equal(g[1], r[1])


# ------------------------------------------------------------- training


def _train_pair(device, cfg, seed, num_stages=6):
    from tpupose_torch.models import CocoPoseNet
    from tpupose_torch.train import trainer as ttr

    return ttr.init_train_state(CocoPoseNet(num_stages=num_stages,
                                            seed=seed), cfg, device=device)


def _synthetic_batch(insize, b, seed=0):
    from tpupose_torch.data import BatchLoader, SyntheticCropDataset

    ds = SyntheticCropDataset(18, insize=insize, n_samples=b, seed=seed)
    return next(iter(BatchLoader(ds, b, max_persons=1, shuffle=False,
                                 repeat=False)))


def _loss_and_grads(state, batch, cfg):
    from tpupose_torch.train import trainer as ttr

    state.model.zero_grad(set_to_none=True)
    total, _ = ttr.loss_for_batch(
        state.model, batch.to(next(state.model.parameters()).device), cfg)
    total.backward()
    return total.item(), {n: p.grad.detach().cpu()
                          for n, p in state.model.named_parameters()}


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """The full 6-stage CocoPoseNet at insize 64, B = 2: GT maps within
    atol 1e-5, the loss within rtol 1e-4 and each gradient leaf within
    1e-3 x max |g| of the CPU's, from one seeded parameter set."""
    from tpupose_torch.config import TrainConfig
    from tpupose_torch.detectors.net import float32_numerics
    from tpupose_torch.train import trainer as ttr

    cfg = TrainConfig(insize=64, stem_freeze_steps=0)
    batch = _synthetic_batch(64, 2, seed=3)
    out = {}
    with float32_numerics():
        for device in (cuda_device, torch.device("cpu")):
            state = _train_pair(device, cfg, seed=2)
            b = batch.to(device)
            gt = ttr.render_batch_labels(b, cfg, out_hw=(8, 8))
            out[device.type] = ([t.cpu() for t in gt],
                                *_loss_and_grads(state, batch, cfg))
    for g, r in zip(out["cuda"][0], out["cpu"][0]):
        assert (g - r).abs().max().item() <= 1e-5
    assert abs(out["cuda"][1] / out["cpu"][1] - 1) <= 1e-4
    for name, r in out["cpu"][2].items():
        err = (out["cuda"][2][name] - r).abs().max().item()
        assert err <= 1e-3 * r.abs().max().item(), name


def test_remat_gradients_on_the_card_equal_plain(cuda_device):
    import dataclasses

    from tpupose_torch.config import TrainConfig
    from tpupose_torch.detectors.net import float32_numerics

    cfg = TrainConfig(insize=64, stem_freeze_steps=0)
    batch = _synthetic_batch(64, 2, seed=4)
    with float32_numerics():
        state = _train_pair(cuda_device, cfg, seed=5)
        plain = _loss_and_grads(state, batch, cfg)
        remat = _loss_and_grads(state, batch,
                                dataclasses.replace(cfg, remat=True))
    assert remat[0] == plain[0]
    for name, r in plain[1].items():
        err = (remat[1][name] - r).abs().max().item()
        assert err <= 1e-6 * r.abs().max().item(), name


def test_resume_on_the_card_equals_an_uninterrupted_run(cuda_device,
                                                        tmp_path):
    """Save at step 2 (the stem still frozen), restore into a fresh state,
    take step 3 (its first live update): bit-equal, under deterministic
    cuDNN, to three uninterrupted steps."""
    from tpupose_torch.config import TrainConfig
    from tpupose_torch.detectors.net import float32_numerics
    from tpupose_torch.train import checkpoint as ckpt
    from tpupose_torch.train import trainer as ttr

    cfg = TrainConfig(insize=64, stem_freeze_steps=2)
    batches = [_synthetic_batch(64, 2, seed=s) for s in range(3)]
    step = ttr.make_train_step(cfg)
    with float32_numerics():
        full = _train_pair(cuda_device, cfg, seed=0, num_stages=2)
        for b in batches:
            full, _ = step(full, b)
        part = _train_pair(cuda_device, cfg, seed=0, num_stages=2)
        for b in batches[:2]:
            part, _ = step(part, b)
        path = ckpt.save_checkpoint(str(tmp_path), part)
        resumed = ckpt.restore_checkpoint(
            path, _train_pair(cuda_device, cfg, seed=1, num_stages=2))
        resumed, _ = step(resumed, batches[2])
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


# --- the detectors' other modes: conv NMS, bfloat16, the host pyramid ------


def _plateaus(rng, j, h, w):
    """Planted peaks plus 2-pixel plateaus the ``>=`` rule keeps."""
    hm = _planted(rng, j, h, w)
    for c in range(j):
        y, x = rng.randint(2, h - 2), rng.randint(2, w - 3)
        hm[c, y - 2:y + 3, x - 2:x + 4] = 0.0
        hm[c, y, x:x + 2] = 2.0
    return hm


@pytest.mark.parametrize("shape", [(18, 320, 432), (4, 46, 62)])
def test_conv_mode_peaks_on_the_card_equal_the_cpu(cuda_device, shape):
    """``find_peaks(mode="conv")`` is plain PyTorch on both devices (no
    kernel): the smoothed maps bit-equal (eager products and sums round
    alike), masks and peak tables equal, plateaus included; blur_nms does
    not launch."""
    from tpupose_torch.ops import gaussian
    from tpupose_torch.ops.peaks import find_peaks, nms_mask_ge

    x = torch.from_numpy(_plateaus(np.random.RandomState(3), *shape))
    before = bn.blur_nms.launches
    s = gaussian.gaussian_blur_conv_zero(x.to(cuda_device), 2.5, 17)
    assert torch.equal(s.cpu(), gaussian.gaussian_blur_conv_zero(x, 2.5, 17))
    assert torch.equal(nms_mask_ge(s, 0.05).cpu(),
                       nms_mask_ge(s.cpu(), 0.05))
    got = find_peaks(x.to(cuda_device), 2.5, 0.05, 32, mode="conv")
    ref = find_peaks(x, 2.5, 0.05, 32, mode="conv")
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    assert bn.blur_nms.launches == before
    assert int(ref.valid.sum()) >= 2 * shape[0]


def test_bf16_detector_on_the_card_matches_the_cpu(cuda_device):
    """bfloat16 parameters at rest, float32 maps within 5e-2 x max|ref| of
    the CPU's bfloat16 forward at every pixel and 5e-3 x max|ref| in rms
    (both round each layer to bfloat16, in other summation orders: the
    CPU tests' bounds against JAX), the postprocess on the card's
    blur_nms kernel."""
    cfg = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    frame = np.random.RandomState(0).randint(0, 256, (96, 128, 3)).astype(
        np.uint8)
    f32 = PoseDetector(cfg=cfg, device="cpu", seed=0)
    assert calibrate_output_convs(f32, frame)
    dets = []
    for device in (cuda_device, "cpu"):
        det = PoseDetector(cfg=cfg, device=device, seed=0,
                           compute_dtype=torch.bfloat16)
        det.model.load_state_dict(f32.model.state_dict())
        assert {p.dtype for p in det.model.parameters()} == {torch.bfloat16}
        dets.append(det)
    (paf, hm), _ = dets[0].compute_maps(frame)
    (rpaf, rhm), _ = dets[1].compute_maps(frame)
    for got, ref in ((paf, rpaf), (hm, rhm)):
        assert got.dtype == torch.float32
        diff = got.cpu() - ref
        scale = ref.abs().max().item()
        assert diff.abs().max().item() <= 5e-2 * scale
        assert diff.pow(2).mean().sqrt().item() <= 5e-3 * scale
    before = bn.blur_nms.launches
    poses, _ = dets[0](frame)
    assert bn.blur_nms.launches == before + 1
    assert poses.shape[1:] == (18, 3)


# sha256 of cv2.resize(img, size, INTER_CUBIC) with cv2.ipp.setUseIPP(False)
# (OpenCV 5.0.0) for img = RandomState(7).randint(0, 256, (480, 640, 3)):
# the card's machine has no cv2, so these pin its numpy emulation.
CV2_CUBIC_SHA256 = {
    (246, 184):
        "1bc6c6d41c666d705a8a3f56978834f054ffd7b7799a43540a64feefb74d865f",
    (496, 368):
        "5f083e6add3959d4aed755c522e8b326ad734d2ce7694c28578b6efdd8edae61",
    (982, 736):
        "d20b0ef5ae18548415e0acd080af8f133d405b3f20e605ac49feefe46f30d4ad",
    (5, 3):
        "3bad83041882d376ae80b855553d9e0837e948e812f08ea9f0d3cb637023150e",
}


@pytest.mark.parametrize("size", sorted(CV2_CUBIC_SHA256))
def test_resize_u8_cubic_on_the_card_machine_gives_cv2s_bytes(cuda_device,
                                                              size):
    import hashlib

    from tpupose_torch.ops.resize import resize_u8_cubic

    img = np.random.RandomState(7).randint(0, 256, (480, 640, 3)).astype(
        np.uint8)
    got = resize_u8_cubic(img, size)
    assert got.shape == (size[1], size[0], 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        CV2_CUBIC_SHA256[size]


def test_host_pyramid_on_the_card_matches_the_cpu(cuda_device):
    """``device_pyramid=False``: the same host-resized frames on both
    devices; each scale's maps within 1e-4 x max|ref| of the CPU's, and the
    card's blur_nms runs the averaged maps."""
    cfg = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05,
                          device_pyramid=False)
    frame = np.random.RandomState(1).randint(0, 256, (96, 128, 3)).astype(
        np.uint8)
    dets = [PoseDetector(cfg=cfg, device=d, seed=0, precise=True)
            for d in (cuda_device, "cpu")]
    assert calibrate_output_convs(dets[1], frame)
    dets[0].model.load_state_dict(dets[1].model.state_dict())
    got, _, _ = dets[0]._precise_scale_maps(frame[None])
    ref, _, _ = dets[1]._precise_scale_maps(frame[None])
    for g, r in zip(got, ref):
        err = (g.cpu() - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item()
    before = bn.blur_nms.launches
    poses, _ = dets[0](frame)
    assert bn.blur_nms.launches == before + 1
    assert poses.shape[1:] == (18, 3)


# ---------------------------------------------------------------------------
# the (data, spatial) mesh on the card: two gloo ranks sharing card 0
# ---------------------------------------------------------------------------


def _mesh_rank_checks(rank, world):
    """The ranks' half of the meshed card tests (this file runs as the
    ranks' script): a 1x2 mesh's f32 and int8 maps and tables against
    the mesh-less pair in the same process, its kernels' launches on slab
    shapes, and a 2x1 train step against one process."""
    import hashlib

    from tpupose_torch.config import TrainConfig
    from tpupose_torch.detectors.net import float32_numerics
    from tpupose_torch.models import CocoPoseNet
    from tpupose_torch.parallel import make_mesh, replicate
    from tpupose_torch.train import (TrainBatch, init_train_state,
                                     make_train_step)

    out = {}
    cfg = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    frames = np.random.RandomState(2).randint(
        0, 256, (2, 96, 128, 3)).astype(np.uint8)
    mesh = make_mesh(1, 2, device="cuda")
    ref = PoseDetector(cfg=cfg, device="cuda", seed=0)
    assert calibrate_output_convs(ref, frames[0])
    det = PoseDetector(cfg=cfg, seed=0, mesh=mesh)
    det.model.load_state_dict(ref.model.state_dict())
    replicate(det.model, mesh)
    (paf, hm), _ = det.compute_maps_batch(frames)
    (rpaf, rhm), _ = ref.compute_maps_batch(frames)
    out["f32_rel"] = max(np.abs(paf - rpaf).max() / np.abs(rpaf).max(),
                         np.abs(hm - rhm).max() / np.abs(rhm).max())
    out["f32_tables"] = [len(p) for p, _ in det.detect_batch(frames)]
    for d in (ref, det):
        d.quantize([frames[0], frames[0][:, ::-1]])
    before = (c7.conv7_s8.launches, cs.conv_s8.launches)
    shapes = set(c7.conv7_s8.shapes)
    (qpaf, qhm), _ = det.compute_maps_batch(frames)
    out["launches"] = (c7.conv7_s8.launches - before[0],
                       cs.conv_s8.launches - before[1])
    out["new_conv7_shapes"] = sorted(set(c7.conv7_s8.shapes) - shapes)
    (rqpaf, rqhm), _ = ref.compute_maps_batch(frames)
    out["int8_equal"] = (np.array_equal(qpaf, rqpaf)
                         and np.array_equal(qhm, rqhm))
    got, want = det.detect_batch(frames), ref.detect_batch(frames)
    out["int8_tables_equal"] = all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        for a, b in zip(got, want))
    del det, ref
    # a 2x1 train step at insize 64 against one process on the batch
    tcfg = TrainConfig(insize=64, max_persons=1)
    rng = np.random.RandomState(3)
    poses = np.zeros((2, 1, 18, 3), np.float32)
    poses[:, 0, :, :2] = rng.uniform(4, 60, (2, 18, 2))
    poses[:, 0, :, 2] = 2
    batch = TrainBatch(
        torch.from_numpy(rng.randint(0, 256, (2, 64, 64, 3)).astype(
            np.uint8)), torch.from_numpy(poses),
        torch.zeros(2, 64, 64, dtype=torch.bool))
    mesh = make_mesh(2, 1, device="cuda")
    with float32_numerics():
        state = init_train_state(CocoPoseNet(num_stages=2, seed=1), tcfg,
                                 mesh=mesh)
        state, m = make_train_step(tcfg, mesh=mesh)(state, batch)
        ref = init_train_state(CocoPoseNet(num_stages=2, seed=1), tcfg)
        ref, rm = make_train_step(tcfg)(ref, batch)
    params = torch.cat([p.detach().reshape(-1)
                        for p in state.model.parameters()])
    rparams = torch.cat([p.detach().reshape(-1)
                         for p in ref.model.parameters()])
    out["loss"] = (float(m["loss"]), float(rm["loss"]))
    out["param_err"] = (params - rparams).abs().max().item()
    out["digest"] = hashlib.sha256(params.cpu().numpy().tobytes()).hexdigest()
    return out


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    from test_torch_parallel import run_ranks

    return run_ranks(os.path.abspath(__file__), 2,
                     str(tmp_path_factory.mktemp("cuda_mesh")))


def test_meshed_f32_maps_on_the_card(mesh_ranks):
    """1x2 slabs with halos on the card: maps within 1e-4 x max|ref| of
    the mesh-less forward (cuDNN may take other algorithms on slabs)."""
    for res in mesh_ranks:
        assert res["f32_rel"] <= 1e-4
        assert sum(res["f32_tables"]) >= 1


def test_meshed_int8_kernels_on_slabs_are_bit_equal(mesh_ranks):
    """conv7_s8 and conv_s8 launch on the slab shapes (stage rows + 3 of
    halo) and the meshed int8 maps equal the mesh-less ones bit for bit."""
    for res in mesh_ranks:
        assert res["launches"] == (50, 30)      # one batched forward
        assert res["new_conv7_shapes"]
        assert res["int8_equal"] and res["int8_tables_equal"]


def test_meshed_train_step_on_the_card(mesh_ranks):
    """A 2x1 step (gloo, both ranks on card 0) against one process:
    loss within rtol 1e-5; parameters within 0.5 x lr (Adam scales each
    element's float noise by its own root mean square) and equal on both
    ranks."""
    assert len({res["digest"] for res in mesh_ranks}) == 1
    for res in mesh_ranks:
        got, want = res["loss"]
        assert abs(got - want) <= 1e-5 * abs(want)
        assert res["param_err"] <= 0.5 * 1e-4


# ---------------------------------------------------------------------------
# the device postprocess: greedy_match and group_fold kernels, no host sync
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("name", MATCH_CASES)
def test_greedy_match_kernel_equals_plain(cuda_device, name, frames):
    from tpupose_torch.ops import greedy_match as gm
    from tpupose_torch.ops.paf import greedy_match as plain

    k = 32 if name == "full_limb" else 8
    args = [torch.from_numpy(x).to(cuda_device) for x in match_tables(
        np.random.RandomState(6), name, (frames, 19), k)]
    before = gm.greedy_match.launches
    got = gm.greedy_match(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert gm.greedy_match.launches == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("seed,cap", FOLD_CASES)
def test_group_fold_kernel_equals_plain(cuda_device, seed, cap, frames):
    from tpupose_torch.ops import group_fold as gf
    from tpupose_torch.ops.grouping import fold_connections

    args = [torch.from_numpy(x).to(cuda_device) for x in fold_tables(
        np.random.RandomState(seed), (frames,))]
    before = gf.group_fold.launches
    got = gf.group_fold(*args, cap, 2, 0.3)
    ref = fold_connections(*args, cap, 2, 0.3)
    torch.cuda.synchronize()
    assert gf.group_fold.launches == before + 1
    for g, r, field in zip(got, ref, ref._fields):
        assert g.dtype == r.dtype and torch.equal(g, r), field


@pytest.mark.parametrize("frames", [1, 8])
def test_kernels_on_the_crowd_equal_plain(cuda_device, frames):
    """The crowd: greedy_match on full K = 32 limbs (32 steps a block) and
    group_fold on 32 people (608 steps a frame) at S = 64 and 128; the
    fold on wide tables (over 32 subsets a frame) at S = 40 and 64."""
    from tpupose_torch.config import NUM_LIMBS
    from tpupose_torch.ops import greedy_match as gm
    from tpupose_torch.ops import group_fold as gf
    from tpupose_torch.ops.grouping import fold_connections
    from tpupose_torch.ops.paf import greedy_match as plain

    m_args = [torch.from_numpy(x).to(cuda_device) for x in match_tables(
        np.random.RandomState(6), "full_limb", (frames, NUM_LIMBS), 32)]
    got, ref = gm.greedy_match(*m_args), plain(*m_args)
    assert bool(ref[3].all())
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    f_args = [torch.from_numpy(x).to(cuda_device) for x in crowd_tables(
        np.random.RandomState(8), (frames,))]
    for cap in (64, 128):
        got = gf.group_fold(*f_args, cap, 2, 0.3)
        ref = fold_connections(*f_args, cap, 2, 0.3)
        torch.cuda.synchronize()
        for g, r, field in zip(got, ref, ref._fields):
            assert g.dtype == r.dtype and torch.equal(g, r), field
        assert int(ref.valid.sum()) == 32 * frames
    # over 32 subsets a frame: the match test's second 32-row chunk
    w_args = [torch.from_numpy(x).to(cuda_device) for x in fold_tables(
        np.random.RandomState(3), (frames,), k=WIDE_SLOTS)]
    for cap in (40, 64):
        got = gf.group_fold(*w_args, cap, 2, 0.3)
        ref = fold_connections(*w_args, cap, 2, 0.3)
        torch.cuda.synchronize()
        for g, r, field in zip(got, ref, ref._fields):
            assert g.dtype == r.dtype and torch.equal(g, r), field


def test_postprocess_kernels_name_their_limits(cuda_device):
    """Tables past the kernels' shared memory raise, with the limit."""
    from tpupose_torch.config import NUM_JOINTS, NUM_LIMBS
    from tpupose_torch.ops import greedy_match as gm
    from tpupose_torch.ops import group_fold as gf

    k = gm.MAX_K + 1
    score = torch.zeros((1, k, k), device=cuda_device)
    n = torch.ones(1, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match=f"K <= {gm.MAX_K}"):
        gm.greedy_match(score, score > 0, n, n)
    k = 512
    slots = torch.zeros((1, NUM_LIMBS, k), dtype=torch.int64,
                        device=cuda_device)
    with pytest.raises(ValueError, match=str(gf.MAX_SMEM_BYTES)):
        gf.group_fold(slots, slots, slots.float(), slots > 0,
                      torch.zeros((1, NUM_JOINTS, k), device=cuda_device),
                      1024, 2, 0.3)


@pytest.fixture(scope="module")
def small_detector():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    frames = np.random.RandomState(0).randint(0, 256, (3, 96, 128, 3)
                                              ).astype(np.uint8)
    det = PoseDetector(cfg=cfg, device="cuda", seed=0)
    assert calibrate_output_convs(det, frames[0])
    return det, frames


def test_submit_does_not_sync_the_host(small_detector):
    """Everything ``submit`` does is queued: under
    ``set_sync_debug_mode("error")`` a synchronising call raises; the
    collected table equals ``__call__``'s."""
    from tpupose_torch.ops import greedy_match as gm
    from tpupose_torch.ops import group_fold as gf

    det, frames = small_detector
    ref = det(frames[0])
    before = (gm.greedy_match.launches, gf.group_fold.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = det.submit(frames[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (gm.greedy_match.launches, gf.group_fold.launches) == (
        before[0] + 1, before[1] + 1)
    poses, scores = det.collect(pending)
    np.testing.assert_array_equal(poses, ref[0])
    np.testing.assert_array_equal(scores, ref[1])


def test_detect_batch_equals_three_calls(small_detector):
    """One batched postprocess (one launch of each kernel) gives each
    frame's ``__call__`` table; scores within 1e-4 (cuDNN may pick other
    algorithms at B = 3)."""
    from tpupose_torch.ops import greedy_match as gm
    from tpupose_torch.ops import group_fold as gf

    det, frames = small_detector
    singles = [det(f) for f in frames]
    before = (gm.greedy_match.launches, gf.group_fold.launches)
    batched = det.detect_batch(frames)
    assert (gm.greedy_match.launches, gf.group_fold.launches) == (
        before[0] + 1, before[1] + 1)
    for (p, s), (bp, bs) in zip(singles, batched):
        np.testing.assert_array_equal(bp, p)
        np.testing.assert_allclose(bs, s, rtol=0, atol=1e-4)
    assert sum(len(p) for p, _ in singles) >= 1


if __name__ == "__main__":
    from test_torch_parallel import rank_main

    rank_main(_mesh_rank_checks)


def _higherhrnet_case(device, size=128):
    """The benchmark's HigherHRNet-W32 reference at a ``size`` input, its
    seeded weights calibrated on two seeded frames, on
    ``device``."""
    from posebench.core import registry
    from posebench.reference import higherhrnet as ref

    cfg = registry.config("higherhrnet_w32")
    cfg["input_size"] = size
    params = ref.seeded_params(cfg, 2**31 + 99, device)
    frames = np.random.RandomState(8).randint(
        0, 256, (2, size * 9 // 8, size * 2, 3)).astype(np.uint8)
    ref.calibrate(cfg, params, frames, device)
    return cfg, params, frames, ref


def test_higherhrnet_decode_on_the_card_equals_the_cpu(cuda_device):
    """The decode's device half, NMS and top-k with the tag gather and the
    adjust, then refine, on the card equal the CPU's on the same maps."""
    from tpupose_torch.ops import ae_decode as ae
    from tpupose_torch.topology import COCO17

    cfg, params, frames, ref = _higherhrnet_case(cuda_device)
    det, tags = ref.frame_maps(cfg, params, frames[1], cuda_device)
    tags = tags.permute(3, 0, 1, 2).contiguous()
    table = ae.top_k(det, tags).cpu()
    assert torch.equal(table, ae.top_k(det.cpu(), tags.cpu()))
    groups = ae.match_by_tag(table.numpy(), COCO17.match_order)
    persons, joints = np.nonzero(groups[:, :, 2] <= 0)
    assert len(persons) > 0
    means = ae.person_means(groups)[persons]
    on_card = ae.refine(det, tags, joints, means).cpu()
    assert torch.equal(on_card, ae.refine(det.cpu(), tags.cpu(), joints,
                                          means))
    nj = det.shape[0]
    flat, tg = det.reshape(nj, -1), tags.reshape(2, nj, -1)
    m = torch.from_numpy(means).cuda()
    launches = ae.refine_argmax.launches
    kernel = ae.refine_argmax(flat, tg, m, joints)
    assert ae.refine_argmax.launches == launches + 1
    assert torch.equal(kernel, ae.refine_argmax_plain(flat, tg, m, joints))


def test_refine_kernel_ties_on_the_card(cuda_device):
    """The refine kernel equals its plain version where scores tie: two
    pixels of one best score (the first wins), -0 beside +0 (equal), and
    more pairs of one joint than a block holds."""
    from tpupose_torch.ops import ae_decode as ae

    rng = np.random.RandomState(5)
    nj, hw = 3, 5000
    det = torch.from_numpy(rng.uniform(-0.5, 0.2, (nj, hw)).astype(
        np.float32)).cuda()
    tg = torch.from_numpy(rng.uniform(-2, 2, (2, nj, hw)).astype(
        np.float32)).cuda()
    det[0, 4000] = det[0, 1234] = 0.9                 # a tie of the best
    tg[:, 0, 4000] = tg[:, 0, 1234] = 0.5
    det[1] = -1.0
    det[1, 17], det[1, 300] = -0.0, 0.0               # -0 and +0, both best
    tg[:, 1] = 0.25
    joints = np.array([0, 0, 1, 2] + [2] * 40)
    means = np.full((len(joints), 2), 0.5, np.float32)
    means[2] = 0.25
    means[4:] = rng.uniform(-1, 1, (40, 2))
    m = torch.from_numpy(means).cuda()
    got = ae.refine_argmax(det, tg, m, joints)
    assert torch.equal(got, ae.refine_argmax_plain(det, tg, m, joints))
    assert got[:3].tolist() == [1234, 1234, 17]


def test_higherhrnet_detector_on_the_card_equals_the_reference(cuda_device):
    """``PoseDetector("higherhrnet_w32")`` on the card answers the
    benchmark's reference (BN folded, on the card) bit for bit."""
    from tpupose_torch.ops import ae_decode as ae

    cfg, params, frames, ref = _higherhrnet_case(cuda_device)
    det = PoseDetector("higherhrnet_w32", device="cuda",
                       cfg=ae.AEConfig(input_size=cfg["input_size"]))
    det.model.load_state_dict(params)
    want = ref.pose_answers(cfg, params, frames, "cuda")
    for frame, (poses, scores, _, _) in zip(frames, want):
        got, got_scores = det.collect(det.submit(frame))
        assert len(poses) > 0
        assert np.array_equal(got, poses)
        assert np.array_equal(got_scores, scores)
