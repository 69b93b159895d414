"""Tests of the port that need an NVIDIA GPU; they skip without one.

This file imports neither JAX nor the JAX test helpers, so it also runs on
a machine without JAX:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Each kernel must equal its plain PyTorch version bit for bit (it rounds
every product and sum as PyTorch's eager ops do), the detector on the card
must find the pose table the CPU finds from the same weights, and the card's
int8 forward must equal the CPU's int8 forward bit for bit.
"""

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
    tile, at B = 2 and relu off; 40 channels stage as whole 16-byte chunks
    zero-padded to 64."""
    x, kq, mult, bias = _conv_s8_case(np.random.RandomState(tile), 2, 19,
                                      37, c, o, k, cuda_device)
    got = cs.conv_s8(x, kq, mult, bias, relu=False, tile=tile)
    ref = cs.conv_s8_reference(x, kq, mult, bias, relu=False)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


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
        qtree, static, cuda_device, pack_kernels=True), "kernel")
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
    got = ops.conv_s8(xq, kq, mult, bias, True, cs.pack_conv_s8_weights(kq))
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
    from tpupose_torch.detectors.pose import float32_numerics
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
    from tpupose_torch.detectors.pose import float32_numerics

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
    from tpupose_torch.detectors.pose import float32_numerics
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
