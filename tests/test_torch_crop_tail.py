"""Every crop's keypoint tail in one call (``ops/crop_tail.py``) on the
CPU.

Its plain PyTorch version must give what the per-crop tail gave before it,
``CropKeypointDetector.tail_maps`` (a ``resize_chainer`` matmul and a
flip) followed by ``global_argmax_keypoints``: coordinates exact and
scores within 1e-6 (they come out bit-equal: the resize's FMA order is the
CPU matmul's), for hands' and faces' channel counts, crops smaller than
the blur's radius up to 400 px, non-square ones, mirrored ones, both tail
strides, and planted ties, where the first maximum in row-major order
wins.  ``tpupose_torch/csrc/crop_tail.cu`` has no interpret mode, but its
C++ runs here under g++ with the CUDA shim of
``test_torch_blur_nms_host.py`` (each block's threads as
``std::thread``s): its taps, reflection, mirroring, tiles, halos and
block reduction are held bit for bit against the plain version.  The
card's compiler and the hardware are checked by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import re
import shutil
import subprocess
from fractions import Fraction

import numpy as np
import pytest
import torch

from tpupose_torch.config import FaceConfig, HandConfig
from tpupose_torch.detectors import FaceDetector, HandDetector
from tpupose_torch.detectors.crop_keypoints import CropKeypointDetector
from tpupose_torch.detectors.net import float32_numerics
from tpupose_torch.ops import _cuda_build
from tpupose_torch.ops import crop_tail as ct
from tpupose_torch.ops import library
from tpupose_torch.ops.peaks import global_argmax_keypoints

from test_torch_blur_nms_host import _SHIM
from test_torch_resize_batch import _EXTRA_SHIM as _RESIZE_SHIM

SIGMA, THRESH = 2.5, 0.1


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _maps(b, h, w, c, seed):
    """Seeded maps with a few peaks a channel, as float32 (B, h, w, C)."""
    rng = np.random.RandomState(seed)
    maps = rng.rand(b, h, w, c).astype(np.float32) * 0.2
    for i in range(b):
        for ch in range(c):
            y, x = rng.randint(0, h), rng.randint(0, w)
            maps[i, y, x, ch] += rng.uniform(0.2, 1.0)
    return torch.from_numpy(maps)


def _per_crop(maps, targets, flips, sigma=SIGMA, thresh=THRESH):
    """The tail as it ran before: crop by crop, ``tail_maps`` and
    ``global_argmax_keypoints``."""
    rows = []
    with float32_numerics():
        for hm, target, flip in zip(maps, targets, flips):
            x, y, score, valid = global_argmax_keypoints(
                CropKeypointDetector.tail_maps(hm, target, flip), sigma,
                thresh)
            rows.append(torch.stack([x.float(), y.float(), score,
                                     valid.float()]))
    return torch.stack(rows)


def _assert_rows_match(got, ref):
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.equal(got[:, 0], ref[:, 0])
    assert torch.equal(got[:, 1], ref[:, 1])
    assert torch.equal(got[:, 3], ref[:, 3])
    assert (got[:, 2] - ref[:, 2]).abs().max().item() <= 1e-6


def _targets(sides, stride):
    return [tuple(-(-s // stride) * stride for s in hw) for hw in sides]


# crop sides from below the radius (10 at sigma 2.5) to 400
SIDES = [(3, 5), (9, 9), (12, 7), (64, 64), (97, 150), (192, 192),
         (400, 33), (250, 400)]


@pytest.mark.parametrize("stride", [1, 16])
@pytest.mark.parametrize("channels, hw", [(22, (46, 46)), (71, (46, 46)),
                                          (22, (8, 8)), (71, (5, 9))])
def test_plain_tails_equal_the_per_crop_tails(channels, hw, stride):
    targets = _targets(SIDES, stride)
    flips = [i % 3 == 1 for i in range(len(SIDES))]
    maps = _maps(len(SIDES), *hw, channels, seed=channels + stride)
    got = ct.crop_tails(maps, targets, flips, SIGMA, THRESH)
    _assert_rows_match(got, _per_crop(maps, targets, flips))


def _tie_maps(h, w, c, blobs):
    """Maps holding the same blob at each ``(y, x)`` of ``blobs`` in every
    channel, and nothing else."""
    maps = np.zeros((1, h, w, c), np.float32)
    blob = np.array([[0.1, 0.3, 0.1], [0.3, 0.9, 0.3], [0.1, 0.3, 0.1]],
                    np.float32)
    for y, x in blobs:
        maps[0, y - 1:y + 2, x - 1:x + 2] = blob[..., None]
    return torch.from_numpy(maps)


def _plateau_maps(b, h, w, c):
    """Maps of one value a channel: the resized and blurred values differ
    only by their rounding, so the first maximum moves with any change of
    the arithmetic's order."""
    values = 0.1 + 0.0371 * np.arange(c, dtype=np.float32)
    return torch.from_numpy(np.broadcast_to(values, (b, h, w, c)).copy())


@pytest.mark.parametrize("sigma", [SIGMA, 0.1])
def test_plain_tails_equal_the_per_crop_tails_on_plateaus(sigma):
    """Sigma 0.1 is radius 0: the keypoint is the resized map's own first
    maximum."""
    targets = _targets(SIDES, 1)
    flips = [i % 2 == 0 for i in range(len(SIDES))]
    maps = _plateau_maps(len(SIDES), 46, 46, 22)
    got = ct.crop_tails(maps, targets, flips, sigma, THRESH)
    _assert_rows_match(got, _per_crop(maps, targets, flips, sigma))
    assert len(set(got[:, :2].reshape(-1).tolist())) > 10


@pytest.mark.parametrize("target, flip, want", [
    # no resize: the blurred blobs are bit-equal; the first in row-major
    # order wins, whichever way the map is mirrored
    ((46, 46), False, (13, 12)), ((46, 46), True, (11, 12)),
    # 2x (align corners, scale 0.5 exactly): blobs a whole source pixel
    # apart stay bit-equal
    ((91, 91), False, (26, 24)), ((91, 91), True, (22, 24)),
])
def test_planted_ties_go_to_the_first_maximum(target, flip, want):
    # centres 21 px apart and 10 px from the edges: every centre's blur
    # window holds its blob alone
    maps = _tie_maps(46, 46, 3, [(12, 34), (12, 13), (33, 20)])
    got = ct.crop_tails(maps, [target], [flip], SIGMA, THRESH)
    _assert_rows_match(got, _per_crop(maps, [target], [flip]))
    assert tuple(got[0, :2, 0].int().tolist()) == want
    flat = torch.zeros(1, 6, 6, 2)     # all equal: pixel 0 wins
    assert got.new_tensor([0, 0, 0, 0]).tolist() == ct.crop_tails(
        flat, [(20, 30)], [True], SIGMA, THRESH)[0, :, 0].tolist()


def test_a_cpu_tensor_takes_the_plain_route(monkeypatch):
    def no_kernel():
        raise AssertionError("the CPU route loaded the kernel")

    monkeypatch.setattr(ct, "_library", no_kernel)
    before = (ct.crop_tails.launches, sum(ct.crop_tails.shapes.values()))
    maps = _maps(2, 8, 8, 4, seed=1)
    got = ct.crop_tails(maps, [(20, 20), (30, 17)], [False, True], SIGMA,
                        THRESH)
    assert torch.equal(got, ct.crop_tails_plain(
        maps, [(20, 20), (30, 17)], [False, True], SIGMA, THRESH))
    assert (ct.crop_tails.launches,
            sum(ct.crop_tails.shapes.values())) == before


def test_a_crop_alone_equals_the_same_crop_among_eight():
    rng = np.random.RandomState(4)
    sides = [tuple(int(s) for s in hw) for hw in rng.randint(5, 200, (8, 2))]
    flips = [i % 2 == 0 for i in range(8)]
    maps = _maps(8, 46, 46, 22, seed=5)
    batch = ct.crop_tails(maps, sides, flips, SIGMA, THRESH)
    for i in (0, 3, 7):
        alone = ct.crop_tails(maps[i:i + 1].clone(), sides[i:i + 1],
                              flips[i:i + 1], SIGMA, THRESH)
        assert torch.equal(alone[0], batch[i])


@pytest.mark.parametrize("maps, targets, flips, sigma, match", [
    (torch.zeros(1, 8, 8, 3, dtype=torch.float64), [(9, 9)], [False], SIGMA,
     "float32"),
    (torch.zeros(8, 8, 3), [(9, 9)], [False], SIGMA, "float32"),
    (torch.zeros(1, 8, 3, 8).transpose(2, 3), [(9, 9)], [False], SIGMA,
     "contiguous"),
    (torch.zeros(1, 8, 8, 1), [(9, 9)], [False], SIGMA, "C >= 2"),
    (torch.zeros(1, 129, 128, 3), [(9, 9)], [False], SIGMA, "h x w"),
    (torch.zeros(2, 8, 8, 3), [(9, 9)], [False, True], SIGMA, "targets"),
    (torch.zeros(1, 8, 8, 3), [(9, 9)], [], SIGMA, "flips"),
    (torch.zeros(1, 8, 8, 3), [(0, 9)], [False], SIGMA, "target size"),
    (torch.zeros(1, 8, 8, 3), [(9, ct.MAX_SIDE + 1)], [False], SIGMA,
     "target size"),
    (torch.zeros(1, 8, 8, 3), [(9, 9)], [False], 16.5, "radius"),
])
def test_crop_tails_refuses_what_the_kernel_does_not_take(
        maps, targets, flips, sigma, match):
    with pytest.raises(ValueError, match=match):
        ct.crop_tails(maps, targets, flips, sigma, THRESH)


def test_the_largest_sides_and_radius_are_taken():
    maps = _maps(1, 4, 4, 2, seed=6)
    targets, flips = [(ct.MAX_SIDE, 3)], [True]
    _assert_rows_match(ct.crop_tails(maps, targets, flips, SIGMA, THRESH),
                       _per_crop(maps, targets, flips))
    sigma = 11.9        # radius 48
    _assert_rows_match(ct.crop_tails(maps, [(70, 9)], flips, sigma, THRESH),
                       _per_crop(maps, [(70, 9)], flips, sigma))


def _exact_fma(a, b, c):
    """float32 ``a * b + c`` rounded once to nearest even, from the exact
    rational value."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - v),
                                     int(np.array(x).view(np.int32)) & 1))


def test_fma_rounds_once():
    rng = np.random.RandomState(7)
    a = rng.randn(2000).astype(np.float32)
    b = rng.randn(2000).astype(np.float32)
    c = (rng.randn(2000) * np.exp2(rng.randint(-40, 40, 2000))).astype(
        np.float32)
    # the cancelling cases, where a sum rounded twice goes astray
    c[:700] = -(a[:700].astype(np.float64) * b[:700]).astype(np.float32)
    got = ct._fma(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    want = np.array([_exact_fma(*v) for v in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_the_library_op_equals_the_wrapper_and_traces():
    maps = _maps(3, 8, 8, 5, seed=8)
    targets, flips = [(20, 9), (9, 30), (8, 8)], [True, False, True]
    want = ct.crop_tails(maps, targets, flips, SIGMA, THRESH)
    assert torch.equal(torch.ops.tpupose.crop_tails(
        maps, [v for hw in targets for v in hw], flips, SIGMA, THRESH), want)
    with library.traced_ops():
        assert torch.equal(library.crop_tails(maps, targets, flips, SIGMA,
                                              THRESH), want)

    class Tail(torch.nn.Module):
        def forward(self, hm):
            with library.traced_ops():
                return library.crop_tails(hm[None], [(20, 9)], [True],
                                          SIGMA, THRESH)[0]

    program = torch.export.export(Tail(), (maps[0],))
    assert any("crop_tails" in str(n.target)
               for n in program.graph.nodes)
    assert torch.equal(program.module()(maps[0]), want[0])


@pytest.mark.parametrize("arch", ["facenet", "handnet"])
@pytest.mark.parametrize("stride", [1, 16])
def test_detector_tails_equal_their_per_crop_programs(arch, stride):
    """``submit_tails`` makes one ``crop_tails`` call; each crop's row
    equals ``_tail_fn``'s (the program a crop bundle exports) and the
    per-crop tail."""
    cls, cfg = {"facenet": (FaceDetector, FaceConfig(img_size=64)),
                "handnet": (HandDetector, HandConfig(img_size=64))}[arch]
    det = cls(cfg=cfg, device="cpu", seed=0, tail_stride=stride)
    channels = cfg.num_keypoints + 1
    hws = [(40, 36), (5, 70), (120, 90)]
    flips = [False, True, True]
    # channels-last views of channels-first maps, as a net may return
    maps = _maps(3, 8, 8, channels, seed=stride).permute(
        0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not maps.is_contiguous()
    rows, scales = det.submit_tails(maps, hws, flips)
    targets = [det._tail_target(hw)[0] for hw in hws]
    assert scales == [det._tail_target(hw)[1] for hw in hws]
    _assert_rows_match(rows, _per_crop(maps, targets, flips,
                                       cfg.gaussian_sigma,
                                       cfg.heatmap_peak_thresh))
    for i, (target, flip) in enumerate(zip(targets, flips)):
        assert torch.equal(det._tail_fn(target, flip)(maps[i]), rows[i])


# --- the kernel's own source, built with g++ --------------------------------


def _host_source(cuda_source: str) -> str:
    src = cuda_source.replace("#include <cuda_runtime.h>",
                              '#include "host_shim.h"')
    src, n_smem = re.subn(
        r"extern __shared__ __align__\(16\) int (\w+)\[\];",
        r"int* \1 = host_smem;", src)
    src, n_launch = re.subn(r"(\w+)<<<(.*?)>>>\(", r"host_launch(\1, \2, ",
                            src, flags=re.S)
    assert (n_smem, n_launch) == (1, 1), "crop_tail.cu changed: update shim"
    return src


_EXTRA_SHIM = _RESIZE_SHIM + r"""
#include <cmath>
using std::isnan;
inline float __fmaf_rn(float a, float b, float c) {
  return std::fmaf(a, b, c);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("crop_tail_host")
    (out / "host_shim.h").write_text(_SHIM + _EXTRA_SHIM)
    with open(_cuda_build.source("crop_tail")) as f:
        (out / "crop_tail_host.cpp").write_text(_host_source(f.read()))
    lib_path = str(out / "crop_tail_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-o", lib_path,
                    str(out / "crop_tail_host.cpp")], check=True, timeout=300)
    return ct.bind(ctypes.CDLL(lib_path))


def _host_tails(lib, maps, targets, flips, sigma=SIGMA):
    c_taps, radius = ct._taps(sigma)
    out = torch.full((maps.shape[0], 4, maps.shape[-1] - 1), 7.0)
    items = [(th, tw, f) for (th, tw), f in zip(targets, flips)]
    launches = ct._launch(lib, maps, items, out, c_taps, radius, THRESH,
                          None)
    return out, launches


@pytest.mark.parametrize("case", ["request", "below_radius", "tiles",
                                  "ties", "identity", "wide_radius",
                                  "plateau", "plateau_radius_0",
                                  "plateau_radius_8"])
def test_kernel_source_matches_plain_on_host(host_kernel, case):
    rng = np.random.RandomState(len(case))
    sigma = SIGMA
    if case == "request":        # the hand cell's crops, fewer channels
        targets = [(int(s), int(s)) for s in rng.randint(64, 193, 4)]
        maps, flips = _maps(4, 46, 46, 3, seed=1), [True, False] * 2
    elif case == "below_radius":
        targets, flips = [(3, 5), (1, 1), (7, 2)], [True, False, True]
        maps = _maps(3, 5, 9, 3, seed=2)
    elif case == "tiles":        # ragged tiles both ways, a one-row map
        targets, flips = [(33, 65), (97, 130), (5, 129)], [False, True, True]
        maps = _maps(3, 1, 7, 2, seed=3)
    elif case == "ties":
        targets, flips = [(46, 46), (91, 91)], [True, False]
        maps = torch.cat([_tie_maps(46, 46, 3, [(12, 34), (12, 13),
                                                (33, 20)])] * 2)
    elif case == "identity":     # no resize: 8x8 maps to 8x8
        targets, flips = [(8, 8)], [True]
        maps = _maps(1, 8, 8, 4, seed=4)
    elif case.startswith("plateau"):   # every bit of the order shows
        # radius 10 takes the unrolled kernel, 0 and 8 the run-time one
        sigma = {"plateau": SIGMA, "plateau_radius_0": 0.1,
                 "plateau_radius_8": 2.0}[case]
        targets = [(64, 97), (150, 71), (9, 130), (46, 46)]
        maps, flips = _plateau_maps(4, 46, 46, 12), [True, False] * 2
    else:                        # radius 32, the halo wider than a tile
        sigma = 8.0
        targets, flips = [(40, 70), (3, 3)], [True, False]
        maps = _maps(2, 8, 8, 2, seed=5)
    got, launches = _host_tails(host_kernel, maps, targets, flips, sigma)
    assert launches == 1
    assert torch.equal(got, ct.crop_tails_plain(maps, targets, flips, sigma,
                                                THRESH))


def test_kernel_source_takes_more_crops_than_a_launch_holds(host_kernel):
    n = ct.MAX_ITEMS + 1
    rng = np.random.RandomState(9)
    targets = [tuple(int(s) for s in hw) for hw in rng.randint(1, 12, (n, 2))]
    flips = [bool(f) for f in rng.randint(0, 2, n)]
    maps = _maps(n, 3, 4, 2, seed=10)
    got, launches = _host_tails(host_kernel, maps, targets, flips)
    assert launches == 2
    assert torch.equal(got, ct.crop_tails_plain(maps, targets, flips, SIGMA,
                                                THRESH))
