"""HigherHRNet-W32 on the port (``models/higherhrnet.py``, the
associative-embedding decode of ``ops/ae_decode.py`` behind
``PoseDetector(arch="higherhrnet_w32")``, the ``COCO17`` topology) against
the benchmark's plain reference ``posebench/reference/higherhrnet.py``, on
the CPU at 64-128 px inputs with seeded weights and BN statistics.

- The port's forward (each BN folded into its conv once, in float64)
  equals the published order (conv, then BN) to 2e-5 of each output's
  largest value: the fold rounds each folded weight once where the
  published order rounds the conv's sum and then the BN's affine, a few
  ulps a layer over 303 convs (1.3e-6 measured at 64x96).  It equals the
  reference's own folded forward bit for bit, which the benchmark's
  answers use.
- Every fuse shape of 2, 3 and 4 branches, and the 1-output last module.
- ``assign`` is the first optimal assignment in row order: against
  brute force over every assignment (rectangular both ways, with many
  equal costs), the reference's independent solver, and SciPy's total.
- ``match_by_tag``'s rules on hand-built tables; adjust and refine
  (including ties) and the whole decode equal the reference's on the same
  maps; the detector's poses equal the reference's on calibrated weights.
"""

import itertools
import types
from fractions import Fraction

import numpy as np
import pytest
import torch

from posebench.core import registry
from posebench.reference import higherhrnet as ref
from tpupose_torch.detectors.pose import PoseDetector
from tpupose_torch.models.higherhrnet import HigherHRNetW32
from tpupose_torch.ops import ae_decode as ae
from tpupose_torch.topology import COCO17

SIZE = 64                     # input_size: a 72x128 frame gives 64x128
CFG = ae.AEConfig(input_size=SIZE)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cfg():
    c = registry.config("higherhrnet_w32")
    c["input_size"] = SIZE
    return c


@pytest.fixture(scope="module")
def model():
    return HigherHRNetW32(seed=5).eval()


@pytest.fixture(scope="module")
def calibrated(cfg):
    """Seeded reference weights calibrated on three frames, the frames, and
    a detector holding the weights."""
    params = ref.seeded_params(cfg, 2**31 + 77, "cpu")
    frames = np.random.RandomState(3).randint(
        0, 256, (3, 72, 128, 3)).astype(np.uint8)
    ref.calibrate(cfg, params, frames, "cpu")
    det = PoseDetector("higherhrnet_w32", cfg=CFG, device="cpu")
    det.model.load_state_dict(params)
    return params, frames, det


def test_state_dict_is_the_sources(cfg, model):
    sd = model.state_dict()
    shapes = ref.param_shapes(cfg)
    assert list(sd) == list(shapes)
    assert all(tuple(sd[k].shape) == s for k, s in shapes.items())
    for key in ("conv1.weight", "bn1.running_var",
                "layer1.0.downsample.0.weight", "transition1.1.0.0.weight",
                "stage3.2.fuse_layers.2.0.1.0.weight", "final_layers.0.bias",
                "deconv_layers.0.0.0.weight", "deconv_layers.0.4.0.bn2.bias"):
        assert key in sd


def test_hand_counts(cfg, model):
    n = sum(p.numel() for p in model.parameters())
    assert n == ref.param_count(cfg) == 28_645_331          # 28.6 M
    assert sum(isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
               for m in model.modules()) == len(ref.convs(cfg)) == 303
    # the stem at 1/2 and 1/4: 3*64*9*(256*256) + 64*64*9*(128*128)
    stem = sum(c.k * c.k * c.cin * c.cout * h * w
               for c, (h, w) in ref.conv_grids(cfg, (512, 512))
               if c.key in ("conv1", "conv2"))
    assert stem == 3 * 64 * 9 * 256 * 256 + 64 * 64 * 9 * 128 * 128
    # the deconv: each of 64x64 input pixels scatters 4x4 taps of 66 x 32
    deconv = [c for c in ref.convs(cfg) if c.transposed]
    assert [(c.cin, c.cout, c.k) for c in deconv] == [(66, 32, 4)]
    assert ref.forward_macs(cfg, (512, 512)) == 47_568_650_240
    assert ref.forward_macs(cfg, (512, 960), 2) == 178_382_438_400


def _inputs(b=2, hw=(64, 96), seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        b, 3, *hw).astype(np.float32))


def test_folded_forward_equals_the_published_one(cfg, model):
    params = {k: v.clone() for k, v in model.state_dict().items()}
    x = _inputs()
    with torch.no_grad():
        ours = model(x)
        published = ref.forward(cfg, params, x, fold=False)
        folded = ref.forward(cfg, params, x, fold=True)
    for o, p, f in zip(ours, published, folded):
        assert float((o - p).abs().max()) <= 2e-5 * float(p.abs().max())
        assert torch.equal(o, f)


@pytest.mark.parametrize("stage,module", [(0, 0), (1, 0), (1, 3), (2, 0),
                                          (2, 2)])
def test_fuse_units(cfg, model, stage, module):
    """A module's blocks and fuse units, 2 (stage2), 3 (stage3) and 4
    (stage4) branches; stage4's last fuses to branch 0 only."""
    s = cfg["stages"][stage]
    xs = [_inputs(1, (16 >> b, 24 >> b), seed=b)[:, :1].repeat(1, c, 1, 1)
          * torch.linspace(0.5, 1.5, c)[None, :, None, None]
          for b, c in enumerate(s["num_channels"])]
    unit = getattr(model, s["name"])[module]
    params = dict(model.state_dict())
    with torch.no_grad():
        ours = unit([x.clone() for x in xs])
        theirs = ref.module_forward(cfg, params, stage, module, xs)
    outputs = 1 if (stage, module) == (2, 2) else s["num_branches"]
    assert len(ours) == len(theirs) == outputs
    for i, (o, t) in enumerate(zip(ours, theirs)):
        assert o.shape == (1, s["num_channels"][i], 16 >> i, 24 >> i)
        assert torch.equal(o, t)


# ----------------------------------------------------------------------
# the Hungarian
# ----------------------------------------------------------------------

def _brute_first(rounded, vals, cols):
    """The first least assignment in row order, over every assignment of
    the rows to ``cols`` columns, of ``round(d) * 100 - val`` with 1e10
    columns past the block, summed exactly."""
    rows, grouped = rounded.shape
    best, pick = None, None
    for perm in itertools.permutations(range(cols), rows):
        total = sum(Fraction(int(rounded[r, c])) * 100
                    - Fraction(float(vals[r])) if c < grouped
                    else Fraction(10**10) for r, c in enumerate(perm))
        if best is None or total < best:
            best, pick = total, perm
    return list(pick)


def _case(rng, rows, grouped, valued):
    """Rounded distances 0-2, so many assignments tie; values in (0.1,
    0.9), or all 0.5."""
    rounded = rng.randint(0, 3, (rows, grouped)).astype(np.float64)
    vals = (rng.uniform(0.1, 0.9, rows) if valued else np.full(rows, 0.5)
            ).astype(np.float32).astype(np.float64)
    return rounded, vals


@pytest.mark.parametrize("rows,grouped", [(1, 1), (3, 3), (4, 6), (6, 4),
                                          (7, 7), (2, 7), (7, 2), (5, 5)])
def test_assign_is_the_first_least_assignment(rows, grouped):
    rng = np.random.RandomState(rows * 10 + grouped)
    for trial in range(6):
        rounded, vals = _case(rng, rows, grouped, trial % 2)
        cols = max(rows, grouped)
        want = _brute_first(rounded, vals, cols)
        cost = ae.match_costs(rounded, vals)
        got = list(ae.assign(cost, cols))
        theirs = ref.assign(rounded, vals, cols)
        real = [c if c < grouped else -1 for c in want]
        assert [c if c < grouped else -1 for c in got] == real
        assert [c if c < grouped else -1 for c in theirs] == real


def test_assign_total_equals_scipys():
    from scipy.optimize import linear_sum_assignment

    rng = np.random.RandomState(9)
    for rows, grouped in [(5, 9), (9, 5), (12, 12), (20, 30), (30, 17)]:
        rounded, vals = _case(rng, rows, grouped, True)
        cols = max(rows, grouped)
        padded = np.concatenate([np.round(rounded) * 100 - vals[:, None],
                                 np.full((rows, cols - grouped), 1e10)],
                                axis=1)
        r, c = linear_sum_assignment(padded)
        cost = ae.match_costs(rounded, vals)
        got = ae.assign(cost, cols)
        theirs = ref.assign(rounded, vals, cols)
        assert [c if c < grouped else -1 for c in got] == \
            [c if c < grouped else -1 for c in theirs]

        def total(pairs):
            return sum(Fraction(int(rounded[i, j])) * 100
                       - Fraction(float(vals[i])) if j < grouped
                       else Fraction(10**10) for i, j in pairs)

        assert total(enumerate(got)) == total(zip(r, c))
        assert len(set(got.tolist())) == rows


def test_match_costs_are_exact():
    vals = np.array([0.1, 0.7, 3.5], np.float32).astype(np.float64)
    rounded = np.array([[0.0, 2.0], [1e6, 1.0], [7.0, 0.0]])
    cost = ae.match_costs(rounded, vals)
    scale = Fraction(cost[0, 1] + int(vals[0] * 2**27), 200)
    for i in range(3):
        for j in range(2):
            assert Fraction(int(cost[i, j])) == (
                Fraction(int(rounded[i, j])) * 100
                - Fraction(float(vals[i]))) * scale
    with pytest.raises(ValueError):
        ae.match_costs(np.array([[1e12]]), np.array([0.5]))


# ----------------------------------------------------------------------
# match_by_tag
# ----------------------------------------------------------------------

def _table(rows_by_joint, k=4):
    """(17, k, 7) table: per joint its rows (x, y, val, t0, t1); the
    adjusted coordinates x + 0.25, y + 0.75."""
    t = np.zeros((17, k, 7), np.float32)
    for j, rows in rows_by_joint.items():
        for i, (x, y, v, t0, t1) in enumerate(rows):
            t[j, i] = (x, y, v, t0, t1, x + 0.75, y + 0.25)
    return t


def _ref_candidates(table):
    out = []
    for j in range(table.shape[0]):
        rows = table[j][table[j][:, 2].astype(np.float64) > 0.1]
        out.append((rows[:, :5].astype(np.float64), rows[:, 3:5].copy()))
    return out


def _match_both(table, cfg, order=COCO17.match_order):
    ours = ae.match_by_tag(table, order)
    theirs = ref.match_by_tag(cfg, _ref_candidates(table))
    assert ours.shape[:2] == theirs.shape[:2]
    assert np.array_equal(ours[:, :, :5], theirs)
    return ours


def test_match_rules(cfg):
    t = _table({
        0: [(10, 10, 0.9, 0.0, 0.0), (50, 10, 0.5, 5.0, 5.0),
            (90, 10, 0.09, 9.0, 9.0)],           # not over 0.1
        1: [(11, 12, 0.8, 0.6, 0.2),             # joins 0.0 (0.63 < 1)
            (52, 12, 0.7, 6.2, 5.0),             # 1.2 from 5.0: opens one
            (70, 12, 0.4, 20.0, 20.0)],          # opens another
        2: [(9, 12, 0.6, 0.5, 0.5), (49, 12, 0.3, 5.1, 5.1)],
    })
    g = _match_both(t, cfg)
    # insertion order: the nose's two groups, then joint 1's new ones
    assert g.shape[0] == 4
    assert g[0, 0, 0] == 10 and g[0, 1, 0] == 11 and g[0, 2, 0] == 9
    assert g[1, 0, 0] == 50 and g[1, 1, 2] == 0 and g[1, 2, 0] == 49
    assert g[2, 1, 0] == 52 and g[3, 1, 0] == 70
    # scores: the mean of the 17 values, taken before refine
    persons = g.copy()
    assert np.isclose(persons[0, :, 2].mean(), (0.9 + 0.8 + 0.6) / 17)


def test_match_pads_with_1e10_and_keys_by_tag(cfg):
    """More candidates than groups: the padded columns open groups, the
    higher values keep the real ones; an equal pass-0 tag lands in the
    group of that key and restarts its tags."""
    t = _table({
        0: [(10, 10, 0.9, 1.0, 1.0)],
        1: [(11, 10, 0.3, 1.2, 1.0), (12, 10, 0.8, 1.1, 1.0),
            (13, 10, 0.5, 1.3, 1.0)],
        2: [(14, 10, 0.7, 1.0, 4.0)],            # key 1.0 again: lands there
    })
    g = _match_both(t, cfg)
    assert g[0, 1, 0] == 12                      # the largest value joins
    assert g.shape[0] == 3
    assert g[0, 2, 0] == 14                      # the equal key's group


def test_match_more_groups_than_max_num_people(cfg):
    rng = np.random.RandomState(4)
    rows = {j: [(float(rng.randint(0, 200)), float(rng.randint(0, 100)),
                 float(rng.uniform(0.2, 1.0)), float(rng.uniform(-3, 3)),
                 float(rng.uniform(-3, 3))) for _ in range(30)]
            for j in range(17)}
    g = _match_both(_table(rows, k=30), cfg)
    assert g.shape[0] > ae.MAX_NUM_PEOPLE


# ----------------------------------------------------------------------
# adjust, refine and the whole decode against the reference
# ----------------------------------------------------------------------

def _maps(seed, j=17, hw=(24, 32)):
    rng = np.random.RandomState(seed)
    det = torch.from_numpy(rng.uniform(-0.2, 0.6, (j, *hw)).astype(
        np.float32))
    tags = torch.from_numpy(rng.uniform(-2, 2, (2, j, *hw)).astype(
        np.float32))
    return det, tags


def test_refine_and_its_ties_equal_the_reference():
    det, tags = _maps(1)
    # ties: joint 3's best value twice (the first in row-major order
    # wins); joint 4 a plateau of the person's own tag, whose neighbours
    # are equal (the first pixel, and the adjust's else)
    det[3, 5, 7] = det[3, 9, 2] = 5.0
    tags[:, 3, 5, 7] = tags[:, 3, 9, 2] = 0.25
    det[4] = 0.3
    tags[:, 4] = 0.25
    person = np.zeros((17, 5), np.float32)
    person[0] = (3, 4, 0.9, 0.25, 0.25)
    person[1] = (8, 2, 0.7, 0.25, 0.25)
    ref_det = det.numpy()
    want = ref.refine(det, tags.permute(1, 2, 3, 0), person.copy(), ref_det)
    missing = np.arange(2, 17)
    means = np.repeat(ae.person_means(person[None]), 15, 0)
    got = ae.refine(det, tags, missing, means).numpy()
    fill = got[:, 2] > 0
    assert np.array_equal(got[fill], want[2:, :3][fill])
    assert tuple(got[1, :2]) == (7.5 - 0.25, 5.5 - 0.25)   # joint 3: (7, 5)
    assert tuple(got[2, :2]) == (0.25, 0.25)                # plateau: (0, 0)


def test_refine_groups_pairs_by_joint():
    joints = np.array([4, 1, 4, 4, 1] + [7] * 35)
    order, groups = ae._groups(joints)
    assert list(order[:5]) == [1, 4, 0, 2, 3]        # stable within a joint
    assert groups.tolist() == [[1, 0, 2], [4, 2, 3], [7, 5, 16], [7, 21, 16],
                               [7, 37, 3]]
    for j, first, n in groups:
        assert (joints[order[first:first + n]] == j).all()


# ``csrc/ae_refine.cu`` has no interpret mode, but its C++ runs here under
# g++ with the CUDA shim of ``test_torch_blur_nms_host.py`` (each block's
# threads as ``std::thread``s); a warp's shuffle exchanges through the
# block's shared words between two barriers (every thread of a block takes
# each shuffle, as the kernel's block-wide ``count`` makes them).
_REFINE_SHIM = r"""
#include <atomic>
#include <cmath>
#include <cstring>
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline unsigned long long __shfl_xor_sync(unsigned, unsigned long long v,
                                          int lane_mask) {
  auto* words = reinterpret_cast<unsigned long long*>(host_smem + 1024);
  words[threadIdx.x] = v;
  __syncthreads();
  const unsigned long long other = words[threadIdx.x ^ lane_mask];
  __syncthreads();
  return other;
}
inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  std::atomic_ref<unsigned long long> a(*p);
  unsigned long long cur = a.load();
  while (cur < v && !a.compare_exchange_weak(cur, v)) {
  }
  return cur;
}
"""


def _refine_host_source(cuda_source: str) -> str:
    import re

    src = cuda_source.replace("#include <cuda_runtime.h>",
                              '#include "host_shim.h"')
    src, n_float = re.subn(
        r"__shared__ float m0\[AE_REFINE_GROUP\], m1\[AE_REFINE_GROUP\];",
        "float* m0 = reinterpret_cast<float*>(host_smem);"
        " float* m1 = m0 + AE_REFINE_GROUP;", src)
    src, n_int = re.subn(r"__shared__ int pair\[AE_REFINE_GROUP\];",
                         "int* pair = host_smem + 2 * AE_REFINE_GROUP;", src)
    src, n_launch = re.subn(r"(\w+)<<<(.*?)>>>\(", r"host_launch(\1, \2, ",
                            src, flags=re.S)
    assert (n_float, n_int, n_launch) == (1, 1, 1), \
        "ae_refine.cu changed: update the shim"
    return src


@pytest.fixture(scope="module")
def refine_host_kernel(tmp_path_factory):
    import ctypes
    import shutil
    import subprocess

    from test_torch_blur_nms_host import _SHIM
    from tpupose_torch.ops import _cuda_build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("ae_refine_host")
    (out / "host_shim.h").write_text(_SHIM + _REFINE_SHIM)
    with open(_cuda_build.source("ae_refine")) as f:
        (out / "ae_refine_host.cpp").write_text(_refine_host_source(f.read()))
    lib_path = str(out / "ae_refine_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-o", lib_path,
                    str(out / "ae_refine_host.cpp")], check=True, timeout=300)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ae_refine_launch.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.ae_refine_launch.restype = i
    return lib


@pytest.mark.parametrize("case", ["ties", "many_pairs"])
def test_refine_kernel_source_equals_plain_on_host(refine_host_kernel, case):
    """The kernel's own source picks ``refine_argmax_plain``'s pixels: a
    tie of the best score (the first pixel), -0 beside +0 (equal), pixels
    past the last block's end, and more pairs of one joint than a block
    holds."""
    rng = np.random.RandomState(5)
    nj, hw = (3, 2500) if case == "ties" else (2, 700)
    det = torch.from_numpy(rng.uniform(-0.5, 0.2, (nj, hw)).astype(
        np.float32))
    tg = torch.from_numpy(rng.uniform(-2, 2, (2, nj, hw)).astype(
        np.float32))
    if case == "ties":
        det[0, 2100] = det[0, 1234] = 0.9
        tg[:, 0, 2100] = tg[:, 0, 1234] = 0.5
        det[1] = -1.0
        det[1, 17], det[1, 300] = -0.0, 0.0
        tg[:, 1] = 0.25
        joints = np.array([0, 0, 1, 2, 2])
        means = np.full((len(joints), 2), 0.5, np.float32)
        means[2] = 0.25
    else:
        joints = np.array([1] * 20 + [0] * 3 + [1] * 15)
        means = rng.uniform(-1, 1, (len(joints), 2)).astype(np.float32)
    m = torch.from_numpy(means)
    order, groups = ae._groups(joints)
    best = torch.zeros(len(joints), dtype=torch.int64)
    err = refine_host_kernel.ae_refine_launch(
        det.data_ptr(), tg.data_ptr(), m.data_ptr(),
        torch.from_numpy(groups).data_ptr(),
        torch.from_numpy(order).data_ptr(), best.data_ptr(), len(groups),
        nj, hw, None)
    assert err == 0
    got = 0xFFFFFFFF - (best & 0xFFFFFFFF)
    assert torch.equal(got, ae.refine_argmax_plain(det, tg, m, joints))
    if case == "ties":
        assert got[:3].tolist() == [1234, 1234, 17]


def test_adjust_equals_the_reference():
    det, _ = _maps(2)
    det[0, 3, 4] = det[0, 3, 5] = det[0, 3, 3]     # equal x neighbours
    table = ae.top_k(det, torch.zeros(2, 17, 24, 32)).numpy()
    groups = np.zeros((1, 17, 5), np.float32)
    groups[0, :, :3] = table[:, 0, :3]
    groups[0, :, 2] = 1.0
    groups[0, 0, :2] = (4, 3)
    want = ref.adjust(groups.copy(), det.numpy())
    dx = [0.25 if det[j, int(y), min(int(x) + 1, 31)]
          > det[j, int(y), max(int(x) - 1, 0)] else -0.25
          for j, (x, y) in enumerate(groups[0, :, :2])]
    assert want[0, 0, 0] == 4 - 0.25 + 0.5                  # equal: -0.25
    assert np.allclose(want[0, :, 0], groups[0, :, 0] + np.array(dx) + 0.5)
    rows = table[:, 0]
    assert np.array_equal(want[0, 1:, :2], rows[1:, 5:7])


def test_top_k_orders_equal_values_in_row_major():
    det = torch.zeros(1, 8, 8)
    for y, x in ((6, 1), (1, 6), (1, 1)):
        det[0, y, x] = 0.5
    table = ae.top_k(det, torch.zeros(2, 1, 8, 8)).numpy()
    assert [tuple(r[:2]) for r in table[0, :3]] == [(1, 1), (6, 1), (1, 6)]
    assert table[0, 3, 2] == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_equals_the_reference_on_the_same_maps(cfg, calibrated, seed):
    params, frames, det = calibrated
    frame = frames[seed + 1]
    g = ref.geometry(cfg, frame.shape[:2])
    d, t = ref.frame_maps(cfg, params, frame, "cpu")
    groups, scores, _ = ref.parse(cfg, d, t)
    tg = t.permute(3, 0, 1, 2).contiguous()
    geom = ae.ae_geometry(*frame.shape[:2], SIZE)
    pending = ae.start_fetch(d, tg, ae.top_k(d, tg), geom)
    persons, ours = ae.ae_decode(pending, COCO17.match_order)
    assert len(groups) > 0
    assert np.array_equal(ae.final_poses(persons, geom),
                          ref.final_poses(g, groups))
    assert np.array_equal(ours, scores)


def test_detector_poses_equal_the_reference(cfg, calibrated):
    params, frames, det = calibrated
    want = ref.pose_answers(cfg, params, frames, "cpu")
    before = (ae.ae_decode.candidates, ae.ae_decode.persons,
              ae.ae_decode.refilled)
    for frame, (poses, scores, most, scale) in zip(frames, want):
        got, got_scores = det(frame)
        assert len(poses) > 0 and 0 < most <= ae.MAX_NUM_PEOPLE
        assert got.shape == poses.shape and got.shape[1:] == (17, 3)
        assert np.array_equal(got, poses)
        assert np.array_equal(got_scores, scores)
    after = (ae.ae_decode.candidates, ae.ae_decode.persons,
             ae.ae_decode.refilled)
    assert all(a > b for a, b in zip(after, before))
    # submit / collect is __call__
    got, got_scores = det.collect(det.submit(frames[0]))
    assert np.array_equal(got, want[0][0])
    (hm, tags), scale = det.compute_maps(frames[0])
    assert hm.shape == (17, 64, 128) and tags.shape == (2, 17, 64, 128)
    assert scale == want[0][3]


def test_geometry_is_the_sources():
    for frame_hw, in_hw, res_hw in (((720, 1280), (512, 960), (512, 910)),
                                    ((480, 640), (512, 704), (512, 683)),
                                    ((1280, 720), (960, 512), (910, 512)),
                                    ((512, 512), (512, 512), (512, 512))):
        g = ae.ae_geometry(*frame_hw)
        assert (g.in_hw, g.res_hw) == (in_hw, res_hw)
        assert g.offset == ((in_hw[0] - res_hw[0]) // 2,
                            (in_hw[1] - res_hw[1]) // 2)
    tiny = np.full((1, 1, 3), 7, np.uint8)
    out = ae.place_frame(tiny, ae.ae_geometry(1, 1, SIZE))
    assert out.shape == (64, 64, 3) and (out == 7).all()


def test_coco17_topology():
    fi = COCO17.flip_index
    assert sorted(fi) == list(range(17)) and all(fi[fi[j]] == j
                                                 for j in range(17))
    for j, name in enumerate(COCO17.parts):
        mirror = COCO17.parts[fi[j]]
        assert mirror == name.replace("left", "@").replace(
            "right", "left").replace("@", "right")
    assert sorted(COCO17.match_order) == list(range(17))
    assert len(COCO17.skeleton) == 19 and COCO17.limbs == ()
    assert COCO17.num_joints == 17


def test_draws_the_coco17_skeleton():
    from tpupose_torch.detectors.draw import draw_person_pose

    img = np.zeros((40, 40, 3), np.uint8)
    pose = np.zeros((1, 17, 3))
    pose[0, 5] = (5, 5, 0.5)
    pose[0, 7] = (30, 30, 0.5)                   # left shoulder - elbow
    out = draw_person_pose(img, pose, COCO17)
    assert out[18, 18].any() and not out[35, 5].any()


def test_unsupported_entry_points_raise(calibrated, tmp_path):
    _, frames, det = calibrated
    with pytest.raises(NotImplementedError):
        det.detect_batch(frames[:2])
    with pytest.raises(NotImplementedError):
        det.compute_maps_batch(frames[:2])
    with pytest.raises(NotImplementedError):
        det.detect_precise(frames[0])
    with pytest.raises(NotImplementedError):
        det.quantize(frames[:1])
    from tpupose_torch import serving

    with pytest.raises(NotImplementedError):
        serving.save_bundle(det, str(tmp_path / "b"), [(72, 128)],
                            platforms=("cpu",))
    with pytest.raises(NotImplementedError):
        PoseDetector("higherhrnet_w32", precise=True, device="cpu")
    with pytest.raises(NotImplementedError):
        PoseDetector("higherhrnet_w32", device="cpu",
                     mesh=types.SimpleNamespace(device="cpu"))
    with pytest.raises(NotImplementedError):
        PoseDetector("higherhrnet_w32", device="cpu",
                     compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        PoseDetector("higherhrnet_w32", weights_file="w.npz", device="cpu")
    with pytest.raises(TypeError):
        from tpupose_torch.config import InferenceConfig
        PoseDetector("higherhrnet_w32", cfg=InferenceConfig(img_size=64),
                     device="cpu")


def test_the_detector_path_imports_no_scipy_munkres_or_cv2():
    import subprocess
    import sys

    code = ("import sys, numpy as np, torch; torch.set_num_threads(1); "
            "from tpupose_torch.detectors.pose import PoseDetector; "
            "from tpupose_torch.ops.ae_decode import AEConfig; "
            "d = PoseDetector('higherhrnet_w32', device='cpu', "
            "cfg=AEConfig(input_size=64)); "
            "d(np.zeros((72, 128, 3), np.uint8)); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('scipy', 'munkres', 'cv2', 'jax', 'tpupose')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=registry.checkout_root())
