"""OpenPose's BODY_25 on the port (``models/body25.py``, the ``body25``
graph of ``quant.py``, the topology of ``topology.py``) against the plain
reference ``tests/body25_reference.py``, on the CPU at small inputs with
seeded weights and slopes.

- The float32 maps of ``Body25Net`` equal the reference's to 1e-5 of each
  stage's largest value: both run the same float32 convolutions on the
  same concatenations, but oneDNN picks its convolution algorithm and
  blocking by shape and thread count, so the summation order of a channel
  may differ (a few ulps a layer over 114 layers), not the arithmetic.
- The int8 forward on the plain kernels (``conv_s8``'s plain version at
  its groups and PReLU, 108 launches' worth) equals the reference's w8a8
  emulation bit for bit, and equals the im2col route.
- ``PoseDetector(arch="body25")``, f32 and int8, answers the reference
  postprocess's (N, 25, 3) poses on its own maps, exactly.
- The topology: 26 pairs over 25 parts, pair k on PAF channels 2k and
  2k + 1; and COCO's value equals ``config.py``'s globals.
"""

import dataclasses

import numpy as np
import pytest
import torch

import body25_reference as ref
from tpupose_torch import config as tcfg
from tpupose_torch import quant as tq
from tpupose_torch.config import INFERENCE
from tpupose_torch.detectors.pose import PoseDetector
from tpupose_torch.models import ARCHS
from tpupose_torch.models.body25 import Body25Net
from tpupose_torch.ops import conv_s8 as cs
from tpupose_torch.ops.paf import compute_connections
from tpupose_torch.ops.peaks import Peaks
from tpupose_torch.topology import BODY25, COCO18

FRAME_HW = (64, 96)       # the network input too: img_size 64
CFG = dataclasses.replace(INFERENCE, img_size=64, heatmap_size=64,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05,
                          max_subsets=128)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _frames(n, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, *FRAME_HW, 3)).astype(np.uint8)


def _norm(frames):
    return torch.from_numpy(frames).float() / 255.0 - 0.5


@pytest.fixture(scope="module")
def model():
    return Body25Net(seed=7).eval()


def calibrate_heads(det, frame):
    """Calibrate a fast f32 BODY_25 detector in place: the last PAF head
    scaled to unit amplitude, then (the heatmap stages read that PAF) the
    last heatmap head so each part has a few peaks above the threshold."""
    head = {m: list(getattr(det.model, m).children())[-1].conv
            for m in ("stage3_L2", "stage1_L1")}
    with torch.no_grad():
        (paf, _), _ = det.compute_maps(frame)
        gain = 1.0 / paf.abs().amax(dim=(1, 2)).clamp_min(1e-9)
        head["stage3_L2"].weight.mul_(gain[:, None, None, None])
        head["stage3_L2"].bias.mul_(gain)
        (_, hm), _ = det.compute_maps(frame)
        blur = ref.smooth(hm[:-1].numpy(), det.cfg.gaussian_sigma)
        gain = torch.ones(hm.shape[0])
        for j, m in enumerate(blur):
            top = np.sort(m.ravel())[::-1]
            gain[j] = det.cfg.heatmap_peak_thresh * 3.0 / max(float(top[0]),
                                                              1e-12)
        head["stage1_L1"].weight.mul_(gain[:, None, None, None])
        head["stage1_L1"].bias.mul_(gain)


@pytest.fixture(scope="module")
def detector():
    """A calibrated f32 detector (``calibrate_heads``)."""
    det = PoseDetector("body25", device="cpu", cfg=CFG, seed=11)
    calibrate_heads(det, _frames(1, seed=3)[0])
    return det


def test_body25_topology():
    assert BODY25.num_joints == 25 and BODY25.num_limbs == 26
    assert BODY25.paf_channels == 52 and BODY25.heatmap_channels == 26
    assert BODY25.parts[0] == "Nose" and BODY25.parts[24] == "RHeel"
    assert BODY25.limbs == ref.PAIRS
    assert all(0 <= j < 25 for pair in BODY25.limbs for j in pair)
    assert len(set(BODY25.limbs)) == 26
    assert [BODY25.limbs[k] for k in BODY25.non_spawning] == [(2, 17),
                                                               (5, 18)]
    assert BODY25.non_spawning == ref.NON_SPAWNING
    assert Body25Net.topology is BODY25


@pytest.mark.parametrize("pair", [0, 13, 25])
def test_body25_pair_k_reads_paf_channels_2k_and_2k1(pair):
    """One peak per part on a line, and a PAF that is the unit vector
    along pair ``pair`` on channels 2k, 2k + 1 only: that pair alone
    scores a connection."""
    h, w, k = 24, 40, 4
    xs = torch.linspace(4.0, 35.0, 25).round()
    x = torch.zeros(25, k)
    y = torch.full((25, k), 12.0)
    x[:, 0] = xs
    valid = torch.zeros(25, k, dtype=torch.bool)
    valid[:, 0] = True
    peaks = Peaks(x=x, y=y, score=valid.float(), valid=valid,
                  dropped=torch.zeros((), dtype=torch.long))
    pafs = torch.zeros(52, h, w)
    a, b = BODY25.limbs[pair]
    pafs[2 * pair] = 1.0 if xs[b] > xs[a] else -1.0
    cfg = dataclasses.replace(CFG, max_peaks_per_joint=k)
    conns = compute_connections(pafs, peaks, float(w), cfg,
                                BODY25.limbs_from, BODY25.limbs_to)
    found = conns.valid.any(dim=1)
    assert found.tolist() == [p == pair for p in range(26)]


def test_coco_topology_equals_config_globals():
    assert COCO18.num_joints == tcfg.NUM_JOINTS == 18
    assert COCO18.limbs == tuple((int(a), int(b)) for a, b in tcfg.LIMBS)
    assert COCO18.non_spawning == tcfg.NON_SPAWNING_LIMBS
    np.testing.assert_array_equal(COCO18.limbs_from, tcfg.LIMBS_FROM)
    np.testing.assert_array_equal(COCO18.limbs_to, tcfg.LIMBS_TO)
    assert COCO18.limbs_from.dtype == tcfg.LIMBS_FROM.dtype
    assert COCO18.parts == tuple(j.name for j in tcfg.JointType)
    assert ARCHS["posenet"].topology is COCO18
    assert ARCHS["body25"].topology is BODY25


def test_body25_layers_and_slopes(model):
    convs = [n for n, m in model.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == len(ref.layer_table()) == 114
    assert [n.rsplit(".", 1)[0] for n in convs] == [
        f"{module}.{name}" for module, name, *_ in ref.layer_table()]
    assert sum(m.weight.numel() + m.bias.numel() for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)) == 26_152_068
    slopes = torch.cat([m.weight.detach() for m in model.modules()
                        if isinstance(m, torch.nn.PReLU)])
    assert slopes.numel() == 13_504
    assert 0.05 <= float(slopes.min()) and float(slopes.max()) <= 0.45
    assert len(set(slopes.tolist())) > 13_000   # drawn per channel


def test_body25_f32_maps_equal_reference(model):
    x = _norm(_frames(1))
    with torch.no_grad():
        pafs, hms = model(x)
        rp, rh = ref.forward(model.state_dict(), x)
    assert tuple(pafs.shape) == (4, 1, 8, 12, 52)
    assert tuple(hms.shape) == (2, 1, 8, 12, 26)
    for got, want in zip(list(pafs) + list(hms), rp + rh):
        want = want.permute(0, 2, 3, 1)
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_body25_int8_forward_equals_emulation_bit_for_bit(model,
                                                          monkeypatch):
    frames = _frames(2, seed=1)
    x = _norm(frames)
    ranges = tq.calibrate_ranges(model, x)
    qtree, static = tq.quantize("body25", model, ranges)
    assert sum(m.get("act") == "prelu"
               for m in static.layer_meta.values()) == 98
    # per stage 4 later blocks' _0 and Mconv6 read three members; the
    # stage inputs after the first read [feature, PAF(, heatmap)]
    assert sum(len(m["splits"]) > 1
               for m in static.layer_meta.values()) == 6 * 5 + 5
    tree = tq.qtree_to_device(qtree, static, "cpu", "kernel")
    calls = []
    plain = cs.conv_s8_reference

    def counting(parts, *args, **kwargs):
        calls.append(len(cs._as_groups(parts)))
        return plain(parts, *args, **kwargs)

    monkeypatch.setattr(cs, "conv_s8_reference", counting)
    with torch.no_grad():
        got = tq.quant_apply(static, tree, x[:1], "kernel")
        im2col = tq.quant_apply(static, tree, x[:1], "im2col")
    assert len(calls) == 108 and max(calls) == 3
    ref_ranges = ref.calibration_ranges(model.state_dict(), x)
    assert ref_ranges == {k: v for k, v in ranges.items() if k in ref_ranges}
    want = ref.int8_forward(ref.quantize(model.state_dict(), ref_ranges),
                            ref_ranges, x[:1])
    for g, i, w in zip(list(got[0]) + list(got[1]), list(im2col[0])
                       + list(im2col[1]), want[0] + want[1]):
        assert torch.equal(g, i)
        assert torch.equal(g, w.permute(0, 2, 3, 1))
    assert float(got[1][-1].abs().max()) > 0


def test_body25_quant_graph_matches_the_model(model):
    """``quant.py``'s BODY_25 graph describes ``models/body25.py``: its
    stages, their layer names (every conv of the model, in order), the
    dense blocks, the stem's PReLU layers and the spans."""
    from tpupose_torch.models import body25

    graph = tq.ARCH_GRAPHS["body25"]
    assert graph.stages == body25.STAGES
    assert graph.dense_blocks == body25.DENSE_BLOCKS
    assert graph.spans == body25.SPANS
    for module, *_ in graph.stages:
        assert graph.stage_layers(module) == body25.stage_layers(module)
    convs = [n.rsplit(".", 1)[0] for n, m in model.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert convs == [f"stem.{n}" for n, _ in graph.stem] + [
        f"{m}.{layer}" for m, *_ in graph.stages
        for layer in graph.stage_layers(m)]
    assert graph.prelu == tuple(
        n.split(".")[0] for n, m in model.stem.named_modules()
        if isinstance(m, torch.nn.PReLU))


def test_body25_im2col_route_finishes_on_the_requant_epilogue(model,
                                                             monkeypatch):
    """On the im2col route each of BODY_25's 108 non-head layers ends in
    the requantize epilogue that ``csrc/requant.cu`` runs on the card: the
    98 PReLU layers through ``act_epilogue`` with their slopes, the 10
    ReLU stem layers through ``requant_epilogue``; no plain epilogue is
    called from the forward itself."""
    x = _norm(_frames(1, seed=2))
    ranges = tq.calibrate_ranges(model, x)
    qtree, static = tq.quantize("body25", model, ranges)
    tree = tq.qtree_to_device(qtree, static, "cpu")
    seen = []

    def counting(name, fn):
        def wrapped(accs, mults, bias, *args, **kwargs):
            seen.append((name, len(accs), args, kwargs))
            return fn(accs, mults, bias, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(tq, "act_epilogue",
                        counting("act", tq.act_epilogue))
    monkeypatch.setattr(tq, "requant_epilogue",
                        counting("requant", tq.requant_epilogue))
    with torch.no_grad():
        tq.quant_apply(static, tree, x, "im2col")
    prelu = [s for s in seen if s[0] == "act"]
    assert len(seen) == 108 and len(prelu) == 98
    assert all(args[0] == "prelu" and args[1] is not None
               for _, _, args, _ in prelu)
    assert [kwargs for name, _, _, kwargs in seen if name == "requant"] \
        == [{"relu": True, "lo": 0.0}] * 10
    assert max(g for _, g, _, _ in prelu) == 3


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_detector_body25_poses_equal_reference_postprocess(detector,
                                                           precision):
    det = detector
    if precision == "int8":
        det = PoseDetector("body25", device="cpu", cfg=CFG, seed=11)
        det.model.load_state_dict(detector.model.state_dict())
        det.quantize(_frames(2, seed=5))
    found = 0
    for frame in _frames(3, seed=9):
        poses, scores = det(frame)
        (paf, hm), scale = det.compute_maps(frame)
        want, want_scores = ref.poses(paf, hm.numpy(), CFG, scale)
        assert poses.shape[1:] == (25, 3)
        np.testing.assert_array_equal(poses, want)
        np.testing.assert_array_equal(scores, want_scores)
        found += len(poses)
    assert found > 0
