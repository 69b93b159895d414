"""The BODY_25 cell (``body25.live720_int8``) at a small size on the CPU:
its run through ``run.measure`` is correct, a broken pose is not, its
int4 control reads not correct, the reference's forwards equal the
port's, and its hand counts of work match the published net."""

import numpy as np
import torch

from posebench.control import readings
from posebench.core import registry
from posebench.core.cell import Cell
from posebench.reference import body25
from posebench.tests import tiny

NAME = "body25.live720_int8"


def _cell(seed: int = tiny.SEED) -> Cell:
    bench = registry.benchmark(registry.checkout_root())
    w = registry.workload(bench, NAME)
    cfg, traffic = registry.config(w["config"]), registry.traffic(
        w["traffic"])
    cfg.update(img_size=64, heatmap_size=56)
    traffic.update(frames=3, frame_hw=[72, 128], warmup=1, trace_requests=2)
    return Cell(name=NAME, config=cfg, traffic=traffic, seed=seed,
                device="cpu")


def test_hand_counts_of_the_published_net():
    cfg = registry.config("body25")
    assert len(body25.layer_table(cfg)) == 114
    assert len(body25.int8_layers(cfg, (368, 656))) == 108
    assert sum(layer.act == "prelu"
               for layer in body25.layer_table(cfg)) == 98
    assert body25.param_count(cfg) == (26_152_068, 13_504)   # 26.15 M
    assert body25.forward_macs(cfg, (368, 656)) == 143_630_517_760
    assert round(body25.forward_macs(cfg, (368, 496)) / 1e9, 2) == 108.60
    assert body25.forward_ops(cfg, (368, 656)) == 2 * 143_630_517_760
    # the bound of the int8 layers: operations bound at 46x82, so about
    # 2 x 143.2 G operations at 1,979 TOP/s
    least = body25.conv_s8_forward_bound_s(cfg, (368, 656))
    assert 0.1448e-3 < least < 0.16e-3


def test_forwards_equal_the_port():
    from tpupose_torch import quant as pq
    from tpupose_torch.models import ARCHS

    torch.set_num_threads(2)
    cfg = registry.config("body25")
    params = body25.seeded_params(cfg, tiny.SEED, "cpu")
    model = ARCHS["body25"]().eval()
    model.load_state_dict(params)
    rng = np.random.RandomState(0)
    calib = rng.randint(0, 256, (2, 48, 48, 3)).astype(np.uint8)
    frame = rng.randint(0, 256, (1, 48, 64, 3)).astype(np.uint8)
    x = torch.from_numpy(frame).float() / 255.0 - 0.5
    with torch.no_grad():
        ours = body25.forward(cfg, params, x)
        theirs = model(x)
        ranges = pq.calibrate_ranges(model, torch.from_numpy(calib).float()
                                     / 255.0 - 0.5)
    for o, t in zip(ours, (theirs[0][-1], theirs[1][-1])):
        o = o.permute(0, 2, 3, 1)
        assert float((o - t).abs().max()) <= 1e-5 * float(o.abs().max())
    qtree, static = pq.quantize("body25", model, ranges)
    q_theirs = pq.quant_apply(static, pq.qtree_to_device(qtree, static,
                                                         "cpu"), x, "im2col")
    q_ours = body25.int8_forward(cfg, body25.build(cfg, params, calib,
                                                   "cpu"),
                                 torch.from_numpy(frame))
    for o, t in zip(q_ours, (q_theirs[0][-1], q_theirs[1][-1])):
        assert torch.equal(o.permute(0, 2, 3, 1), t)


def test_the_cell_runs_correct_on_the_cpu():
    result = tiny.measure(_cell(), trace_on=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert result["checks"]["persons_unmatched"]["value"] == 0
    assert result["diagnostics"]["reference_persons"] > 0
    assert result["diagnostics"]["most_peaks_per_joint"] < 32
    # no device trace on the CPU: the device metrics find nothing
    assert "body25_conv_s8_roofline" not in result["metrics"]


def test_a_moved_pose_is_not_correct(monkeypatch):
    import tpupose_torch.detectors.pose as pose

    emit = pose.emit_result

    def shifted(*args, **kwargs):
        poses, scores, warned = emit(*args, **kwargs)
        poses = poses.copy()
        poses[..., 0] = np.where(poses[..., 2] > 0, poses[..., 0] + 5.0, 0.0)
        return poses, scores, warned

    monkeypatch.setattr(pose, "emit_result", shifted)
    result = tiny.measure(_cell())
    assert not result["correct"]
    assert result["checks"]["persons_unmatched"]["value"] > 0


def test_the_int4_control_is_not_correct():
    torch.set_num_threads(2)
    cell = _cell()
    ours, control = readings(cell, 0.5)
    limits = cell.traffic["limits"]
    assert all(ours[n] <= limit for n, limit in limits.items()), ours
    assert any(control[n] > limit for n, limit in limits.items()), control
