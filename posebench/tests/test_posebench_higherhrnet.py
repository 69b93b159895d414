"""The HigherHRNet-W32 cell (``higherhrnet_w32.live720_f32``) at a small
size on the CPU: its run through ``run.measure`` is correct and reads its
decode counters, a planted fault in the flip test or the grouping is not
correct, its hand counts of work match the published net, and (on the
card) its TF32 control reads not correct."""

import pytest
import torch

from posebench.control import readings
from posebench.core import registry
from posebench.core.cell import Cell
from posebench.reference import higherhrnet
from posebench.tests import tiny

NAME = "higherhrnet_w32.live720_f32"


def _cell(seed: int = tiny.SEED, device: str = "cpu") -> Cell:
    bench = registry.benchmark(registry.checkout_root())
    w = registry.workload(bench, NAME)
    cfg, traffic = registry.config(w["config"]), registry.traffic(
        w["traffic"])
    cfg.update(input_size=64)
    traffic.update(frames=3, frame_hw=[72, 128], warmup=1, trace_requests=2)
    return Cell(name=NAME, config=cfg, traffic=traffic, seed=seed,
                device=device)


def test_hand_counts_of_the_published_net():
    cfg = registry.config("higherhrnet_w32")
    assert len(higherhrnet.convs(cfg)) == 303
    assert higherhrnet.param_count(cfg) == 28_645_331     # 28.6 M
    # 47.6 G multiply-adds at 512x512 (the paper's Table 2: 47.9 GFLOPs)
    assert higherhrnet.forward_macs(cfg, (512, 512)) == 47_568_650_240
    # a 720p frame: 512x960, both passes of the flip test
    assert higherhrnet.forward_macs(cfg, (512, 960), 2) == 178_382_438_400
    assert higherhrnet.forward_ops(cfg, (512, 960), 2) == 2 * 178_382_438_400
    g = higherhrnet.geometry(cfg, (720, 1280))
    assert (g.in_hw, g.res_hw, g.offset) == ((512, 960), (512, 910), (0, 25))


def test_the_cell_runs_correct_on_the_cpu():
    result = tiny.measure(_cell(), trace_on=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert result["checks"]["persons_unmatched"]["value"] == 0
    d = result["diagnostics"]
    assert d["reference_persons"] > 0
    work = d["ae_decode_per_request"]
    assert all(work[k] > 0 for k in ("candidates", "persons", "refined",
                                     "refilled"))
    assert work["refine_groups"] == 0              # the kernel is the card's
    # host spans are read on the CPU; no device trace there
    for name in ("ae_match_ms", "resize_ms", "upload_ms",
                 "forward_enqueue_ms", "postprocess_enqueue_ms", "fetch_ms",
                 "higherhrnet_mfu_pct", "traced_frame_ms"):
        assert result["metrics"][name]["value"] > 0, name
    for name in ("hr_stem_ms", "hr_stages_ms", "hr_head_ms", "ae_decode_ms",
                 "ae_refine_roofline"):
        assert name not in result["metrics"]


def _wrong_flip(monkeypatch):
    from tpupose_torch.ops import ae_decode

    aggregate = ae_decode.aggregate
    monkeypatch.setattr(ae_decode, "aggregate",
                        lambda o0, o1, flip, hw: aggregate(
                            o0, o1, list(range(len(flip))), hw))


def _tag_threshold_off_by_one(monkeypatch):
    from tpupose_torch.ops import ae_decode

    monkeypatch.setattr(ae_decode, "TAG_THRESHOLD",
                        ae_decode.TAG_THRESHOLD + 1)


@pytest.mark.parametrize("fault", [_wrong_flip, _tag_threshold_off_by_one])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = tiny.measure(_cell())
    assert not result["correct"]
    assert result["checks"]["persons_unmatched"]["value"] > 0


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct_on_the_card():
    """TF32 convolutions and matmuls in the reference's forward fail a
    limit, where the program reads within them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    cell = _cell(device="cuda")
    cell.config.update(input_size=256)
    cell.traffic.update(frame_hw=[288, 512])
    ours, control = readings(cell, 1.0)
    limits = cell.traffic["limits"]
    assert all(ours[n] <= limit for n, limit in limits.items()), ours
    assert any(control[n] > limit for n, limit in limits.items()), control
