#!/usr/bin/env python3
"""The pose postprocess of one tree of the port, timed end to end on one
NVIDIA GPU, for comparing two trees in one call.

    cd <tree> && python3 <this repository>/scripts/postprocess_ab.py [label]

Imports ``tpupose_torch`` from the current directory, so the same script
times any tree of the port (a parent unpacked with ``git archive`` beside
this one, say): run it in each tree in turns (parent, change, change,
parent).  On seeded, calibrated CocoPoseNet weights (as ``chip_smoke.py``:
368 input, 320x432 maps, the relaxed subset filter) and seeded 480x640
frames, with the timers and profiler of this repository's
``chip_smoke.py``, it measures:

- the postprocess of one frame's maps: host ms ending in a synchronize
  (median of 7), and its device time and launches (``torch.profiler``,
  mean of 3);
- the greedy_match and group_fold kernels alone, from CUDA-graph replays
  of 20 calls (``chip_smoke.py::_graph_ms``, each input timed twice, in
  turns): at one frame's tables (phase 3 of ``chip_smoke.py``) and on the
  crowd of ``tests/postprocess_cases.py`` at B = 1 and 8 (full K = 32
  limbs for the matcher, 32 people on every limb for the fold);
- fast f32 ``__call__`` (host clock, median of 7) and ``detect_batch`` of
  3 frames per frame (median of 3);
- 8 frames through ``submit`` / ``collect`` kept 0 and 2 frames ahead
  (``apps/evaluate.py``'s ``pipeline_depth``), ms per frame (median of
  3);
- fast bf16 and fast int8 ``__call__`` (median of 7).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This repository's ``chip_smoke.py`` (its timers and profiler), by
    path: the current directory may hold another tree's."""
    spec = importlib.util.spec_from_file_location(
        "_postprocess_ab_chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pipelined_ms(det, frames, depth, reps=3):
    """ms per frame of ``frames`` through ``submit`` / ``collect`` with
    ``depth`` frames in flight (median of ``reps``)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pending = []
        for f in frames:
            pending.append(det.submit(f))
            if len(pending) > depth:
                det.collect(pending.pop(0))
        while pending:
            det.collect(pending.pop(0))
        times.append((time.perf_counter() - t0) * 1e3 / len(frames))
    return statistics.median(times)


def _kernel_ms(smoke, det, cfg, frames):
    """The two postprocess kernels alone, ms per call from CUDA-graph
    replays, on one frame's tables and on the crowd (B = 1 and 8)."""
    import numpy as np
    import torch

    from tpupose_torch.config import LIMBS_FROM, LIMBS_TO, NUM_LIMBS
    from tpupose_torch.ops import greedy_match as gm
    from tpupose_torch.ops import group_fold as gf
    from tpupose_torch.ops import paf
    from tpupose_torch.ops.peaks import find_peaks

    cases = smoke._cases()
    thresh = (cfg.max_subsets, cfg.n_subset_limbs_thresh,
              cfg.subset_score_thresh)
    with torch.no_grad():
        (paf_b, hm_b), _ = det._run(frames[:1], False, postprocess=False)
        rows = paf_b.reshape(1, NUM_LIMBS, 2, -1).transpose(-1, -2)
        peaks = find_peaks(hm_b[:, :-1], cfg.gaussian_sigma,
                           cfg.heatmap_peak_thresh, cfg.max_peaks_per_joint)
        m_args = paf.limb_candidates(rows, tuple(paf_b.shape[-2:]), peaks,
                                     float(paf_b.shape[-1]), cfg,
                                     LIMBS_FROM, LIMBS_TO)
    inputs = {"phase3": (m_args, (*gm.greedy_match(*m_args), peaks.score))}
    for b in (1, 8):
        inputs[f"crowd{b}"] = (
            [torch.from_numpy(x).cuda() for x in cases.match_tables(
                np.random.RandomState(6), "full_limb", (b, NUM_LIMBS), 32)],
            [torch.from_numpy(x).cuda() for x in cases.crowd_tables(
                np.random.RandomState(8), (b,))])
    fns = {}
    for name, (m, f) in inputs.items():
        fns[f"greedy_match_{name}_ms"] = (
            lambda m=m: gm.greedy_match(*m))
        fns[f"group_fold_{name}_ms"] = (
            lambda f=f: gf.group_fold(*f, *thresh))
    return smoke._round_robin_ms(fns, 20, smoke._graph_ms)


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("postprocess_ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from tpupose_torch.config import INFERENCE
    from tpupose_torch.detectors.pose import PoseDetector
    from tpupose_torch.ops.postprocess import postprocess_pose
    from tpupose_torch.utils.calibrate import calibrate_output_convs

    smoke = _smoke()
    label = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(
        os.getcwd())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    cfg = dataclasses.replace(INFERENCE, max_subsets=128,
                              n_subset_limbs_thresh=2,
                              subset_score_thresh=0.05)
    frames = np.random.RandomState(0).randint(
        0, 256, (8, 480, 640, 3)).astype(np.uint8)
    det = PoseDetector(cfg=cfg, device="cuda", seed=0)
    if not calibrate_output_convs(det, frames[0]):
        raise AssertionError("calibration found no output convs")
    det(frames[0])
    out = {"label": label, "poses": len(det(frames[0])[0])}

    (paf, hm), _ = det.compute_maps(frames[0])
    with torch.no_grad():
        def post(_=None):
            return postprocess_pose(paf, hm, paf.shape[-1], cfg)

        out["postprocess_ms"] = smoke._host_ms(post, 7)
        ops = smoke._profile_forward(post, None)
    out["postprocess_device_ms"] = sum(v[0] for v in ops.values())
    out["postprocess_launches"] = sum(v[1] for v in ops.values())
    out.update(_kernel_ms(smoke, det, cfg, frames))
    out["fast_call_ms"] = smoke._host_ms(lambda: det(frames[0]), 7)
    out["detect_batch3_per_frame_ms"] = smoke._host_ms(
        lambda: det.detect_batch(frames[:3]), 3) / 3
    for depth in (0, 2):
        out[f"pipelined_depth{depth}_ms"] = _pipelined_ms(det, frames, depth)

    bf16 = PoseDetector(cfg=cfg, device="cuda", compute_dtype=torch.bfloat16)
    bf16.model.load_state_dict(det.model.state_dict())
    bf16(frames[0])
    out["bf16_call_ms"] = smoke._host_ms(lambda: bf16(frames[0]), 7)
    del bf16
    det.quantize([frames[0], frames[0][:, ::-1]])
    det(frames[0])
    out["int8_call_ms"] = smoke._host_ms(lambda: det(frames[0]), 7)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
