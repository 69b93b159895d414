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
