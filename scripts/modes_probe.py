#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone, on one NVIDIA GPU: the detectors'
bf16, conv-NMS and host-pyramid modes, ``evaluate_detector`` and the
profiling layer, without phases 1-10.

    python3 scripts/modes_probe.py        # from the repository root

Builds the four kernels, makes the calibrated 6-stage detector of phase 3
and its ``quantize()``d twin of phase 5 on the same seeded 480x640 frames,
and runs ``chip_smoke.run_modes`` on them, which prints each check and
number beside the card's name and power limit.  Exits non-zero if a check
fails.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from tpupose_torch.config import INFERENCE
    from tpupose_torch.detectors.pose import PoseDetector
    from tpupose_torch.ops import _cuda_build
    from tpupose_torch.utils.calibrate import calibrate_output_convs

    if not torch.cuda.is_available():
        print("modes_probe: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    _cuda_build.build_all(["blur_nms", "conv7_s8", "conv_s8", "requant"])
    cfg = dataclasses.replace(INFERENCE, max_subsets=128,
                              n_subset_limbs_thresh=2,
                              subset_score_thresh=0.05)
    frames = np.random.RandomState(0).randint(
        0, 256, (3, 480, 640, 3)).astype(np.uint8)
    det = PoseDetector(cfg=cfg, device="cuda", seed=0)
    if not calibrate_output_convs(det, frames[0]):
        raise AssertionError("calibration found no output convs")
    qdet = PoseDetector(cfg=cfg, device="cuda", seed=0)
    qdet.model.load_state_dict(det.model.state_dict())
    qdet.quantize([frames[0], frames[0][:, ::-1]])
    det(frames[0])
    qdet(frames[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chip_smoke.run_modes(det, qdet, cfg, frames, smi)
    print(f"phase 11 alone: {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
