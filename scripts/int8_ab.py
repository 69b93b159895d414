#!/usr/bin/env python3
"""The int8 paths of one tree of the port, timed on one NVIDIA GPU, for
comparing two trees in one call.

    cd <tree> && python3 <this repository>/scripts/int8_ab.py [label]

Imports ``tpupose_torch`` from the current directory, so the same script
times any tree whose ``PoseDetector`` has ``quantize()`` (a parent unpacked
with ``git archive`` beside this one, say): run it in each tree in turns
(parent, change, change, parent).  Builds that tree's kernels, then on
seeded, calibrated CocoPoseNet weights (as ``chip_smoke.py``) and seeded
480x640 frames measures:

- the int8 forward at 368x496 (CUDA events, mean of 10), its kernels'
  device time and launches per forward and its ten costliest device
  operations by name (``torch.profiler``, mean of 3 forwards), with the
  timers and profiler of this repository's ``chip_smoke.py``;
- fast int8 ``__call__`` (host clock, median of 7) and its peak device
  memory;
- precise int8 ``__call__`` (4 scales; host clock, median of 5) and its
  peak device memory.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This repository's ``chip_smoke.py`` (its timers and profiler), by
    path: the current directory may hold another tree's."""
    spec = importlib.util.spec_from_file_location(
        "_int8_ab_chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("int8_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import dataclasses

    from tpupose_torch.config import INFERENCE
    from tpupose_torch.detectors.net import float32_numerics
    from tpupose_torch.detectors.pose import PoseDetector, fast_geometry
    from tpupose_torch.ops.resize import resize_u8_linear
    from tpupose_torch.utils.calibrate import calibrate_output_convs

    smoke = _smoke()
    label = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(
        os.getcwd())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    cfg = dataclasses.replace(INFERENCE, max_subsets=128,
                              n_subset_limbs_thresh=2,
                              subset_score_thresh=0.05)
    frames = np.random.RandomState(0).randint(
        0, 256, (3, 480, 640, 3)).astype(np.uint8)
    out = {"tree": label}

    f32 = PoseDetector(cfg=cfg, device="cuda", seed=0)
    if not calibrate_output_convs(f32, frames[0]):
        raise AssertionError("calibration found no output convs")
    det = PoseDetector(cfg=cfg, device="cuda", seed=0)
    det.model.load_state_dict(f32.model.state_dict())
    det.quantize([frames[0], frames[0][:, ::-1]])
    (in_h, in_w), _ = fast_geometry(det.cfg, *frames.shape[1:3])
    x = torch.from_numpy(resize_u8_linear(frames[0], (in_w, in_h))[
        None]).cuda().float() / 255.0 - 0.5
    with torch.no_grad(), float32_numerics():
        out["int8_forward_ms"] = smoke._cuda_ms(
            lambda: det.net.quant_forward(x), 10)
    torch.cuda.reset_peak_memory_stats()
    out["fast_int8_call_ms"] = smoke._host_ms(lambda: det(frames[0]), 7)
    out["fast_int8_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20

    precise = PoseDetector(cfg=cfg, device="cuda", seed=0, precise=True)
    precise.model.load_state_dict(f32.model.state_dict())
    if not calibrate_output_convs(precise, frames[0]):
        raise AssertionError("calibration found no output convs")
    precise.quantize([frames[0], frames[0][:, ::-1]])
    torch.cuda.reset_peak_memory_stats()
    out["precise_int8_call_ms"] = smoke._host_ms(lambda: precise(frames[0]),
                                                 5)
    out["precise_int8_peak_mib"] = (torch.cuda.max_memory_allocated()
                                    / 2**20)

    # The profiler last: it may leave per-launch cost behind.
    with torch.no_grad(), float32_numerics():
        ops = smoke._profile_forward(det.net.quant_forward, x)
    out.update(
        int8_forward_device_ms=sum(ms for ms, _ in ops.values()),
        int8_forward_kernel_launches=sum(n for _, n in ops.values()),
        int8_forward_top=[(name[:90], ms, n)
                          for name, (ms, n) in list(ops.items())[:10]])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
