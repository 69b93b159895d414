#!/usr/bin/env python3
"""blur_nms of one tree of the port, timed on one NVIDIA GPU, for comparing
two trees in one call.

    cd <tree> && python3 <this repository>/scripts/blur_nms_ab.py [label]

Imports ``tpupose_torch`` from the current directory, so the same script
times any tree of the port (a parent unpacked with ``git archive`` beside
this one, say): run it in each tree in turns (parent, change, change,
parent).  Builds that tree's blur_nms kernel, checks it bit-equal to
``blur_nms_reference`` at the two shapes it times, then measures, with the
timers and profiler of this repository's ``chip_smoke.py``:

- the kernel at the fast path's (18, 320, 432) and the precise path's
  (18, 480, 640) maps, from CUDA-graph replays of 20 calls;
- the wrapper's host enqueue time per call at (18, 320, 432): the host
  clock over 1,000 calls with no synchronize between them;
- on seeded, calibrated CocoPoseNet weights (as ``chip_smoke.py``) and a
  seeded 480x640 frame: the kernel's device time inside one fast-path
  postprocess (``torch.profiler``, mean of 3), fast f32 ``__call__`` (host
  clock, median of 7) and precise f32 ``__call__`` (4 scales; median of 3).

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
        "_blur_nms_ab_chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("blur_nms_ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import dataclasses

    from tpupose_torch.config import INFERENCE
    from tpupose_torch.detectors.pose import PoseDetector
    from tpupose_torch.ops import blur_nms as bn
    from tpupose_torch.ops.postprocess import postprocess_pose
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
    sigma, thresh = cfg.gaussian_sigma, cfg.heatmap_peak_thresh
    out = {"tree": label}

    rng = np.random.RandomState(0)
    for shape in ((18, 320, 432), (18, 480, 640)):
        x = torch.from_numpy(smoke._planted(rng, *shape)).cuda()
        (s, m), (rs, rm) = (bn.blur_nms(x, sigma, thresh),
                            bn.blur_nms_reference(x, sigma, thresh))
        if not (torch.equal(s, rs) and torch.equal(m, rm)):
            raise AssertionError(f"blur_nms disagrees at {shape}")
        key = "x".join(map(str, shape))
        out[f"graph_ms_{key}"] = smoke._graph_ms(
            lambda: bn.blur_nms(x, sigma, thresh), 20)
        if shape == (18, 320, 432):
            out["enqueue_ms"] = smoke._enqueue_ms(
                lambda: bn.blur_nms(x, sigma, thresh), 1000)

    frames = np.random.RandomState(0).randint(
        0, 256, (3, 480, 640, 3)).astype(np.uint8)
    det = PoseDetector(cfg=cfg, device="cuda", seed=0)
    if not calibrate_output_convs(det, frames[0]):
        raise AssertionError("calibration found no output convs")
    (paf, hm), _ = det.compute_maps(frames[0])
    with torch.no_grad():
        ops = smoke._profile_forward(
            lambda _: postprocess_pose(paf, hm, paf.shape[-1], cfg), None)
    out["in_postprocess_ms"] = smoke._kernel_ms(ops, "blur_nms_kernel")
    out["fast_call_ms"] = smoke._host_ms(lambda: det(frames[0]), 7)

    precise = PoseDetector(cfg=cfg, device="cuda", seed=0, precise=True)
    precise.model.load_state_dict(det.model.state_dict())
    if not calibrate_output_convs(precise, frames[0]):
        raise AssertionError("calibration found no output convs")
    out["precise_call_ms"] = smoke._host_ms(lambda: precise(frames[0]), 3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
