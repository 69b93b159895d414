#!/usr/bin/env python3
"""A serving bundle's ``__call__`` against the live detector's, on one
NVIDIA GPU.

    python3 scripts/bundle_ab.py [--iters 15] [--profile 5]

From the repository root.  Builds the port's kernels, then on seeded
CocoPoseNet weights (full width and depth, 368 input / 320 maps) and a
seeded 480x640 frame, for the f32 and the quantized (kernel route) fast
detectors: exports a CUDA bundle of the frame's size (``serving.
save_bundle``), loads it (``ServingPoseDetector``), checks its table equals
the live one, and times live ``__call__`` and the bundle's in turns (host
clock, median of ``--iters`` each).  Then profiles ``--profile`` calls of
each bundle with ``cProfile`` and prints the 15 functions with the most
own time, to show where a bundle's host time goes.  Prints the card's name
and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=15)
    p.add_argument("--profile", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bundle_ab: CUDA is not available", file=sys.stderr)
        return 1
    from tpupose_torch.detectors.pose import PoseDetector
    from tpupose_torch.ops import _cuda_build
    from tpupose_torch.serving import ServingPoseDetector, save_bundle

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    _cuda_build.build_all(["blur_nms", "conv7_s8", "conv_s8", "requant"])
    frame = np.random.RandomState(0).randint(0, 256, (480, 640, 3)).astype(
        np.uint8)
    out = {"card": smi}
    os.makedirs(_cuda_build.BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="bundle-ab-", dir=_cuda_build.BUILD_DIR)
    try:
        for label in ("f32", "int8"):
            det = PoseDetector(device="cuda", seed=0)
            if label == "int8":
                det.quantize([frame, frame[:, ::-1]])
            path = os.path.join(root, label)
            t0 = time.perf_counter()
            save_bundle(det, path, [frame.shape[:2]], platforms=("cuda",))
            t1 = time.perf_counter()
            srv = ServingPoseDetector(path)
            out[f"{label}_export_s"] = t1 - t0
            out[f"{label}_load_s"] = time.perf_counter() - t1
            live, got = det(frame), srv(frame)
            if not all(np.array_equal(a, b) for a, b in zip(live, got)):
                raise AssertionError(f"{label}: bundle table != live")
            times = {"live": [], "bundle": []}
            for _ in range(args.iters):
                times["live"].append(_ms(lambda: det(frame)))
                times["bundle"].append(_ms(lambda: srv(frame)))
            for k, v in times.items():
                out[f"{label}_{k}_call_ms"] = statistics.median(v)
            prof = cProfile.Profile()
            prof.enable()
            for _ in range(args.profile):
                srv(frame)
            torch.cuda.synchronize()
            prof.disable()
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(
                15)
            print(f"--- {label} bundle, cProfile of {args.profile} calls "
                  f"(own time) ---")
            print("\n".join(buf.getvalue().splitlines()[4:30]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
