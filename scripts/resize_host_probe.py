#!/usr/bin/env python3
"""The host's uint8 bilinear resize alone: the compiled
``ops/resize.py::resize_u8_linear`` (``native/resize_u8_host.cpp``) against
its numpy plain version, at the pose cells' frame shapes.

    python3 scripts/resize_host_probe.py [--repeats 200]  # from the repo root

Checks both give the same bytes on seeded noise frames, then times each in
turns (compiled, plain, plain, compiled, ...) on one thread, the compiled
one writing into a preallocated ``out=`` as the pose detector does.  Prints
the host's CPU model and one JSON line of per-shape medians and minima, ms.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpupose_torch.ops import resize as rs  # noqa: E402

SHAPES = [((480, 640), (496, 368)),     # posenet.live_*: 480p to 368x496
          ((720, 1280), (656, 368)),    # body25.live720_int8
          ((100, 157), (368, 368))]     # a hand crop


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _time(fn, repeats):
    ts = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e3)
    return ts


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=200)
    args = ap.parse_args()
    rng = np.random.RandomState(20)
    result = {"cpu": _cpu_model(), "cores": os.cpu_count(), "shapes": {}}
    for (in_h, in_w), (w, h) in SHAPES:
        img = rng.randint(0, 256, (in_h, in_w, 3)).astype(np.uint8)
        out = np.empty((h, w, 3), np.uint8)
        plain = rs.resize_u8_linear_plain(img, (w, h))
        if not np.array_equal(rs.resize_u8_linear(img, (w, h), out=out),
                              plain):
            raise SystemExit(f"compiled != plain at {img.shape} -> {(h, w)}")
        compiled_ms, plain_ms = [], []
        for i in range(4):
            compiled_ms += _time(lambda: rs.resize_u8_linear(
                img, (w, h), out=out), args.repeats // 2)
            plain_ms += _time(lambda: rs.resize_u8_linear_plain(img, (w, h)),
                              max(args.repeats // 20, 2))
        key = f"{in_h}x{in_w}->{h}x{w}"
        result["shapes"][key] = {
            "compiled_median_ms": statistics.median(compiled_ms),
            "compiled_min_ms": min(compiled_ms),
            "plain_median_ms": statistics.median(plain_ms),
            "plain_min_ms": min(plain_ms)}
        print(key, result["shapes"][key], flush=True)
    print(result["cpu"], result["cores"], "cores")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
