#!/usr/bin/env python3
"""Where a served request's host time goes, on one NVIDIA GPU.

    python3 scripts/serve_probe.py [--iters 10]

From the repository root.  On seeded CocoPoseNet weights (full width and
depth) and a seeded 480x640 frame, for the f32 and the quantized fast
detectors, times ``__call__`` (host clock, median of ``--iters``, in
turns): in the main thread; in a new thread per call (what
``ThreadingHTTPServer`` does for each request); in one long-lived worker
thread; and one request over HTTP to ``apps/serve.py::make_server``.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class _Worker:
    """One long-lived thread that runs the calls handed to it."""

    def __init__(self):
        self.jobs = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            fn, done = self.jobs.get()
            if fn is None:
                return
            done.put(fn())

    def call(self, fn):
        done = queue.Queue()
        self.jobs.put((fn, done))
        return done.get()

    def close(self):
        self.jobs.put((None, None))
        self.thread.join()


def _in_new_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def main() -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("serve_probe: CUDA is not available", file=sys.stderr)
        return 1
    from tpupose_torch.apps.serve import detect_over_http, make_server
    from tpupose_torch.detectors.pose import PoseDetector
    from tpupose_torch.ops import _cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    _cuda_build.build_all(["blur_nms", "conv7_s8", "conv_s8", "requant"])
    frame = np.random.RandomState(0).randint(0, 256, (480, 640, 3)).astype(
        np.uint8)
    out = {"card": smi}
    worker = _Worker()
    for label in ("f32", "int8"):
        det = PoseDetector(device="cuda", seed=0)
        if label == "int8":
            det.quantize([frame, frame[:, ::-1]])
        server = make_server(det, port=0)
        serving = threading.Thread(target=server.serve_forever, daemon=True)
        serving.start()
        url = "http://%s:%d" % server.server_address[:2]
        ways = {
            "main": lambda: det(frame),
            "new_thread": lambda: _in_new_thread(lambda: det(frame)),
            "worker": lambda: worker.call(lambda: det(frame)),
            "http": lambda: detect_over_http(url, frame),
        }
        times = {k: [] for k in ways}
        for fn in ways.values():
            fn()
        for _ in range(args.iters):
            for k, fn in ways.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
        for k, v in times.items():
            out[f"{label}_{k}_ms"] = statistics.median(v)
        server.shutdown()
        server.server_close()
        serving.join()
    worker.close()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
