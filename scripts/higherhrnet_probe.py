#!/usr/bin/env python3
"""Phase 8c of ``chip_smoke.py`` alone, on one NVIDIA GPU: the refine
kernel against its plain version at the cell's 17x512x960 maps, with its
times and bound; then HigherHRNet-W32 on three seeded 720x1280 frames
with the benchmark's calibrated weights, ``submit`` free of host syncs,
its poses and scores against the benchmark's reference bit for bit, the
decode's counters, and the card's time a frame split by span
(``hr.stem``, ``hr.stages``, ``hr.head``, ``ae.topk``, ``ae.refine``).

    python3 scripts/higherhrnet_probe.py       # from the repository root

Prints each check and number beside the card's name and power limit;
exits non-zero if a check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("higherhrnet_probe: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    record = chip_smoke.check_ae_refine()
    chip_smoke.run_higherhrnet(smi)
    print(f"higherhrnet phase {time.perf_counter() - t0:.2f} s")
    err, ms, plain_ms, (bound_ms, bound_by) = record
    print(json.dumps({"kernels": [{
        "name": "refine_argmax", "route": "cuda",
        "source": "tpupose_torch/csrc/ae_refine.cu",
        "launches": chip_smoke._read_counts()["refine_argmax"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]}))
    print('{"ok": true}')
    return 0


if __name__ == "__main__":
    sys.exit(main())
