#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone: the (data, spatial) mesh and the
camera loops, without phases 1-11.

    python3 scripts/parallel_probe.py          # one card: phase 12 (a)-(e)
    python3 scripts/parallel_probe.py --nccl   # every card a rank: (b) over
                                               # NCCL on 2 cards, (d) on 4

Builds the four kernels first (the spawned ranks load them), then runs
``chip_smoke.run_parallel`` or, with ``--nccl``, its rank groups over NCCL
with one card a rank (``chip_smoke._p12_group``), and prints each check
and number beside the card's name and power limit.  Exits non-zero if a
check fails.  The spawned ranks re-import this script, so its work stays
under ``if __name__ == "__main__":``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    from tpupose_torch.config import INFERENCE
    from tpupose_torch.ops import _cuda_build

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nccl", action="store_true",
                   help="the rank groups over NCCL, one card a rank")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("parallel_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _cuda_build.build_all(["blur_nms", "conv7_s8", "conv_s8", "requant"])
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    cfg = dataclasses.replace(INFERENCE, max_subsets=128,
                              n_subset_limbs_thresh=2,
                              subset_score_thresh=0.05)
    if not args.nccl:
        chip_smoke.run_parallel(cfg, smi.splitlines()[0])
        return 0
    cards = torch.cuda.device_count()
    for world in (2, 4):
        if world > cards:
            print(f"{world} NCCL ranks need {world} cards; {cards} here")
            continue
        records = chip_smoke._p12_group(world, "nccl", cfg)
        if world == 2 and len({r["numbers"]["b_digest"]
                               for r in records}) != 1:
            raise AssertionError("(b) over NCCL: parameters differ across "
                                 "ranks")
        numbers = {k: v for k, v in records[0]["numbers"].items()
                   if k != "b_digest"}
        print(f"{world} NCCL ranks ({smi.splitlines()[0]}, one card a "
              f"rank; 3 steps, not a DP speed claim): "
              + json.dumps(numbers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
