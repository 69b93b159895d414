#!/usr/bin/env python3
"""Phase 8b of ``chip_smoke.py`` alone, on one NVIDIA GPU: BODY_25 on two
720x1280 frames, f32 and int8, its launch counts, its int8 maps against
the CPU's, the im2col route on the card (``requant.cu`` with PReLU)
equal to the kernel route, every kernel bit-equal at every shape the
paths gave it, and each distinct 46x82 ``conv_s8`` layer timed at every
tile it takes, three beside the plain route and ``_int_mm``.

    python3 scripts/body25_probe.py       # from the repository root

Prints each check and number beside the card's name and power limit;
exits non-zero if a check fails.
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
    from tpupose_torch.ops import _cuda_build

    if not torch.cuda.is_available():
        print("body25_probe: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    _cuda_build.build_all(["blur_nms", "conv7_s8", "conv_s8", "requant",
                           "greedy_match", "group_fold"])
    print(f"built in {time.perf_counter() - t0:.2f} s")
    cfg = dataclasses.replace(INFERENCE, max_subsets=128,
                              n_subset_limbs_thresh=2,
                              subset_score_thresh=0.05)
    frames = np.random.RandomState(25).randint(
        0, 256, (2, 720, 1280, 3)).astype(np.uint8)
    t0 = time.perf_counter()
    chip_smoke.run_body25(cfg, frames)
    print(f"body25 phase {time.perf_counter() - t0:.2f} s")
    print('{"ok": true}')
    return 0


if __name__ == "__main__":
    sys.exit(main())
