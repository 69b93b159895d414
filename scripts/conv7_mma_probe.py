#!/usr/bin/env python3
"""Where the time of the port's conv7 kernel goes, on one NVIDIA GPU.

    python3 scripts/conv7_mma_probe.py      # from the repository root

Builds ``tpupose_torch/csrc/conv7_s8.cu`` as it is and two knock-out
variants of it, each its own library under ``tpupose_torch/_build/``:

- ``base``: the kernel as it is;
- ``mma_ldsm``: no weight streaming and no barrier per step (only the
  prologue's loads): the ldmatrix loads and the MMAs;
- ``mma_only``: as ``mma_ldsm``, and the ldmatrix loads inside a tap taken
  out too: the MMAs alone, on fragments already in registers.

The variants compute garbage; they only time.  Each is timed with the
wrapper ``tpupose_torch.ops.conv7.conv7_s8`` at 128 -> 128 on (B, H, W)
grids from CUDA-graph replays (``chip_smoke._graph_ms``), at each block tile
of the kernel.  Prints, per grid and tile, each variant's microseconds and
its rate in T MAC/s (the layer's 49 x 128 x 128 multiply-adds per output
pixel), and the card's name and power limit first.  ``mma_only`` is the
rate ``mma.sync`` alone reaches in this kernel's shape.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# Text of csrc/conv7_s8.cu that the variants take out.
_STREAM = ("        load_step(step + kStages - 1, (step + kStages - 1) % "
           "kStages);\n")
_BARRIER = ("      cp_async_wait<kStages - 2>();  // step `step` (and the "
            "tile) landed\n      __syncthreads();               // and "
            "every warp is done with step - 1\n")
_LDSM_1 = """        if (kb + 32 < CP)
          load_frags(f1, a_tap + kb + 32, a_row_step, b_tap + kb + 32,
                     b_half_step);
"""
_LDSM_0 = """        if (kb + 64 < CP)
          load_frags(f0, a_tap + kb + 64, a_row_step, b_tap + kb + 64,
                     b_half_step);
"""


def variants(src: str):
    for text in (_STREAM, _BARRIER, _LDSM_1, _LDSM_0):
        if text not in src:
            raise RuntimeError("csrc/conv7_s8.cu changed: update the probe's "
                               "knock-out texts")
    mma_ldsm = src.replace(_STREAM, "        ;\n").replace(_BARRIER, "")
    return {"base": src, "mma_ldsm": mma_ldsm,
            "mma_only": mma_ldsm.replace(_LDSM_1, "        f1 = f0;\n")
            .replace(_LDSM_0, "")}


def build(sources):
    """One nvcc per variant, all started together; returns loaded libs."""
    from tpupose_torch.ops import _cuda_build

    os.makedirs(_cuda_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(_cuda_build.BUILD_DIR, f"conv7_probe_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        procs[name] = (so, subprocess.Popen(
            [_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS, "-o", so, cu]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant")
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv7_s8_launch.argtypes = [
            ctypes.POINTER(p), ctypes.POINTER(p), ctypes.POINTER(p),
            ctypes.POINTER(i), ctypes.POINTER(i), i, p, p, i, i, i, i, i, i,
            p]
        lib.conv7_s8_launch.restype = i
        lib.conv7_s8_error_string.argtypes = [i]
        lib.conv7_s8_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpupose_torch.ops import conv7 as c7

    if not torch.cuda.is_available():
        print("conv7_mma_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    with open(c7._cuda_build.source("conv7_s8")) as f:
        libs = build(variants(f.read()))
    rng = np.random.RandomState(0)
    for bhw in ((1, 23, 31), (1, 46, 62), (1, 92, 123), (4, 92, 123)):
        parts, kernels, mults, bias = cs._conv7_case(rng, *bhw, (128,))
        packed = [c7.pack_conv7_weights(k) for k in kernels]
        mac = bhw[0] * bhw[1] * bhw[2] * 49 * 128 * 128
        for tile, rows in enumerate(c7.TILE_ROWS):
            times = {}
            for name, lib in libs.items():
                c7._library = lambda lib=lib: lib
                times[name] = cs._graph_ms(lambda: c7.conv7_s8(
                    parts, kernels, mults, bias, packed=packed, tile=tile),
                    20)
            print(f"{bhw} 128 -> 128, {rows}-row tile, "
                  f"{c7.blocks(*bhw, 128, tile)} blocks: "
                  + ", ".join(f"{name} {ms * 1e3:.1f} us "
                              f"({mac / (ms * 1e-3) / 1e12:.0f} T MAC/s)"
                              for name, ms in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
