#!/usr/bin/env python3
"""Where blur_nms's time goes on one NVIDIA GPU: the kernel of
``tpupose_torch/csrc/blur_nms.cu`` beside copies of it with phases knocked
out or another chunk size.

    python3 scripts/blur_nms_probe.py        # from the repository root

Builds, for sigma 2.5's radius only, the kernel as it is and these
variants of its source (one ``nvcc`` each, in parallel, into
``tpupose_torch/_build/blur_nms_probe/``):

- ``h_only``: the H pass alone (no W pass, no NMS, nothing stored);
- ``h_w``: the H and W passes (no NMS, nothing stored);
- ``w_nms``: the W pass and the NMS on whatever the H buffer holds;
- ``nms_only``: the NMS alone, which stores every output;
- ``chunk_10`` and ``chunk_15``: the whole kernel with 10- or 15-row chunks.

The kernel and the chunk variants are checked bit-equal to
``blur_nms_reference`` at the fast path's (18, 320, 432) and the precise
path's (18, 480, 640) maps; the knock-outs compute nothing meaningful and
are timed only.  All are timed there from CUDA-graph replays of 20 launches
in turns (``chip_smoke.py``'s timers).  Prints each variant's registers,
spills and SASS instruction count by opcode, the card, and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Source text each knock-out removes from the chunk of csrc/blur_nms.cu.
_H = ("    h_rows<R, C == 0 ? 0 : y_begin + 2 * R, y_end + 2 * R, y_begin>(\n"
      "        b, taps, v, acc);")
_W = "  w_rows<R>(b, taps, y_begin, y_end);"
_NMS = ("  nms_rows<R>(b, thresh, y_begin < 2 ? 0 : y_begin - 2,\n"
        "              min_int(y_end - 2, kBandH));")


def _variants(src: str, radius: int):
    def only(s):
        s = s.replace("return launch_radius<0>(radius,",
                      f"return launch_radius<{radius}>(radius,")
        return s.replace("if constexpr (R < BLUR_NMS_MAX_RADIUS)",
                         f"if constexpr (R < {radius})")

    def cut(s, *parts):
        for part in parts:
            if part not in s:
                raise AssertionError("blur_nms.cu changed: update the probe")
            s = s.replace(part, "    {}" if part == _H else "")
        return s

    def chunk(s, rows):
        s, n = re.subn(r"constexpr int kChunk = \d+;",
                       f"constexpr int kChunk = {rows};", s)
        if n != 1:
            raise AssertionError("blur_nms.cu changed: update the probe")
        return s

    return {"kernel": only(src), "h_only": only(cut(src, _W, _NMS)),
            "h_w": only(cut(src, _NMS)), "w_nms": only(cut(src, _H)),
            "nms_only": only(cut(src, _H, _W)),
            "chunk_10": only(chunk(src, 10)), "chunk_15": only(chunk(src, 15))}


def _sass_ops(nvcc: str, so: str):
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ops = {}
    for ins in re.findall(r"/\*[0-9a-f]{4,5}\*/\s+([^;]*);", sass):
        op = (ins.split()[1] if ins.startswith("@") else ins.split()[0])
        ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def main() -> int:
    sys.path.insert(0, _REPO)
    import importlib.util

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("blur_nms_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from tpupose_torch.ops import _cuda_build
    from tpupose_torch.ops import blur_nms as bn

    spec = importlib.util.spec_from_file_location(
        "_blur_nms_probe_chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    sigma, thresh = 2.5, 0.05
    c_taps, radius = bn._taps(sigma)
    out_dir = os.path.join(_cuda_build.BUILD_DIR, "blur_nms_probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(_cuda_build.source("blur_nms")) as f:
        variants = _variants(f.read(), radius)
    nvcc = _cuda_build.nvcc()
    procs = {}
    for name, src in variants.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *_cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, out = {}, {"sass": {}, "registers": {}}
    for name, proc in procs.items():
        report, _ = proc.communicate(timeout=600)
        if proc.returncode:
            print(report)
            raise AssertionError(f"nvcc failed for the {name} variant")
        so = os.path.join(out_dir, f"{name}.so")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = re.findall(r"(\d+) bytes spill stores", report)
        out["registers"][name] = regs
        out["sass"][name] = _sass_ops(nvcc, so)
        print(f"{name}: registers {regs}, spill stores {spills} bytes, SASS "
              f"{sum(out['sass'][name].values())} instructions: "
              + ", ".join(f"{k} {v}" for k, v in
                          list(out["sass"][name].items())[:12]))
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.blur_nms_launch.argtypes = [p, p, p, i, i, i,
                                        ctypes.POINTER(ctypes.c_float), i,
                                        ctypes.c_float, p]
        libs[name] = lib

    rng = np.random.RandomState(0)
    for shape in smoke.BLUR_NMS_TIMED:
        x = torch.from_numpy(smoke._planted(rng, *shape)).cuda()
        rs, rm = bn.blur_nms_reference(x, sigma, thresh)
        s = torch.empty_like(x)
        m = torch.empty(shape, dtype=torch.bool, device="cuda")
        fns = {}
        for name, lib in libs.items():
            def launch(lib=lib):
                err = lib.blur_nms_launch(
                    x.data_ptr(), s.data_ptr(), m.data_ptr(), *shape, c_taps,
                    radius, thresh, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            launch()
            torch.cuda.synchronize()
            if name in ("kernel", "chunk_10", "chunk_15") and not (
                    torch.equal(s, rs) and torch.equal(m, rm)):
                raise AssertionError(f"{name} disagrees at {shape}")
            fns[name] = launch
        times = smoke._round_robin_ms(fns, 20, timer=smoke._graph_ms)
        out["x".join(map(str, shape))] = times
        print(f"{shape}: " + ", ".join(f"{k} {v!r} ms" for k, v in
                                      times.items())
              + " (CUDA-graph replays of 20 launches, in turns)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
