#!/usr/bin/env python3
"""Smoke run of the ``tpupose_torch`` port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each fatal on failure (non-zero exit, no result line):

1. Print the card (``nvidia-smi`` name and power limit) and build the
   blur+NMS CUDA kernel from ``tpupose_torch/csrc/blur_nms.cu``.
2. Hold the kernel against its plain PyTorch version on the card at the
   fast path's map shape (18, 320, 432), a planted-peak map (18, 46, 62),
   a map smaller than the blur radius (3, 7, 9) and a large one
   (18, 584, 584): masks equal and smoothed maps bit-equal.  Time both with
   CUDA events.
3. Drive the slice: ``PoseDetector`` with the full 6-stage CocoPoseNet at
   the default 368/320 sizes, seeded random weights calibrated so the maps
   carry peaks, three seeded 480x640 frames through ``__call__`` and the
   same frames through ``detect_batch``.  Checks that the kernel ran, that
   poses were found, that both entry points agree, that the card's
   postprocess equals the CPU one on the same maps, and that the card's
   maps agree with a CPU forward.

The last two lines are the kernels' JSON record and the result line.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time


def _cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls, by CUDA
    events, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, iters: int) -> float:
    """Median host milliseconds of ``fn`` ending in a synchronize."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _planted(rng, j, h, w):
    import numpy as np

    hm = rng.rand(j, h, w).astype(np.float32) * 0.3
    for c in range(j):
        for _ in range(3):
            y, x = rng.randint(2, h - 2), rng.randint(2, w - 2)
            hm[c, y, x] += rng.uniform(0.5, 1.0)
    return hm


def check_kernel(bn, cfg):
    """Phase 2; returns (max_abs_err over shapes, kernel ms, plain ms) at
    the fast path's map shape."""
    import numpy as np
    import torch

    sigma, thresh = cfg.gaussian_sigma, cfg.heatmap_peak_thresh
    rng = np.random.RandomState(0)
    worst = 0.0
    times = None
    for shape in [(18, 320, 432), (18, 46, 62), (3, 7, 9), (18, 584, 584)]:
        x = torch.from_numpy(_planted(rng, *shape)).cuda()
        s, m = bn.blur_nms(x, sigma, thresh)
        rs, rm = bn.blur_nms_reference(x, sigma, thresh)
        torch.cuda.synchronize()
        err = (s - rs).abs().max().item()
        ulps = (s.view(torch.int32) - rs.view(torch.int32)).abs().max().item()
        worst = max(worst, err)
        print(f"blur_nms {shape}: mask_equal={torch.equal(m, rm)} "
              f"bit_equal={torch.equal(s, rs)} max_abs_err={err!r} "
              f"max_ulps={ulps} peaks={int(rm.sum())}")
        if not (torch.equal(m, rm) and torch.equal(s, rs)):
            raise AssertionError(f"blur_nms kernel disagrees at {shape}")
        if shape == (18, 320, 432):
            kernel, plain = [], []
            for order in ("plain", "kernel", "kernel", "plain"):
                fn = (bn.blur_nms if order == "kernel"
                      else bn.blur_nms_reference)
                ms = _cuda_ms(lambda: fn(x, sigma, thresh), iters=50)
                (kernel if order == "kernel" else plain).append(ms)
            times = (statistics.mean(kernel), statistics.mean(plain))
            print(f"blur_nms (18, 320, 432): kernel {times[0]!r} ms, "
                  f"plain {times[1]!r} ms (CUDA events, mean of 2x50)")
    return worst, times[0], times[1]


def _same_tables(a, b, score_atol):
    """Equal pose tables: same persons and joint coordinates, scores
    within ``score_atol``."""
    import numpy as np

    (pa, sa), (pb, sb) = a, b
    return (pa.shape == pb.shape and np.array_equal(pa, pb)
            and np.allclose(sa, sb, rtol=0, atol=score_atol))


def run_slice(bn, cfg, frames):
    """Phase 3 on (B, H, W, 3) uint8 ``frames``; returns the kernel
    launches counted over the main path."""
    import numpy as np
    import torch

    from tpupose_torch.detectors.pose import (PoseDetector,
                                              float32_numerics,
                                              results_to_host)
    from tpupose_torch.ops.grouping import group_keypoints
    from tpupose_torch.ops.paf import compute_connections
    from tpupose_torch.ops.peaks import find_peaks
    from tpupose_torch.ops.postprocess import postprocess_pose
    from tpupose_torch.ops.resize import resize_chainer, resize_u8_linear
    from tpupose_torch.utils.calibrate import calibrate_output_convs
    from tpupose.config import LIMBS_FROM, LIMBS_TO

    t0 = time.perf_counter()
    det = PoseDetector(cfg=cfg, device="cuda", seed=0)
    if not calibrate_output_convs(det, frames[0]):
        raise AssertionError("calibration found no output convs")
    det(frames[0])                                   # warm-up
    torch.cuda.synchronize()
    print(f"detector init + calibration + warm-up: "
          f"{time.perf_counter() - t0:.2f} s")

    # --- the main path, counted ---
    torch.cuda.reset_peak_memory_stats()
    bn.blur_nms.launches = 0
    singles, call_ms = [], []
    for f in frames:
        t0 = time.perf_counter()
        singles.append(det(f))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    batched = det.detect_batch(frames)
    launches = bn.blur_nms.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    print(f"main path: blur_nms launches={launches}, "
          f"poses per frame (__call__)={[len(p) for p, _ in singles]}, "
          f"(detect_batch)={[len(p) for p, _ in batched]}, "
          f"__call__ ms per frame={[round(t, 3) for t in call_ms]}, "
          f"peak device memory {peak_mib:.1f} MiB")
    if launches < 2 * len(frames):
        raise AssertionError(f"blur_nms kernel launched {launches} times")
    if sum(len(p) for p, _ in singles) < 1:
        raise AssertionError("no pose found in any frame")
    for i, (a, b) in enumerate(zip(singles, batched)):
        exact = (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
        print(f"frame {i}: __call__ vs detect_batch exact={exact}")
        # cuDNN may take other algorithms for B=3 and B=1: map values
        # differ by ~1e-5, which reaches the scores, not the coordinates.
        if not _same_tables(a, b, score_atol=1e-4):
            raise AssertionError(f"frame {i}: __call__ != detect_batch")

    # --- card postprocess vs CPU postprocess on the same maps ---
    (paf, hm), _ = det.compute_maps(frames[0])
    map_w = paf.shape[-1]
    with torch.no_grad():
        on_card = results_to_host([postprocess_pose(paf, hm, map_w, cfg)])[0]
        on_cpu = results_to_host([postprocess_pose(
            paf.cpu(), hm.cpu(), map_w, cfg)])[0]
    for name in ("poses", "valid", "num_peaks", "peaks_dropped",
                 "spawns_suppressed"):
        if not np.array_equal(getattr(on_card, name), getattr(on_cpu, name)):
            raise AssertionError(f"card vs CPU postprocess: {name} differs")
    score_err = float(np.abs(on_card.scores - on_cpu.scores).max())
    print(f"card vs CPU postprocess on the same maps: tables equal, "
          f"{int(on_card.valid.sum())} poses, {int(on_card.num_peaks)} "
          f"peaks, max score err {score_err!r}")
    if score_err > 1e-4:
        raise AssertionError("card vs CPU postprocess scores differ")

    # --- card forward vs CPU forward ---
    cpu_det = PoseDetector(cfg=cfg, device="cpu", seed=0)
    cpu_det.model.load_state_dict(det.model.state_dict())
    (cpaf, chm), _ = cpu_det.compute_maps(frames[0])
    for name, got, ref in (("paf", paf, cpaf), ("heatmap", hm, chm)):
        err = (got.cpu() - ref).abs().max().item()
        scale = ref.abs().max().item()
        print(f"{name} maps card vs CPU: max_abs_err={err!r} "
              f"(max |ref| {scale!r})")
        # float32 sums in other orders through 40 convs; TF32 (1e-3) fails.
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{name} maps: card and CPU disagree")

    # --- where the time goes, per frame ---
    (in_h, in_w), _ = det._geometry(*frames.shape[1:3])
    resized = resize_u8_linear(frames[0], (in_w, in_h))
    map_hw = tuple(paf.shape[-2:])
    with float32_numerics(), torch.no_grad():
        x = torch.from_numpy(resized[None]).cuda().float() / 255.0 - 0.5
        pafs, heatmaps = det.model(x)
        peaks = find_peaks(hm[:-1].contiguous(), cfg.gaussian_sigma,
                           cfg.heatmap_peak_thresh, cfg.max_peaks_per_joint)
        conns = compute_connections(paf, peaks, float(map_w), cfg,
                                    LIMBS_FROM, LIMBS_TO)
        n_conn = int(conns.valid.sum())
        split = {
            "host_resize_ms": _host_ms(
                lambda: resize_u8_linear(frames[0], (in_w, in_h)), 5),
            "forward_ms": _cuda_ms(lambda: det.model(x), 5),
            "map_resize_ms": _cuda_ms(lambda: (
                resize_chainer(pafs[-1], map_hw),
                resize_chainer(heatmaps[-1], map_hw)), 20),
            "postprocess_ms": _host_ms(
                lambda: postprocess_pose(paf, hm, map_w, cfg), 5),
            "peaks_ms": _host_ms(lambda: find_peaks(
                hm[:-1].contiguous(), cfg.gaussian_sigma,
                cfg.heatmap_peak_thresh, cfg.max_peaks_per_joint), 5),
            "connections_ms": _host_ms(lambda: compute_connections(
                paf, peaks, float(map_w), cfg, LIMBS_FROM, LIMBS_TO), 5),
            "grouping_fold_ms": _host_ms(
                lambda: group_keypoints(conns, peaks, cfg), 5),
            "call_ms": _host_ms(lambda: det(frames[0]), 5),
            "detect_batch3_ms": _host_ms(lambda: det.detect_batch(frames),
                                         3),
        }
    print(f"per-frame split ({frames.shape[1:3]} frame, {(in_h, in_w)} "
          f"input, {map_hw} maps, "
          f"{n_conn} valid connections): "
          + json.dumps({k: round(v, 4) for k, v in split.items()}))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    try:
        from tpupose.config import INFERENCE
        from tpupose_torch.ops import blur_nms as bn
    except ImportError as e:
        print(f"chip_smoke: run it from the repository root ({e})",
              file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = bn.build()
    print(f"built {lib} in {time.perf_counter() - t0:.2f} s")

    # Relaxed subset filter (as tests/test_golden_parity.py) so random
    # weights form persons; sizes are the defaults, 368 in / 320 maps.
    cfg = dataclasses.replace(INFERENCE, max_subsets=128,
                              n_subset_limbs_thresh=2,
                              subset_score_thresh=0.05)
    err, kernel_ms, plain_ms = check_kernel(bn, cfg)
    import numpy as np

    frames = np.random.RandomState(0).randint(
        0, 256, (3, 480, 640, 3)).astype(np.uint8)
    launches = run_slice(bn, cfg, frames)

    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax")]
    if leaked:
        raise AssertionError(f"the port imported {leaked[:4]}")
    print(json.dumps({"kernels": [{
        "name": "blur_nms", "route": "cuda",
        "source": "tpupose_torch/csrc/blur_nms.cu",
        "replaces": "tpupose/ops/pallas/blur_nms.py:103",
        "launches": launches, "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
