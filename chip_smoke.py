#!/usr/bin/env python3
"""Smoke run of the ``tpupose_torch`` port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each fatal on failure (non-zero exit, no result line):

1. Print the card (``nvidia-smi`` name and power limit) and build the four
   CUDA kernels from ``tpupose_torch/csrc/`` (``blur_nms.cu``,
   ``conv7_s8.cu``, ``conv_s8.cu``, ``requant.cu``), one ``nvcc`` per
   source, in parallel, beside ``nvcc -Xptxas -v`` on ``blur_nms.cu``,
   ``conv7_s8.cu`` and ``conv_s8.cu`` (registers, shared memory and spills
   of each of their kernels, printed).
2. Hold the blur+NMS kernel against its plain PyTorch version on the card at
   the fast path's map shape (18, 320, 432), the precise path's
   (18, 480, 640), a planted-peak map (18, 46, 62), a map smaller than the
   blur radius (3, 7, 9), a large one (18, 584, 584), a ragged one
   (18, 321, 433), thin ones (2, 5, 300) and (2, 300, 5) and a batch of 8
   frames' maps (144, 320, 432): masks equal and smoothed maps bit-equal.
   At (18, 320, 432) and (18, 480, 640), time the kernel from CUDA-graph
   replays in turns with its plain version, beside its two floors (bytes,
   and float32 instructions at the non-FMA rate); at (18, 320, 432) also
   the wrapper's host enqueue time per call.
3. Drive the f32 fast path: ``PoseDetector`` with the full 6-stage
   CocoPoseNet at the default 368/320 sizes, seeded random weights
   calibrated so the maps carry peaks, three seeded 480x640 frames through
   ``__call__`` and the same frames through ``detect_batch``.  Checks that
   the kernel ran, that poses were found, that both entry points agree,
   that the card's postprocess equals the CPU one on the same maps, and
   that the card's maps agree with a CPU forward.
4. Hold the int8 kernels against their plain versions, bit-equal: conv7 at
   the four pyramid grids, with Mconv1's three groups and 128 -> 128, at
   batches of 2 and 3, at a grid that is a multiple of no tile and at a
   grid smaller than the window, each at every block tile of the kernel;
   requant at conv1_2's shapes (fast path, pyramid scales 0.5 and 2.0 at
   B = 2) and a refine stage's; conv_s8 at the fast path's conv1_2,
   conv3_2, conv4_2, conv5_4 and Mconv6 layers and at the input layer,
   ragged grids, a batch of 3 and the precise path's (2, 736, 984) canvas,
   each at every tile of the kernel.  Time conv7 per pyramid grid and
   conv_s8 at its five layers from CUDA-graph replays, in turns with their
   plain versions, ``torch._int_mm`` on the prebuilt patch matrix and each
   of their tiles, beside their bounds from the shapes; requant likewise
   at conv1_2's shape.
5. Drive the quantized fast path: ``quantize([f, f[:, ::-1]])`` of the
   calibrated detector, the three frames through ``__call__`` and
   ``detect_batch``.  Checks 50 conv7, 30 conv_s8 and no requant launches
   per forward, poses, both entry points agreeing, the card's int8 head
   maps bit-equal to the CPU's int8 forward on the same tree, and the int8
   maps' fidelity to the f32 ones (rms, corr; fails below corr 0.9).
6. Drive the precise pyramid (4 scales), f32 and quantized, on two frames
   through ``__call__`` and ``detect_batch`` (B = 2).  Checks poses, both
   entry points agreeing, blur+NMS at the original (18, 480, 640)
   resolution, conv7 at all four pyramid grids, 30 conv_s8 launches per
   50 conv7 ones and no requant, and, per pyramid scale, the card's int8
   maps bit-equal to the CPU's int8 forward on the same tree.

After each driven path (3, 5, 6, 8, 9 and phase 7's im2col forward), every
kernel is held against its plain version, bit-equal, on seeded random
inputs at every shape the path gave it (the wrappers' ``shapes``
counters).
7. Print where the time goes: the fast path's split; the int8 forward on
   its kernel route (checked: 50 conv7, 30 conv_s8, no requant launches)
   against its im2col route (checked: 80 requant launches, one per int8
   layer that is not a head), by CUDA events, and each route's device time
   by operation (``torch.profiler``: the costliest operations by name,
   launches per forward); f32 against int8 precise ``__call__``; conv7
   per pyramid grid and conv_s8 per timed layer against their plain
   versions; last, the blur+NMS kernel's device time inside one fast-path
   postprocess (``torch.profiler``).
8. Drive the crop nets: ``FaceDetector`` and ``HandDetector`` (full
   FaceNet / HandNet, 368x368 crops, seeded weights with the last output
   conv scaled so keypoints clear the threshold) behind
   ``apps/demo.py::cascade_results`` on the three frames with the fast f32
   pose detector; up to 8 faces and 8 hands of the cascade (topped up from
   fixed boxes to 2 faces, 2 left and 2 right hands) through
   ``detect_batch``, f32, then int8 after ``quantize`` on those crops.
   Checks 25 conv7, 21 conv_s8 and no requant launches per int8 crop
   forward, conv7 at groups (71, 128) and (22, 128), every kernel at every
   shape the path gave it, and, on the fixed boxes' 2 faces and a left
   and a right hand (the random poses cut crops of 550-1700 px, too large
   for the CPU's tails), the card's maps against a CPU twin's (f32 within
   1e-4 x max|ref|, int8 bit-equal) and its keypoints equal to the twin's
   (a channel whose two maxima lie within the tolerance is excused and
   counted).  Then conv7 at (1 and 8,
   46, 46) with the crop nets' groups and conv_s8 at conv4_3 and
   conv5_3_CPM, every tile, bit-equal; conv7 timed there beside its plain
   version, ``_int_mm`` and bound; blur_nms at sigma 5 and 8 (radius 20
   and 32: the run-time-tap kernel) bit-equal, radius 20 timed beside 10;
   ``greedy_match``'s planted ties, card against CPU; 1x1, 16x9 and 9x16
   frames give (0, 18, 3) tables on the fast, precise and int8 paths.
   Phase 6 also checks ``detect_precise`` against ``__call__``.  Prints
   the crop forwards' times (CUDA events, B = 1 and 8) and
   ``detect_batch``'s host time per crop.
9. Drive the serving path (``apps/serve.py``, ``serving.py``,
   ``detectors/bucketed.py``) with raw ``application/octet-stream``
   requests to ``make_server`` servers on port 0: over the f32 and the
   quantized fast detectors, ``/v1/detect`` equal to ``__call__``,
   ``/v1/detect_batch`` (B = 3) equal to ``detect_batch``, 4 client threads
   over 480x640 and 360x480 frames equal to sequential replies, and 1
   blur_nms (+ 50 conv7 and 30 conv_s8 on int8) launches per request; over
   ``BucketedPoseDetector(f32, canvas_palette(640))``, 375x500, 426x640
   and 480x480 frames equal to in-process bucketing and a batch of 3
   same-size frames in one wrapped ``detect_batch``; then
   ``save_bundle(..., platforms=("cuda",), batch_sizes=(2,))`` of the
   fast f32, fast int8 and precise int8 detectors at 480x640, each loaded
   by ``ServingPoseDetector`` and served: tables equal to the live
   detector's, B = 2 equal to its ``detect_batch``, the kernels launched
   inside the programs through the ``tpupose::*`` ops; an int8 FaceNet
   crop bundle whose keypoints equal the live crop detector's.  After
   each, every kernel is re-checked at the shapes it recorded.  Prints
   export and load times, HTTP and in-process latency (medians of 10),
   requests per second from 4 clients and the phase's seconds, beside
   the card's name and power limit.
10. Train (``tpupose_torch.train``, ``data``, ``apps/train_cli.py``; no
   kernel runs on this path: GT rendering, the loss and Adam are plain
   torch on the card).  CocoPoseNet, 6 stages at 368, B = 10, on
   synthetic batches in f32 (TF32 off, deterministic cuDNN) and in bf16:
   2 warm-up and 10 timed steps under the default stem freeze (finite
   losses, the 10 frozen stem layers bit-unchanged), then 20 steps on one
   fixed batch without the freeze (the loss must fall); FaceNet and
   HandNet at 368, B = 10, f32, 10 steps on a fixed batch (the loss must
   fall).  The full net at insize 64, B = 2, on the card against the CPU:
   GT maps within atol 1e-5, loss rtol 1e-4, each gradient leaf within
   1e-3 x max |g|.  ``remat`` gradients within 1e-6 x max |g| of the plain
   ones at 368, B = 10, with both peak memories.  Save at step 2, restore
   into a fresh state, step 3 bit-equal to an uninterrupted run; the npz
   export reloads into ``CocoPoseNet`` unchanged.  ``train_cli.main(
   ["--synthetic", "--test"])`` with and without ``--bf16`` (log,
   snapshot, ``posenet_final.npz``).  Prints step ms (median, min, max),
   images/s, TFLOP/s from the convs' count, peak memory per dtype and
   with remat, the loader's samples/s at 0 and 4 workers and the phase's
   seconds, beside the card's name and power limit.

The last two lines are the kernels' JSON record (each kernel's time, plain
time, bound and launches on the driven paths, the crop nets' and the
serving phase's, bundles included;
requant's launches are those of phase 7's im2col forward, the only route
that runs it) and the result line.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


def _graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` replayed from a CUDA
    graph of ``iters`` calls (5 replays, CUDA events): the device's time
    without the gaps the host's Python leaves between eager launches."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def _enqueue_ms(fn, calls: int) -> float:
    """Mean host milliseconds to enqueue one call of ``fn``: the host clock
    over ``calls`` calls with no synchronize between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


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


# blur_nms: the shapes it is held bit-equal at (the fast path's and the
# precise path's maps, a planted-peak map, a map smaller than the radius, a
# large one, a ragged one, thin ones and a batch of 8 frames' maps), and
# the two it is timed at.
BLUR_NMS_SHAPES = [(18, 320, 432), (18, 480, 640), (18, 46, 62), (3, 7, 9),
                   (18, 584, 584), (18, 321, 433), (2, 5, 300), (2, 300, 5),
                   (144, 320, 432)]
BLUR_NMS_TIMED = ((18, 320, 432), (18, 480, 640))


def check_kernel(bn, cfg):
    """Phase 2; returns (max_abs_err over shapes, {timed shape: ms by name:
    "kernel" and "plain" in turns, "eager", "bytes" and "operations"
    floors})."""
    import numpy as np
    import torch

    sigma, thresh = cfg.gaussian_sigma, cfg.heatmap_peak_thresh
    rng = np.random.RandomState(0)
    worst = 0.0
    times = {}
    for shape in BLUR_NMS_SHAPES:
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
        if shape not in BLUR_NMS_TIMED:
            continue

        def kernel():
            bn.blur_nms(x, sigma, thresh)

        # The plain version copies its mirror index from the host on every
        # call, so CUDA events time it, not a CUDA graph.
        kernel_ms, plain_ms = [], []
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                kernel_ms.append(_graph_ms(kernel, 20))
            else:
                plain_ms.append(_cuda_ms(
                    lambda: bn.blur_nms_reference(x, sigma, thresh), 10))
        times[shape] = dict(kernel=statistics.mean(kernel_ms),
                            plain=statistics.mean(plain_ms),
                            eager=_cuda_ms(kernel, 50),
                            **blur_nms_floors(*shape))
        print(f"blur_nms {shape}: " + ", ".join(
            f"{k} {v!r} ms" for k, v in times[shape].items())
            + " (kernel: CUDA-graph replays of 20 calls, plain: CUDA events "
            "over 10 calls, in turns; eager: the kernel launched 50 times "
            "by CUDA events; floors: bytes over the memory rate, "
            "instructions over the non-FMA float32 rate)")
        if shape == (18, 320, 432):
            enqueue = _enqueue_ms(kernel, 1000)
            print(f"blur_nms wrapper host enqueue at {shape}: {enqueue!r} ms "
                  f"per call (host clock over 1000 calls, no synchronize)")
    return worst, times


def profile_blur_nms(det, cfg, frame):
    """The blur_nms kernel's device time and launches inside one fast-path
    postprocess of ``det``'s maps of ``frame`` (``torch.profiler``, mean of
    3); fails if the profiler shows none."""
    import torch

    from tpupose_torch.ops.postprocess import postprocess_pose

    (paf, hm), _ = det.compute_maps(frame)
    with torch.no_grad():
        ops = _profile_forward(
            lambda _: postprocess_pose(paf, hm, paf.shape[-1], cfg), None)
    kernel = {name: v for name, v in ops.items() if "blur_nms_kernel" in name}
    if not kernel:
        raise AssertionError("torch.profiler shows no blur_nms kernel in the "
                             "postprocess")
    ms = sum(v[0] for v in kernel.values())
    launches = sum(v[1] for v in kernel.values())
    print(f"blur_nms inside one fast-path postprocess ({tuple(hm.shape)} "
          f"maps): {ms!r} ms of device time in {launches!r} launches "
          f"(torch.profiler, mean of 3); the postprocess's kernels "
          f"{sum(v[0] for v in ops.values())!r} ms in "
          f"{sum(v[1] for v in ops.values())!r} launches")
    return ms


def _same_tables(a, b, score_atol):
    """Equal pose tables: same persons and joint coordinates, scores
    within ``score_atol``."""
    import numpy as np

    (pa, sa), (pb, sb) = a, b
    return (pa.shape == pb.shape and np.array_equal(pa, pb)
            and np.allclose(sa, sb, rtol=0, atol=score_atol))


def run_slice(bn, cfg, frames):
    """Phase 3 on (B, H, W, 3) uint8 ``frames``; returns the kernel
    launches counted over the main path and the calibrated detector."""
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
    from tpupose_torch.config import LIMBS_FROM, LIMBS_TO

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
    _reset_counts()
    singles, call_ms = [], []
    for f in frames:
        t0 = time.perf_counter()
        singles.append(det(f))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    batched = det.detect_batch(frames)
    launches = bn.blur_nms.launches
    shapes = _read_shapes()
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
    check_path_shapes("fast f32 path", cfg, shapes)

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
    return launches, det


def _round_robin_ms(fns, iters: int, timer=None):
    """Mean ms of each of ``fns`` (a dict) by ``timer`` (``_cuda_ms`` if
    None), timed in its order and then in reverse, so drift in the card's
    clock falls on all."""
    timer = timer or _cuda_ms
    order = list(fns) + list(reversed(list(fns)))
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(timer(fns[name], iters))
    return {name: statistics.mean(t) for name, t in times.items()}


# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet):
# HBM bytes/s, int8 tensor-core ops/s, float32 ops/s outside the tensor
# cores (an FMA counted as two).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
# float32 instructions that do not fuse (FMUL, FADD, FSETP) at one per lane
# per cycle: 132 SMs x 128 lanes x 1.98 GHz, half of F32_OPS_PER_S.
F32_NONFMA_OPS_PER_S = 33.5e12


def _bound(n_bytes, ops, peak_ops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv7_bound(b, h, w, channels, o):
    """conv7's bound: each input (activations, int8 weights, mults, bias)
    read once and the int8 output written once; 2 int8 operations per
    multiply-add of the real (unpadded) channels."""
    c = sum(channels)
    n_bytes = b * h * w * c + 49 * c * o + 4 * o * (len(channels) + 1) \
        + b * h * w * o
    return _bound(n_bytes, 2 * b * h * w * o * 49 * c, INT8_OPS_PER_S)


def blur_nms_floors(j, h, w, taps=21):
    """blur_nms's two floors, ms: float32 maps in, float32 maps and an int8
    mask out, over the memory rate; and per pixel 2 x taps multiplies,
    2 x (taps - 1) adds and 5 comparisons (sigma 2.5: 21 taps), which
    bit-equality keeps from fusing, over the non-FMA float32 rate."""
    n = j * h * w
    return {"bytes": n * (4 + 4 + 1) / HBM_BYTES_PER_S * 1e3,
            "operations": n * (2 * taps + 2 * (taps - 1) + 5)
            / F32_NONFMA_OPS_PER_S * 1e3}


def blur_nms_bound(j, h, w):
    """blur_nms's bound: the larger of its two floors."""
    by, ms = max(blur_nms_floors(j, h, w).items(), key=lambda kv: kv[1])
    return ms, by


def requant_bound(shape, groups):
    """requant's bound: G int32 accumulators, mults and bias in, int8 out;
    per element and group a convert, a multiply and an add, then bias,
    max, round and two clips."""
    import math

    n, o = math.prod(shape), shape[-1]
    return _bound(n * (4 * groups + 1) + 4 * o * (groups + 1),
                  n * (3 * groups + 5), F32_OPS_PER_S)


def conv_s8_bound(b, h, w, c, o, k):
    """conv_s8's bound: the int8 input, int8 weights, mult and bias read
    once and the int8 output written once; 2 int8 operations per
    multiply-add of the real (unpadded) channels."""
    n_bytes = b * h * w * c + k * k * c * o + 8 * o + b * h * w * o
    return _bound(n_bytes, 2 * b * h * w * o * k * k * c, INT8_OPS_PER_S)


def _conv_s8_case(rng, b, h, w, c, o, k):
    """Seeded conv_s8 inputs on the card: the input spans the input layer's
    [-128, 127], and the mult puts the epilogue's values around
    [-60, 120], so the ReLU, the rounding and both clips act."""
    import numpy as np
    import torch

    def put(a):
        return torch.from_numpy(a).cuda()

    x = put(rng.randint(-128, 128, (b, h, w, c)).astype(np.int8))
    kq = put(rng.randint(-127, 128, (k, k, c, o)).astype(np.int8))
    acc_std = 74.0 * 73.0 * (k * k * c) ** 0.5
    mult = put((rng.uniform(0.5, 1.5, o) * 40.0 / acc_std).astype(
        np.float32))
    bias = put(rng.uniform(-20.0, 40.0, o).astype(np.float32))
    return x, kq, mult, bias


def _conv7_case(rng, b, h, w, channels):
    import numpy as np
    import torch

    def put(a):
        return torch.from_numpy(a).cuda()

    parts = [put(rng.randint(0, 128, (b, h, w, c)).astype(np.int8))
             for c in channels]
    kernels = [put(rng.randint(-127, 128, (7, 7, c, 128)).astype(np.int8))
               for c in channels]
    mults = [put((np.abs(rng.randn(128)) * 1e-4 + 1e-5).astype(np.float32))
             for _ in channels]
    bias = put((rng.randn(128) * 0.01).astype(np.float32))
    return parts, kernels, mults, bias


def _requant_case(gen, shape, groups):
    """Seeded s32 accumulators, mults and bias on the card; the products
    span about [-100, 100], so rounding and both clips are exercised."""
    import torch

    accs = [torch.randint(-2**20, 2**20, shape, generator=gen,
                          dtype=torch.int32, device="cuda")
            for _ in range(groups)]
    mults = [torch.rand(shape[-1], generator=gen, device="cuda") * 1e-4
             for _ in range(groups)]
    bias = torch.randn(shape[-1], generator=gen, device="cuda")
    return accs, mults, bias


PYRAMID_GRIDS = ((23, 31), (46, 62), (69, 92), (92, 123))
MCONV1_CHANNELS = (38, 19, 128)


def check_path_shapes(label, cfg, shapes):
    """Hold each kernel against its plain version, bit-equal, on seeded
    random inputs at every shape one driven path gave it.  ``shapes``: the
    wrappers' ``shapes`` counters, copied just after the path ran."""
    import numpy as np
    import torch

    from tpupose_torch.ops import blur_nms as bn
    from tpupose_torch.ops import conv7 as c7
    from tpupose_torch.ops import conv_s8 as cs
    from tpupose_torch.ops import requant as rq

    rng = np.random.RandomState(1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sigma, thresh = cfg.gaussian_sigma, cfg.heatmap_peak_thresh
    for shape in sorted(shapes["blur_nms"]):
        x = torch.from_numpy(_planted(rng, *shape)).cuda()
        (s, m), (rs, rm) = (bn.blur_nms(x, sigma, thresh),
                            bn.blur_nms_reference(x, sigma, thresh))
        if not (torch.equal(s, rs) and torch.equal(m, rm)):
            raise AssertionError(f"{label}: blur_nms disagrees at {shape}")
    for b, h, w, channels in sorted(shapes["conv7_s8"]):
        parts, kernels, mults, bias = _conv7_case(rng, b, h, w, channels)
        got = c7.conv7_s8(parts, kernels, mults, bias)
        ref = c7.conv7_s8_reference(parts, kernels, mults, bias)
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: conv7_s8 disagrees at "
                                 f"{(b, h, w)} groups {channels}")
    for b, h, w, c, o, k in sorted(shapes["conv_s8"]):
        x, kq, mult, bias = _conv_s8_case(rng, b, h, w, c, o, k)
        got = cs.conv_s8(x, kq, mult, bias)
        ref = cs.conv_s8_reference(x, kq, mult, bias)
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: conv_s8 disagrees at "
                                 f"{(b, h, w)} {c} -> {o}, {k}x{k}")
    for shape, groups, relu, lo in sorted(shapes["requant_epilogue"]):
        accs, mults, bias = _requant_case(gen, shape, groups)
        got = rq.requant_epilogue(accs, mults, bias, relu, lo)
        ref = rq.requant_epilogue_reference(accs, mults, bias, relu, lo)
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: requant disagrees at {shape} "
                                 f"groups {groups} relu {relu} lo {lo}")
    torch.cuda.synchronize()
    print(f"{label}: every kernel bit-equal to its plain version at every "
          f"shape the path gave it: blur_nms "
          f"{sorted(shapes['blur_nms'])}, conv7_s8 "
          f"{len(shapes['conv7_s8'])} shapes, conv_s8 "
          f"{len(shapes['conv_s8'])} shapes, requant_epilogue "
          f"{len(shapes['requant_epilogue'])} shapes (largest "
          f"{max(shapes['requant_epilogue'], default=None, key=_numel)})")


def _numel(requant_key):
    import math

    return math.prod(requant_key[0])


def _patch_matrix(x, k):
    """The prebuilt im2col patch matrix of a k x k layer's input, padded as
    ``int_mm`` pads it (M to a multiple of 32, K to a multiple of 8)."""
    import torch
    import torch.nn.functional as F

    from tpupose_torch.ops import conv7 as c7

    b, h, w, c = x.shape
    r = k // 2
    xp = F.pad(x, (0, 0, r, r, r, r))
    a = torch.cat([xp[:, dy:dy + h, dx:dx + w, :] for dy in range(k)
                   for dx in range(k)], dim=-1).reshape(b * h * w, k * k * c)
    m, kk = a.shape
    return F.pad(a, (0, c7._round_up(kk, 8) - kk, 0,
                     c7._round_up(m, 32) - m)).contiguous()


def check_int8_kernels():
    """Phase 4: conv7 and requant bit-equal to their plain versions.
    Returns ``{name: (max_abs_err, ms, plain_ms, bound)}`` at the
    representative shapes (conv7 at (1, 46, 62) 128 -> 128, requant at
    conv1_2's (1, 368, 496, 64)) and, per pyramid grid, conv7's times at
    128 -> 128: ``{"kernel", "plain", "int_mm", "bound"}`` in ms."""
    import numpy as np
    import torch

    from tpupose_torch.ops import conv7 as c7
    from tpupose_torch.ops import requant as rq

    rng = np.random.RandomState(0)
    out, per_grid, worst = {}, {}, 0
    cases = [((1, *hw), channels) for hw in PYRAMID_GRIDS
             for channels in (MCONV1_CHANNELS, (128,))]
    cases += [((2, 46, 62), MCONV1_CHANNELS), ((3, 46, 62), (128,)),
              ((1, 47, 61), MCONV1_CHANNELS), ((1, 5, 7), (128,))]
    for bhw, channels in cases:
        parts, kernels, mults, bias = _conv7_case(rng, *bhw, channels)
        packed = [c7.pack_conv7_weights(k) for k in kernels]
        ref = c7.conv7_s8_reference(parts, kernels, mults, bias)
        tiles = {}
        for tile, rows in enumerate(c7.TILE_ROWS):
            got = c7.conv7_s8(parts, kernels, mults, bias, packed=packed,
                              tile=tile)
            torch.cuda.synchronize()
            err = (got.int() - ref.int()).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(got, ref):
                raise AssertionError(f"conv7_s8 kernel disagrees at {bhw} "
                                     f"{channels}, {rows}-row tile")
            tiles[tile] = lambda tile=tile: c7.conv7_s8(
                parts, kernels, mults, bias, packed=packed, tile=tile)
        pick = c7.pick_tile(*bhw, 128)
        print(f"conv7_s8 {bhw} groups {channels}: bit_equal=True at every "
              f"tile of {list(c7.TILE_ROWS)} rows (picks "
              f"{c7.TILE_ROWS[pick]}), "
              f"positive={float((ref > 0).float().mean()):.3f}")
        if bhw[0] != 1 or bhw[1:] not in PYRAMID_GRIDS:
            continue
        bound, bound_by = conv7_bound(*bhw, channels, 128)
        fns = {"plain": lambda: c7.conv7_s8_reference(parts, kernels,
                                                      mults, bias),
               "kernel": tiles[pick]}
        if channels == (128,):
            patches = _patch_matrix(parts[0], 7)
            wmat = kernels[0].reshape(49 * 128, 128).contiguous()
            fns["int_mm"] = lambda: torch._int_mm(patches, wmat)
        times = _round_robin_ms(fns, iters=20, timer=_graph_ms)
        by_tile = _round_robin_ms(
            {c7.TILE_ROWS[t]: fn for t, fn in tiles.items()}, iters=20,
            timer=_graph_ms)
        eager = _cuda_ms(tiles[pick], 20)
        print(f"conv7_s8 {bhw} groups {channels}: "
              + ", ".join(f"{k} {v!r} ms" for k, v in times.items())
              + f", bound {bound!r} ms ({bound_by}); per tile of rows x "
              f"16 columns x 32 channels: "
              + ", ".join(f"{k} {v!r}" for k, v in by_tile.items())
              + " ms (CUDA-graph replays of 20 calls, in turns); kernel "
              f"launched eagerly {eager!r} ms (CUDA events, host-bound)")
        if channels == (128,):
            per_grid[bhw[1:]] = dict(times, bound=bound, eager=eager)
            if bhw[1:] == (46, 62):
                sample = (times["kernel"], times["plain"], (bound, bound_by))
    out["conv7_s8"] = (float(worst), *sample)

    worst = 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, groups, relu, lo in [((1, 368, 496, 64), 1, True, 0.0),
                                    ((1, 184, 248, 64), 1, True, 0.0),
                                    ((2, 736, 984, 64), 1, True, 0.0),
                                    ((1, 46, 62, 128), 1, True, 0.0),
                                    ((1, 46, 62, 128), 3, False, -128.0)]:
        accs, mults, bias = _requant_case(gen, shape, groups)
        got = rq.requant_epilogue(accs, mults, bias, relu, lo)
        ref = rq.requant_epilogue_reference(accs, mults, bias, relu, lo)
        torch.cuda.synchronize()
        err = (got.int() - ref.int()).abs().max().item()
        worst = max(worst, err)
        print(f"requant_epilogue {shape} groups {groups} relu {relu} lo "
              f"{lo}: bit_equal={torch.equal(got, ref)} max_abs_err={err}")
        if not torch.equal(got, ref):
            raise AssertionError(f"requant kernel disagrees at {shape}")
        if shape == (1, 368, 496, 64):
            fns = {"plain": lambda: rq.requant_epilogue_reference(
                       accs, mults, bias, relu, lo),
                   "kernel": lambda: rq.requant_epilogue(
                       accs, mults, bias, relu, lo)}
            times = _round_robin_ms(fns, iters=20, timer=_graph_ms)
            eager = _cuda_ms(fns["kernel"], 50)
            bound = requant_bound(shape, groups)
            print(f"requant_epilogue {shape}: kernel {times['kernel']!r} ms, "
                  f"plain {times['plain']!r} ms, bound {bound[0]!r} ms "
                  f"({bound[1]}) (CUDA-graph replays of 20 calls, in "
                  f"turns); kernel launched eagerly {eager!r} ms (CUDA "
                  f"events)")
    out["requant_epilogue"] = (float(worst), times["kernel"],
                               times["plain"], bound)
    return out, per_grid


# conv_s8's timed layers of the fast int8 path, (B, H, W, C, O, k), and
# the shapes it is only held bit-equal at: the input layer, ragged grids
# and N blocks at O = 64, a batch, and the precise path's largest canvas.
CONV_S8_TIMED = {"conv1_2": (1, 368, 496, 64, 64, 3),
                 "conv3_2": (1, 92, 124, 256, 256, 3),
                 "conv4_2": (1, 46, 62, 512, 512, 3),
                 "conv5_4": (1, 46, 62, 128, 512, 1),
                 "Mconv6": (1, 46, 62, 128, 128, 1)}
CONV_S8_CHECKED = [(1, 368, 496, 3, 64, 3), (1, 47, 61, 128, 64, 3),
                   (1, 5, 7, 64, 64, 3), (1, 23, 31, 128, 128, 1),
                   (3, 46, 62, 128, 128, 3), (2, 47, 61, 256, 128, 1),
                   (2, 736, 984, 64, 64, 3)]


def check_conv_s8():
    """Phase 4, conv_s8: bit-equal to its plain version at every timed and
    checked shape, each at every tile of the kernel; at the timed layers,
    CUDA-graph times, in turns, of the kernel (``pick_tile``'s tile), its
    plain route, ``torch._int_mm`` on the prebuilt patch matrix and each
    tile, beside its bound.  Returns ``(record, {layer: times})``, the
    record at conv1_2: ``(max_abs_err, ms, plain_ms, bound)``."""
    import numpy as np
    import torch

    from tpupose_torch.ops import conv_s8 as cs

    rng = np.random.RandomState(2)
    worst, per_layer = 0, {}
    cases = [(name, shape) for name, shape in CONV_S8_TIMED.items()]
    cases += [(None, shape) for shape in CONV_S8_CHECKED]
    for name, (b, h, w, c, o, k) in cases:
        x, kq, mult, bias = _conv_s8_case(rng, b, h, w, c, o, k)
        packed = cs.pack_conv_s8_weights(kq)
        ref = cs.conv_s8_reference(x, kq, mult, bias)
        tiles = {}
        for tile, (rows, warps_k, tile_n) in enumerate(cs.TILES):
            if o % tile_n:
                continue
            got = cs.conv_s8(x, kq, mult, bias, packed=packed, tile=tile)
            torch.cuda.synchronize()
            err = (got.int() - ref.int()).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"conv_s8 kernel disagrees at {(b, h, w)} {c} -> {o}, "
                    f"{k}x{k}, tile {(rows, warps_k, tile_n)}: max_abs_err "
                    f"{err}, {(got != ref).sum().item()} of {ref.numel()}")
            tiles[tile] = lambda tile=tile: cs.conv_s8(
                x, kq, mult, bias, packed=packed, tile=tile)
        pick = cs.pick_tile(b, h, w, c, o, k)
        print(f"conv_s8 {(b, h, w)} {c} -> {o} {k}x{k}: bit_equal=True at "
              f"every tile {[cs.TILES[t] for t in tiles]} (picks "
              f"{cs.TILES[pick]}), "
              f"positive={float((ref > 0).float().mean()):.3f}, "
              f"at 127={float((ref == 127).float().mean()):.3f}")
        if name is None:
            continue
        bound, bound_by = conv_s8_bound(b, h, w, c, o, k)
        patches = _patch_matrix(x, k)
        wmat = torch.nn.functional.pad(
            kq.reshape(k * k * c, o),
            (0, 0, 0, patches.shape[1] - k * k * c)).contiguous()
        fns = {"plain": lambda: cs.conv_s8_reference(x, kq, mult, bias),
               "kernel": tiles[pick],
               "int_mm": lambda: torch._int_mm(patches, wmat)}
        iters = 5 if h > 200 else 20
        times = _round_robin_ms(fns, iters=iters, timer=_graph_ms)
        by_tile = _round_robin_ms(
            {cs.TILES[t]: fn for t, fn in tiles.items()}, iters=iters,
            timer=_graph_ms)
        eager = _cuda_ms(tiles[pick], iters)
        macs = b * h * w * o * k * k * c
        print(f"conv_s8 {name} {(b, h, w)} {c} -> {o} {k}x{k}: "
              + ", ".join(f"{n} {v!r} ms" for n, v in times.items())
              + f", bound {bound!r} ms ({bound_by}), kernel "
              f"{macs / times['kernel'] / 1e9!r} T MAC/s; per tile (rows, "
              f"K warps, channels): "
              + ", ".join(f"{n} {v!r}" for n, v in by_tile.items())
              + f" ms (CUDA-graph replays of {iters} calls, in turns); "
              f"kernel launched eagerly {eager!r} ms (CUDA events)")
        per_layer[name] = dict(times, bound=bound, eager=eager,
                               tiles={str(n): v for n, v in by_tile.items()})
        if name == "conv1_2":
            record = (times["kernel"], times["plain"], (bound, bound_by))
    torch.cuda.synchronize()
    return (float(worst), *record), per_layer


def _wrappers():
    from tpupose_torch.ops import blur_nms as bn
    from tpupose_torch.ops import conv7 as c7
    from tpupose_torch.ops import conv_s8 as cs
    from tpupose_torch.ops import requant as rq

    return {"blur_nms": bn.blur_nms, "conv7_s8": c7.conv7_s8,
            "conv_s8": cs.conv_s8, "requant_epilogue": rq.requant_epilogue}


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        fn.shapes.clear()


def _read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _read_shapes():
    return {name: dict(fn.shapes) for name, fn in _wrappers().items()}


def _fidelity(f, q):
    """(rms / max|f|, correlation) of int8 maps ``q`` against f32 ``f``."""
    import numpy as np

    f, q = f.double().cpu().numpy().ravel(), q.double().cpu().numpy().ravel()
    rms = np.sqrt(((f - q) ** 2).mean()) / np.abs(f).max()
    return float(rms), float(np.corrcoef(f, q)[0, 1])


def run_quantized(f32_det, cfg, frames):
    """Phase 5; returns the launch counts of the quantized fast path, the
    quantized detector and its 368x496 input."""
    import numpy as np
    import torch

    from tpupose_torch import quant as tq
    from tpupose_torch.detectors.pose import PoseDetector, float32_numerics
    from tpupose_torch.ops.resize import resize_u8_linear

    t0 = time.perf_counter()
    det = PoseDetector(cfg=cfg, device="cuda", seed=0)
    det.model.load_state_dict(f32_det.model.state_dict())
    det.quantize([frames[0], frames[0][:, ::-1]])
    if det.conv7_impl != "kernel":
        raise AssertionError(f"quantize() chose {det.conv7_impl!r}")
    det(frames[0])                                   # warm-up
    torch.cuda.synchronize()
    print(f"quantize (calibration on 2 frames) + warm-up: "
          f"{time.perf_counter() - t0:.2f} s")

    # --- the main path, counted ---
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    singles = [det(f) for f in frames]
    batched = det.detect_batch(frames)
    torch.cuda.synchronize()
    counts = _read_counts()
    shapes = _read_shapes()
    forwards = len(frames) + 1
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    print(f"quantized fast path: launches {counts} over {forwards} "
          f"forwards, poses per frame (__call__)="
          f"{[len(p) for p, _ in singles]}, (detect_batch)="
          f"{[len(p) for p, _ in batched]}, peak device memory "
          f"{peak_mib:.1f} MiB")
    if (counts["conv7_s8"] != 50 * forwards
            or counts["conv_s8"] != 30 * forwards
            or counts["requant_epilogue"] != 0
            or counts["blur_nms"] < 2 * len(frames)):
        raise AssertionError(f"quantized fast path launches {counts}")
    if sum(len(p) for p, _ in singles) < 1:
        raise AssertionError("quantized: no pose found in any frame")
    for i, (a, b) in enumerate(zip(singles, batched)):
        if not _same_tables(a, b, score_atol=1e-4):
            raise AssertionError(f"quantized frame {i}: __call__ != "
                                 f"detect_batch")
    check_path_shapes("quantized fast path", cfg, shapes)

    # --- the card's int8 forward vs the CPU's on the same tree ---
    (in_h, in_w), _ = det._geometry(*frames.shape[1:3])
    resized = resize_u8_linear(frames[0], (in_w, in_h))
    x = torch.from_numpy(resized[None]).cuda().float() / 255.0 - 0.5
    cpu_apply = tq.make_quant_apply(
        det.quant_static, tq.qtree_to_device(det.qtree, det.quant_static,
                                             "cpu"))
    with torch.no_grad(), float32_numerics():
        pafs, hms = det._quant_forward(x)
        t0 = time.perf_counter()
        cpafs, chms = cpu_apply(x.cpu())
        cpu_s = time.perf_counter() - t0
        fpafs, fhms = det.model(x)
    for name, got, ref in (("paf", pafs, cpafs), ("heatmap", hms, chms)):
        equal = torch.equal(got.cpu(), ref)
        print(f"int8 {name} maps (6 stages, {tuple(got.shape)}) card vs CPU "
              f"int8 forward: bit_equal={equal} (CPU forward {cpu_s:.2f} s)")
        if not equal:
            raise AssertionError(f"int8 {name} maps: card != CPU")
    for name, f, q in (("paf", fpafs[-1], pafs[-1]),
                       ("heatmap", fhms[-1], hms[-1])):
        rms, corr = _fidelity(f, q)
        print(f"int8 vs f32 last-stage {name} maps: rms/max {rms!r}, "
              f"corr {corr!r}")
        if not corr >= 0.9:
            raise AssertionError(f"int8 {name} maps do not track f32")
    return counts, det, x


def run_precise(f32_det, cfg, frames):
    """Phase 6 on two frames; returns the launch counts over both precise
    detectors, ``(f32 ms, int8 ms)`` per ``__call__`` and the quantized
    precise detector."""
    import numpy as np
    import torch

    from tpupose_torch.detectors.pose import PoseDetector
    from tpupose_torch.utils.calibrate import calibrate_output_convs

    frames = frames[:2]
    orig_hw = frames.shape[1:3]
    totals = {}
    call_ms = []
    weights = None
    for quantized in (False, True):
        label = "int8" if quantized else "f32"
        t0 = time.perf_counter()
        det = PoseDetector(cfg=cfg, device="cuda", seed=0, precise=True)
        if weights is None:
            # recalibrated at the postprocess's 480x640 resolution, where
            # the fast path's gains would overfill the peak table
            det.model.load_state_dict(f32_det.model.state_dict())
            if not calibrate_output_convs(det, frames[0]):
                raise AssertionError("calibration found no output convs")
            weights = det.model.state_dict()
        else:
            det.model.load_state_dict(weights)
        if quantized:
            det.quantize([frames[0], frames[0][:, ::-1]])
        det(frames[0])                               # warm-up
        torch.cuda.synchronize()
        print(f"precise {label}: init + calibration + warm-up "
              f"{time.perf_counter() - t0:.2f} s")

        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        singles = [det(f) for f in frames]
        batched = det.detect_batch(frames)
        torch.cuda.synchronize()
        counts = _read_counts()
        shapes = _read_shapes()
        grids = sorted({key[1:3] for key in shapes["conv7_s8"]})
        blur_shapes = sorted(shapes["blur_nms"])
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        print(f"precise {label}: launches {counts}, conv7 grids {grids}, "
              f"blur_nms shapes {blur_shapes}, poses per frame (__call__)="
              f"{[len(p) for p, _ in singles]}, (detect_batch)="
              f"{[len(p) for p, _ in batched]}, peak device memory "
              f"{peak_mib:.1f} MiB")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        if (18, *orig_hw) not in shapes["blur_nms"]:
            raise AssertionError(f"precise {label}: blur_nms did not run "
                                 f"at (18, {orig_hw})")
        if quantized and not set(PYRAMID_GRIDS) <= set(grids):
            raise AssertionError(f"precise int8: conv7 ran at {grids}, not "
                                 f"at every pyramid grid {PYRAMID_GRIDS}")
        if quantized and not (
                counts["conv_s8"] > 0 and counts["requant_epilogue"] == 0
                and counts["conv_s8"] * 50 == counts["conv7_s8"] * 30):
            raise AssertionError(f"precise int8: launches {counts}, not 30 "
                                 f"conv_s8 and 50 conv7 per forward")
        if sum(len(p) for p, _ in singles) < 1:
            raise AssertionError(f"precise {label}: no pose found")

        # B = 2 against B = 1: equal tables, and maps within a bound.  The
        # int8 forward is exact at any batch, so its maps differ by the map
        # resizes' float32 noise only; the f32 forward's cuDNN picks other
        # algorithms by batch (9.1e-6 seen).
        bound = 3e-4 if not quantized else 1e-5
        paf_b, hm_b, _ = det._batch_maps(frames)
        for i, (a, b) in enumerate(zip(singles, batched)):
            (paf, hm), _ = det.compute_maps(frames[i])
            errs = [(got - ref[i]).abs().max().item() / ref[i].abs().max()
                    .item() for got, ref in ((paf, paf_b), (hm, hm_b))]
            same = _same_tables(a, b, score_atol=1e-4)
            print(f"precise {label} frame {i}: __call__ vs detect_batch "
                  f"maps max_abs_err/max {errs}, tables equal {same}")
            if not (max(errs) <= bound and same):
                raise AssertionError(f"precise {label} frame {i}: "
                                     f"__call__ != detect_batch")
        check_path_shapes(f"precise {label} path", cfg, shapes)
        via_detect_precise = det.detect_precise(frames[0])
        if not all(np.array_equal(a, b) for a, b in zip(via_detect_precise,
                                                          singles[0])):
            raise AssertionError(f"precise {label}: detect_precise != "
                                 f"__call__")
        print(f"precise {label}: detect_precise equals __call__ "
              f"({len(singles[0][0])} poses)")
        if quantized:
            _precise_int8_vs_cpu(det, frames[0])
        call_ms.append(_host_ms(lambda: det(frames[0]), 3))
    return totals, tuple(call_ms), det


def _precise_int8_vs_cpu(det, frame):
    """Per pyramid scale, the card's int8 forward on the scale's canvas
    against the CPU's int8 forward on the same tree and input: every
    stage's maps bit-equal."""
    import torch

    from tpupose_torch import quant as tq
    from tpupose_torch.detectors.pose import float32_numerics

    cpu_apply = tq.make_quant_apply(
        det.quant_static, tq.qtree_to_device(det.qtree, det.quant_static,
                                             "cpu"))
    img = torch.from_numpy(frame[None].copy()).cuda()
    with torch.no_grad(), float32_numerics():
        for scale, scaled_hw, padded_hw in det._pyramid_geometries(
                *frame.shape[:2]):
            x = det._scaled_on_canvas(img, scaled_hw, padded_hw) / 255.0 \
                - 0.5
            pafs, hms = det._quant_forward(x)
            t0 = time.perf_counter()
            cpafs, chms = cpu_apply(x.cpu())
            cpu_s = time.perf_counter() - t0
            equal = (torch.equal(pafs.cpu(), cpafs)
                     and torch.equal(hms.cpu(), chms))
            print(f"precise int8 scale {scale} ({tuple(x.shape[1:3])} "
                  f"canvas, 6 stages of {tuple(pafs.shape[2:4])} maps): card "
                  f"vs CPU int8 forward bit_equal={equal} (CPU forward "
                  f"{cpu_s:.2f} s)")
            if not equal:
                raise AssertionError(f"precise int8 scale {scale}: card != "
                                     f"CPU")


def _profile_forward(forward, x, forwards: int = 3):
    """The device operations of one int8 forward, from ``torch.profiler``'s
    ``key_averages`` over ``forwards`` forwards: ``{name: (device ms,
    launches)}`` per forward, costliest first; fails if the profiler shows
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if getattr(e, name, 0):
                return float(getattr(e, name))
        return 0.0

    forward(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            forward(x)
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e):
            ms, n = ops.get(e.key, (0.0, 0.0))
            ops[e.key] = (ms + dev_us(e) / forwards / 1e3,
                          n + e.count / forwards)
    if not ops:
        raise AssertionError("torch.profiler shows no device time")
    return dict(sorted(ops.items(), key=lambda kv: -kv[1][0]))


def _route_split(label, ops, top: int = 12):
    """Print a route's device split by operation; returns (all kernels'
    ms, launches) per forward."""
    total_ms = sum(ms for ms, _ in ops.values())
    total_n = sum(n for _, n in ops.values())
    print(f"int8 forward, {label} route (torch.profiler, per forward of 3): "
          f"{total_ms!r} ms of kernels in {total_n!r} launches; costliest:")
    for name, (ms, n) in list(ops.items())[:top]:
        print(f"  {ms:9.4f} ms {n:6.1f} x  {name[:100]}")
    return total_ms, total_n


def _kernel_ms(ops, kernel):
    return sum(ms for name, (ms, _) in ops.items() if kernel in name)


def split_int8(qdet, x, frame, precise_ms, conv7_grids, conv_s8_layers):
    """Phase 7: the int8 forward on its kernel route against its im2col
    route (launches counted, CUDA-event times, and each route's device
    split by operation from ``torch.profiler``) and the f32 forward, the
    quantized fast path's ``__call__``, precise f32 vs int8, conv7 per
    pyramid grid and conv_s8 per timed layer, on one line.  Returns the
    launch counts of one im2col-route forward."""
    import torch

    from tpupose_torch import quant as tq
    from tpupose_torch.detectors.pose import float32_numerics

    im2col = tq.make_quant_apply(
        qdet.quant_static, tq.qtree_to_device(qdet.qtree, qdet.quant_static,
                                              "cuda"), "im2col")
    with torch.no_grad(), float32_numerics():
        routes, im2col_shapes = {}, None
        for route, fn in (("kernel", qdet._quant_forward),
                          ("im2col", im2col)):
            _reset_counts()
            fn(x)
            torch.cuda.synchronize()
            routes[route] = _read_counts()
            im2col_shapes = _read_shapes()
    print(f"launches per int8 forward: {routes}")
    if (routes["kernel"]["conv_s8"], routes["kernel"]["conv7_s8"],
            routes["kernel"]["requant_epilogue"]) != (30, 50, 0):
        raise AssertionError(f"kernel route launches {routes['kernel']}")
    # im2col: the 30 layers conv_s8 takes on the kernel route and the 50
    # 7x7 layers each end in requant
    if (routes["im2col"]["conv_s8"], routes["im2col"]["conv7_s8"],
            routes["im2col"]["requant_epilogue"]) != (0, 0, 80):
        raise AssertionError(f"im2col route launches {routes['im2col']}")
    check_path_shapes("int8 forward, im2col route", qdet.cfg, im2col_shapes)
    # The host-clock and CUDA-event timings come before the profiler, which
    # may leave per-launch cost behind.
    call_ms = _host_ms(lambda: qdet(frame), 5)
    with torch.no_grad(), float32_numerics():
        forward_ms = _round_robin_ms({"im2col": lambda: im2col(x),
                                      "kernel": lambda: qdet._quant_forward(
                                          x)}, iters=5)
        f32_ms = _cuda_ms(lambda: qdet.model(x), 5)
        kernel_ops = _profile_forward(qdet._quant_forward, x)
        im2col_ops = _profile_forward(im2col, x)
    device_ms, device_n = _route_split("kernel", kernel_ops)
    im2col_device_ms, im2col_n = _route_split("im2col", im2col_ops)
    conv7_ms = _kernel_ms(kernel_ops, "conv7_s8_kernel")
    conv_s8_ms = _kernel_ms(kernel_ops, "conv_s8_kernel")
    if not (conv7_ms > 0 and conv_s8_ms > 0):
        raise AssertionError("torch.profiler shows no device time for the "
                             "conv7 or conv_s8 kernel")
    split = {
        "int8_forward_kernel_route_ms": forward_ms["kernel"],
        "int8_forward_im2col_route_ms": forward_ms["im2col"],
        "f32_forward_ms": f32_ms,
        "kernel_route_device_ms": device_ms,
        "kernel_route_launches": device_n,
        "conv7_in_int8_forward_ms": conv7_ms,
        "conv_s8_in_int8_forward_ms": conv_s8_ms,
        "im2col_route_device_ms": im2col_device_ms,
        "im2col_route_launches": im2col_n,
        "int8_call_ms": call_ms,
        "precise_call_f32_ms": precise_ms[0],
        "precise_call_int8_ms": precise_ms[1],
    }
    for (h, w), times in sorted(conv7_grids.items()):
        for name, ms in times.items():
            split[f"conv7_{h}x{w}_{name}_ms"] = ms
    for layer, times in conv_s8_layers.items():
        for name, ms in times.items():
            if name != "tiles":
                split[f"conv_s8_{layer}_{name}_ms"] = ms
    print(f"int8 split ({tuple(x.shape[1:3])} input, CUDA events except "
          f"the __call__s on the host clock and the profiler's device "
          f"sums): " + json.dumps({k: round(v, 4) for k, v in split.items()}))
    return routes["im2col"]


# Phase 8: the crop nets.  Boxes (left, top, right, bottom) of the 480x640
# frames that stand in for the cascade's crops when the random pose net
# cuts fewer than 2 faces or 4 hands.
FIXED_FACE_BOXES = ((280, 60, 380, 180), (40, 200, 124, 300))
FIXED_HAND_BOXES = (((100, 300, 180, 380), "left"),
                    ((460, 280, 552, 372), "right"),
                    ((300, 380, 356, 436), "left"),
                    ((520, 40, 640, 160), "right"))
MAX_CASCADE_CROPS = 8       # crops per net taken from the cascade
# conv7's refine-stage groups in the crop nets: FaceNet's and HandNet's
# Mconv1, then Mconv2-5; conv_s8's layers the pose net has not: conv4_3
# (conv4_4, conv5_1, conv5_2 alike) and conv5_3_CPM.
CROP_GRID = (46, 46)         # the crop nets' stage grid at 368x368
CROP_CONV7_GROUPS = ((71, 128), (22, 128), (128,))
CROP_CONV_S8 = {"conv4_3": (512, 512, 3), "conv5_3_CPM": (512, 128, 3)}


def _cpu_twin(det):
    """A crop detector's CPU twin on the same weights, and on the same int8
    tree (im2col route) once quantized."""
    import copy

    import torch

    from tpupose_torch import quant as tq

    twin = copy.copy(det)
    twin.device = torch.device("cpu")
    twin.model = copy.deepcopy(det.model).cpu()
    if det.quantized:
        twin._quant_forward = tq.make_quant_apply(
            det.quant_static, tq.qtree_to_device(det.qtree, det.quant_static,
                                                 "cpu"))
    return twin


def _crop_keypoints_vs_cpu(label, det, crops, flips, rel_tol):
    """``det``'s keypoints on the card against its CPU twin's on the same
    crops; its maps (every stage) within ``rel_tol`` x max|ref| of the
    twin's (0: bit-equal).  A channel whose keypoint differs is excused
    only where its two maxima, or its score and the threshold, lie within
    twice the map tolerance of each other on the twin's blurred map.
    Returns (card keypoints, channels excused)."""
    import torch

    from tpupose_torch.ops.gaussian import gaussian_blur_reflect

    twin = _cpu_twin(det)
    imgs = det.prepare_crops(crops, flips)
    got_maps, ref_maps = det.forward_maps(imgs), twin.forward_maps(imgs)
    hws = [c.shape[:2] for c in crops]
    scale = ref_maps.abs().max().item()
    err = (got_maps.cpu() - ref_maps).abs().max().item()
    print(f"{label}: maps {tuple(ref_maps.shape)} card vs CPU max_abs_err "
          f"{err!r} (max |ref| {scale!r})")
    if not err <= rel_tol * scale:
        raise AssertionError(f"{label}: card and CPU maps disagree")
    # int8 maps are equal; the tails' float32 resizes and blurs still
    # differ by ~1e-7 between the devices
    tol = 2 * max(rel_tol, 1e-5) * scale
    got = det.collect_crops(det.submit_tails(got_maps[-1], hws, flips))
    ref = twin.collect_crops(twin.submit_tails(ref_maps[-1], hws, flips))
    excused = valid = 0
    for i, (g, r) in enumerate(zip(got, ref)):
        target, _ = twin._tail_target(crops[i].shape[:2])
        smoothed = None
        for c, (gk, rk) in enumerate(zip(g, r)):
            valid += rk is not None
            same = (gk is None) == (rk is None) and (
                rk is None or (gk[:2] == rk[:2]
                               and abs(gk[2] - rk[2]) <= tol))
            if same:
                continue
            if smoothed is None:
                with torch.no_grad():
                    smoothed = gaussian_blur_reflect(twin.tail_maps(
                        ref_maps[-1][i], target, flips[i]),
                        twin.cfg.gaussian_sigma)
            plane = smoothed[c]
            best = plane.max().item()
            if gk is not None and rk is not None:
                near = best - plane[gk[1], gk[0]].item() <= tol
            else:
                near = abs(best - twin.cfg.heatmap_peak_thresh) <= tol
            if not near:
                raise AssertionError(f"{label}: crop {i} channel {c}: card "
                                     f"{gk} vs CPU {rk}")
            excused += 1
    print(f"{label}: keypoints card vs CPU equal on {len(crops)} crops "
          f"({valid} valid), {excused} channels excused (two maxima or "
          f"score and threshold within {tol!r})")
    if valid == 0:
        raise AssertionError(f"{label}: no valid keypoint")
    return got, excused


def _crop_sets(frames, cascade_faces, cascade_hands):
    """The crops phase 8 runs: up to MAX_CASCADE_CROPS faces and hands of
    the cascade, topped up from the fixed boxes where it cut fewer than 2
    faces, or fewer than 2 left or 2 right hands."""
    faces = list(cascade_faces[:MAX_CASCADE_CROPS])
    hands = list(cascade_hands[:MAX_CASCADE_CROPS])
    n_face, n_hand = len(faces), len(hands)
    if len(faces) < 2:
        faces += [frames[0][t:b, l:r].copy()
                  for l, t, r, b in FIXED_FACE_BOXES]
    if min(sum(s == side for _, s in hands) for side in ("left",
                                                          "right")) < 2:
        hands += [(frames[1][t:b, l:r].copy(), side)
                  for (l, t, r, b), side in FIXED_HAND_BOXES]
    sizes = [c.shape[:2] for c in faces + [h for h, _ in hands]]
    print(f"crop sets: {len(faces)} faces ({n_face} from the cascade of "
          f"{len(cascade_faces)}, {len(faces) - n_face} from fixed boxes), "
          f"{len(hands)} hands ({n_hand} from the cascade of "
          f"{len(cascade_hands)}, {len(hands) - n_hand} from fixed boxes; "
          f"{sum(s == 'left' for _, s in hands)} left); crop sizes from "
          f"{min(sizes, key=lambda hw: hw[0] * hw[1])} to "
          f"{max(sizes, key=lambda hw: hw[0] * hw[1])}")
    return faces, hands


def run_crop_nets(f32_det, cfg, frames):
    """Phase 8: the face and hand detectors behind the demo cascade, f32
    and int8.  Returns the kernel launches counted over its main path and
    the quantized face detector."""
    import numpy as np
    import torch

    from tpupose_torch.apps.demo import cascade_results
    from tpupose_torch.detectors import FaceDetector, HandDetector
    from tpupose_torch.detectors.crop_keypoints import preprocess_crops_u8
    from tpupose_torch.detectors.pose import float32_numerics
    from tpupose_torch.utils.calibrate import calibrate_crop_output_conv

    t_phase = t0 = time.perf_counter()
    face = FaceDetector(device="cuda", seed=0)
    hand = HandDetector(device="cuda", seed=0)
    calib = [frames[2][t:b, l:r] for l, t, r, b in FIXED_FACE_BOXES]
    calibrate_crop_output_conv(face, calib)
    calibrate_crop_output_conv(hand, calib)
    torch.cuda.synchronize()
    print(f"face + hand detectors: init + output calibration "
          f"{time.perf_counter() - t0:.2f} s")

    # --- the main path, counted: the cascade, then f32 and int8 crops ---
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    cascade_faces, cascade_hands, n_people, seen = [], [], [], []
    t0 = time.perf_counter()
    for f in frames:
        results = cascade_results(f, f32_det, face, hand,
                                  on_crops=lambda *crops: seen.append(crops))
        face_crops, hand_crops = seen[-1]
        n_people.append(len(results["poses"]))
        cascade_faces += face_crops
        cascade_hands += [(crop, side) for crop, (side, _, _) in zip(
            hand_crops, results["hands"])]
    cascade_s = time.perf_counter() - t0
    faces, hands = _crop_sets(frames, cascade_faces, cascade_hands)
    hand_imgs = [c for c, _ in hands]
    sides = [s for _, s in hands]
    f32_face = face.detect_batch(faces)
    f32_hand = hand.detect_batch(hand_imgs, sides)
    face.quantize([c for f in faces[:4] for c in (f, f[:, ::-1])])
    hand.quantize([c for h in hand_imgs[:4] for c in (h, h[:, ::-1])])
    if (face.conv7_impl, hand.conv7_impl) != ("kernel", "kernel"):
        raise AssertionError("crop quantize() did not take the kernel route")
    before = _read_counts()
    int8_face = face.detect_batch(faces)
    after_face = _read_counts()
    int8_hand = hand.detect_batch(hand_imgs, sides)
    torch.cuda.synchronize()
    counts = _read_counts()
    shapes = _read_shapes()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    per_face = {k: after_face[k] - before[k] for k in counts}
    per_hand = {k: counts[k] - after_face[k] for k in counts}
    print(f"crop path: cascade on {len(frames)} frames {cascade_s:.2f} s, "
          f"people {n_people}; launches {counts}; one int8 face forward "
          f"{per_face}, one int8 hand forward {per_hand}; conv7 shapes "
          f"{sorted(shapes['conv7_s8'])}; peak device memory "
          f"{peak_mib:.1f} MiB")
    for label, per in (("face", per_face), ("hand", per_hand)):
        if (per["conv7_s8"], per["conv_s8"], per["requant_epilogue"]) != (
                25, 21, 0):
            raise AssertionError(f"int8 {label} forward launches {per}, not "
                                 f"25 conv7 and 21 conv_s8")
    if counts["blur_nms"] < len(frames):
        raise AssertionError(f"the cascade's pose steps launched blur_nms "
                             f"{counts['blur_nms']} times")
    groups = {key[3] for key in shapes["conv7_s8"]}
    if not {(71, 128), (22, 128), (128,)} <= groups:
        raise AssertionError(f"conv7 ran at groups {groups}")
    for label, kps, n in (("f32 face", f32_face, 71), ("int8 face",
                                                        int8_face, 71),
                          ("f32 hand", f32_hand, 22),
                          ("int8 hand", int8_hand, 22)):
        if len(kps) != (len(faces) if "face" in label else len(hands)) or \
                any(len(k) != n - 1 for k in kps):
            raise AssertionError(f"{label}: keypoint lists malformed")
    check_path_shapes("crop path", cfg, shapes)

    # --- card vs CPU on the fixed boxes' 2 faces and a left and a right
    # hand: face-sized crops (the random poses cut crops of 550-1700 px,
    # whose tails take the CPU seconds each) ---
    sub_faces = [frames[0][t:b, l:r].copy() for l, t, r, b in
                 FIXED_FACE_BOXES]
    sub_hands = [(frames[1][t:b, l:r].copy(), side)
                 for (l, t, r, b), side in FIXED_HAND_BOXES[:2]]
    t_cpu = time.perf_counter()
    sub_flips = [s == "left" for _, s in sub_hands]
    sub_hand_imgs = [c for c, _ in sub_hands]
    excused = 0
    for quantized in (True, False):
        for det, crops, flips in ((face, sub_faces, [False] * 2),
                                  (hand, sub_hand_imgs, sub_flips)):
            name = f"{'int8' if quantized else 'f32'} {det.arch}"
            if quantized:
                _, n = _crop_keypoints_vs_cpu(name, det, crops, flips, 0.0)
            else:
                f32 = _f32_view(det)
                _, n = _crop_keypoints_vs_cpu(name, f32, crops, flips, 1e-4)
            excused += n
    t_cpu = time.perf_counter() - t_cpu

    # --- where the time goes ---
    eight = (faces * 8)[:8]
    with torch.no_grad(), float32_numerics():
        split = {}
        for det, name in ((face, "facenet"), (hand, "handnet")):
            for b in (1, 8):
                x = preprocess_crops_u8(torch.from_numpy(
                    det.prepare_crops(eight[:b], [False] * b)).cuda())
                split[f"{name}_f32_forward_B{b}_ms"] = _cuda_ms(
                    lambda: det.model(x), 5)
                split[f"{name}_int8_forward_B{b}_ms"] = _cuda_ms(
                    lambda: det._quant_forward(x), 5)
    split["face_host_resize_ms_per_crop"] = _host_ms(
        lambda: face.prepare_crops(faces, [False] * len(faces)), 2) / len(
            faces)
    split["hand_host_resize_ms_per_crop"] = _host_ms(
        lambda: hand.prepare_crops(hand_imgs, [s == "left" for s in sides]),
        2) / len(hands)
    split["face_int8_detect_batch_ms_per_crop"] = _host_ms(
        lambda: face.detect_batch(faces), 2) / len(faces)
    split["hand_int8_detect_batch_ms_per_crop"] = _host_ms(
        lambda: hand.detect_batch(hand_imgs, sides), 2) / len(hands)
    f32_face_det, f32_hand_det = _f32_view(face), _f32_view(hand)
    split["face_f32_detect_batch_ms_per_crop"] = _host_ms(
        lambda: f32_face_det.detect_batch(faces), 2) / len(faces)
    split["hand_f32_detect_batch_ms_per_crop"] = _host_ms(
        lambda: f32_hand_det.detect_batch(hand_imgs, sides), 2) / len(hands)
    print(f"crop nets ({len(faces)} faces, {len(hands)} hands; forwards by "
          f"CUDA events on 368x368 crops, detect_batch on the host clock, "
          f"median of 2): "
          + json.dumps({k: round(v, 4) for k, v in split.items()}))
    print(f"crop nets: {excused} keypoint channels excused in all; card vs "
          f"CPU checks {t_cpu:.2f} s, phase 8 so far "
          f"{time.perf_counter() - t_phase:.2f} s")
    return counts, face


def _f32_view(det):
    """A quantized crop detector's float32 twin on the card: the same
    object with the int8 forward set aside."""
    import copy

    view = copy.copy(det)
    view._quant_forward = None
    view.quantized = False
    return view


def check_crop_kernels(cfg):
    """Phase 8, kernels: conv7 at the crop nets' groups and conv_s8 at
    their new layers, B = 1 and 8, every tile, bit-equal; blur_nms at
    sigma 5 and 8 (radius 20 and 32, the run-time-tap kernel) bit-equal,
    and its radius-20 time beside radius 10's; greedy_match's planted ties
    on the card against the CPU.  Prints conv7's times at the new groups."""
    import numpy as np
    import torch

    from tpupose_torch.ops import blur_nms as bn
    from tpupose_torch.ops import conv7 as c7
    from tpupose_torch.ops import conv_s8 as cs
    from tpupose_torch.ops.paf import greedy_match

    rng = np.random.RandomState(3)
    h, w = CROP_GRID
    for b in (1, 8):
        for channels in CROP_CONV7_GROUPS:
            parts, kernels, mults, bias = _conv7_case(rng, b, h, w,
                                                      channels)
            packed = [c7.pack_conv7_weights(k) for k in kernels]
            ref = c7.conv7_s8_reference(parts, kernels, mults, bias)
            tiles = {}
            for tile in range(len(c7.TILE_ROWS)):
                got = c7.conv7_s8(parts, kernels, mults, bias, packed=packed,
                                  tile=tile)
                if not torch.equal(got, ref):
                    raise AssertionError(f"conv7_s8 disagrees at {(b, h, w)} "
                                         f"groups {channels} tile {tile}")
                tiles[tile] = lambda tile=tile: c7.conv7_s8(
                    parts, kernels, mults, bias, packed=packed, tile=tile)
            pick = c7.pick_tile(b, h, w, 128)
            if channels == (128,):
                print(f"conv7_s8 {(b, h, w)} groups {channels}: bit_equal="
                      f"True at every tile")
                continue
            bound, bound_by = conv7_bound(b, h, w, channels, 128)
            cat = torch.cat(parts, dim=-1)
            patches = _patch_matrix(cat, 7)
            wmat = torch.nn.functional.pad(
                torch.cat(kernels, dim=2).reshape(-1, 128),
                (0, 0, 0, patches.shape[1] - 49 * cat.shape[-1])).contiguous()
            times = _round_robin_ms(
                {"plain": lambda: c7.conv7_s8_reference(parts, kernels,
                                                        mults, bias),
                 "kernel": tiles[pick],
                 "int_mm": lambda: torch._int_mm(patches, wmat)},
                iters=10, timer=_graph_ms)
            print(f"conv7_s8 {(b, h, w)} groups {channels}: bit_equal=True "
                  f"at every tile (picks {c7.TILE_ROWS[pick]} rows); "
                  + ", ".join(f"{k} {v!r} ms" for k, v in times.items())
                  + f", bound {bound!r} ms ({bound_by}) (CUDA-graph replays "
                  f"of 10 calls, in turns)")
    for name, (c, o, k) in CROP_CONV_S8.items():
        for b in (1, 8):
            x, kq, mult, bias = _conv_s8_case(rng, b, h, w, c, o, k)
            ref = cs.conv_s8_reference(x, kq, mult, bias)
            for tile, (_, _, tile_n) in enumerate(cs.TILES):
                if o % tile_n:
                    continue
                if not torch.equal(cs.conv_s8(x, kq, mult, bias, tile=tile),
                                   ref):
                    raise AssertionError(f"conv_s8 disagrees at {name} B={b} "
                                         f"tile {cs.TILES[tile]}")
            pick = cs.pick_tile(b, h, w, c, o, k)
            packed = cs.pack_conv_s8_weights(kq)
            patches = _patch_matrix(x, k)
            wmat = torch.nn.functional.pad(
                kq.reshape(k * k * c, o),
                (0, 0, 0, patches.shape[1] - k * k * c)).contiguous()
            times = _round_robin_ms(
                {"plain": lambda: cs.conv_s8_reference(x, kq, mult, bias),
                 "kernel": lambda: cs.conv_s8(x, kq, mult, bias,
                                              packed=packed, tile=pick),
                 "int_mm": lambda: torch._int_mm(patches, wmat)},
                iters=10, timer=_graph_ms)
            bound, bound_by = conv_s8_bound(b, h, w, c, o, k)
            print(f"conv_s8 {name} {(b, h, w)} {c} -> {o} {k}x{k}: "
                  f"bit_equal=True at every tile (picks {cs.TILES[pick]}); "
                  + ", ".join(f"{n} {v!r} ms" for n, v in times.items())
                  + f", bound {bound!r} ms ({bound_by}) (CUDA-graph replays "
                  f"of 10 calls, in turns)")

    shape = (18, 320, 432)
    x = torch.from_numpy(_planted(rng, *shape)).cuda()
    for sigma in (5.0, 8.0):
        s, m = bn.blur_nms(x, sigma, cfg.heatmap_peak_thresh)
        rs, rm = bn.blur_nms_reference(x, sigma, cfg.heatmap_peak_thresh)
        if not (torch.equal(s, rs) and torch.equal(m, rm)):
            raise AssertionError(f"blur_nms disagrees at sigma {sigma}")
        print(f"blur_nms {shape} sigma {sigma} (radius "
              f"{bn._taps(sigma)[1]}): bit_equal=True, mask_equal=True, "
              f"peaks={int(rm.sum())}")
    times = _round_robin_ms(
        {f"radius {bn._taps(sg)[1]}": (
            lambda sg=sg: bn.blur_nms(x, sg, cfg.heatmap_peak_thresh))
         for sg in (2.5, 5.0)}, iters=20, timer=_graph_ms)
    floors = blur_nms_floors(*shape, taps=41)
    print(f"blur_nms {shape}: " + ", ".join(f"{k} {v!r} ms"
                                            for k, v in times.items())
          + " (CUDA-graph replays of 20 calls, in turns; radius 20 takes "
          f"the run-time-tap kernel); radius 20's floors: bytes "
          f"{floors['bytes']!r} ms, operations {floors['operations']!r} ms")

    # greedy_match's planted ties (tests/test_torch_ops.py)
    rng = np.random.RandomState(0)
    n_limbs, k = 24, 8
    score = rng.randint(0, 4, (n_limbs, k, k)).astype(np.float32) / 4.0
    n_a = rng.randint(0, k + 1, n_limbs)
    n_b = rng.randint(0, k + 1, n_limbs)
    valid = rng.rand(n_limbs, k, k) < rng.uniform(0.2, 0.9, (n_limbs, 1, 1))
    for limb in range(n_limbs):
        valid[limb, n_a[limb]:, :] = False
        valid[limb, :, n_b[limb]:] = False
    args = [torch.from_numpy(a) for a in (score, valid, n_a, n_b)]
    ref = greedy_match(*args)
    got = greedy_match(*[a.cuda() for a in args])
    if not all(torch.equal(g.cpu(), r) for g, r in zip(got, ref)):
        raise AssertionError("greedy_match's planted ties: card != CPU")
    print(f"greedy_match planted ties ({n_limbs} limbs, {k} slots): card "
          f"equals CPU, {int(ref[3].sum())} pairs")


def check_tiny_frames(cfg, frames):
    """1x1, 16x9 and 9x16 frames give (0, 18, 3) tables on the fast,
    precise and int8 paths, through ``__call__`` and ``detect_batch``,
    from seeded weights left uncalibrated (a calibrated random net's maps
    may carry peaks even on a black frame)."""
    import copy

    import numpy as np

    from tpupose_torch.detectors.pose import PoseDetector

    fast = PoseDetector(cfg=cfg, device="cuda", seed=5)
    precise = copy.copy(fast)       # the same weights, the precise pyramid
    precise.precise = True
    checked = 0
    for label, det in (("fast", fast), ("precise", precise), ("int8", fast)):
        if label == "int8":
            fast.quantize([frames[0]])
        for shape in ((1, 1, 3), (16, 9, 3), (9, 16, 3)):
            frame = np.zeros(shape, np.uint8)
            for poses, scores in (det(frame),
                                  det.detect_batch(frame[None])[0]):
                if poses.shape != (0, 18, 3) or scores.shape != (0,):
                    raise AssertionError(f"{label} {shape}: table "
                                         f"{poses.shape}")
                checked += 1
    print(f"tiny frames (1x1, 16x9, 9x16): {checked} tables of (0, 18, 3) "
          f"on the fast, precise and int8 paths, __call__ and detect_batch")


# --- phase 9: the serving path --------------------------------------------

SERVE_OTHER_HW = (360, 480)      # the concurrency check's second frame size
BUCKET_SIZES = ((375, 500), (426, 640), (480, 480))   # off canvas_palette


class _Served:
    """HTTP servers (``apps/serve.py::make_server`` on port 0), each in a
    thread; ``close()`` stops them all."""

    def __init__(self):
        self.servers = []

    def start(self, detector, **kw):
        import threading

        from tpupose_torch.apps.serve import make_server

        server = make_server(detector, port=0, **kw)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        self.servers.append((server, thread))
        host, port = server.server_address[:2]
        return f"http://{host}:{port}"

    def close(self):
        for server, thread in self.servers:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        self.servers = []


def _clients(url, frames, clients: int = 4):
    """``clients`` threads, each POSTing its share of ``frames`` in turn;
    returns (replies in frame order, wall seconds)."""
    import threading

    from tpupose_torch.apps.serve import detect_over_http

    replies = [None] * len(frames)
    errors = []

    def run(k):
        try:
            for i in range(k, len(frames), clients):
                replies[i] = detect_over_http(url, frames[i])
        except Exception as e:       # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(r is None for r in replies):
        raise AssertionError(f"concurrent clients failed: {errors[:1]}")
    return replies, wall


def _http_vs_call(label, url, det, frame, numbers, iters: int = 10):
    """Median host ms of one request over HTTP and of the same detector's
    in-process ``__call__``, in turns."""
    from tpupose_torch.apps.serve import detect_over_http

    http, call = [], []
    detect_over_http(url, frame)
    det(frame)
    for _ in range(iters):
        t0 = time.perf_counter()
        detect_over_http(url, frame)
        http.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        det(frame)
        call.append((time.perf_counter() - t0) * 1e3)
    numbers[f"{label}_http_ms"] = statistics.median(http)
    numbers[f"{label}_call_ms"] = statistics.median(call)


def _rps(label, url, frames, numbers, requests: int = 16):
    _, wall = _clients(url, [frames[i % len(frames)]
                             for i in range(requests)])
    numbers[f"{label}_rps_4_clients"] = requests / wall


def _serve_live(label, served, det, cfg, frames, other, numbers, per_call):
    """A live detector behind the server: /v1/detect and /v1/detect_batch
    equal in-process results, 4 concurrent clients over two frame sizes
    equal sequential replies; ``per_call``: the kernel launches one
    request must add.  Returns the launches of its counted run."""
    from tpupose_torch.apps.serve import (detect_batch_over_http,
                                          detect_over_http)

    url = served.start(det)
    mixed = [frames[0], other[0], frames[1], other[1]]
    want = [det(f) for f in mixed]                   # warms both sizes
    batch_ref = det.detect_batch(frames)
    _reset_counts()
    singles = [detect_over_http(url, f) for f in frames]
    counts = _read_counts()
    shapes = _read_shapes()
    batched = detect_batch_over_http(url, frames)
    replies, _ = _clients(url, mixed)
    totals = _read_counts()
    for i, f in enumerate(frames):
        if not _same_tables(singles[i], det(f), 0.0):
            raise AssertionError(f"{label} server: /v1/detect frame {i} != "
                                 f"__call__")
    if not all(_same_tables(g, r, 0.0) for g, r in zip(batched, batch_ref)):
        raise AssertionError(f"{label} server: /v1/detect_batch != "
                             f"detect_batch")
    if not all(_same_tables(g, r, 0.0) for g, r in zip(replies, want)):
        raise AssertionError(f"{label} server: concurrent replies != "
                             f"sequential")
    grown = {k: counts[k] for k in ("conv7_s8", "conv_s8", "blur_nms")}
    expect = {k: v * len(frames) for k, v in per_call.items()}
    if grown != expect:
        raise AssertionError(f"{label} server: {len(frames)} requests "
                             f"launched {grown}, not {expect}")
    check_path_shapes(f"{label} server", cfg, shapes)
    _http_vs_call(f"live_{label}", url, det, frames[0], numbers)
    _rps(f"live_{label}", url, mixed, numbers)
    print(f"{label} server: /v1/detect x{len(frames)} and /v1/detect_batch "
          f"B = {len(frames)} equal in-process (poses "
          f"{[len(p) for p, _ in singles]}), 4 clients over "
          f"{frames.shape[1:3]} and {other.shape[1:3]} equal sequential; "
          f"launches per request {per_call}")
    return totals


def _serve_bucketed(served, f32_det, cfg, numbers):
    """``--geometry bucket`` semantics over the f32 detector: the palette's
    off-canvas sizes over HTTP equal in-process bucketing, and a batch of
    same-size frames calls the wrapped ``detect_batch`` once."""
    import numpy as np

    from tpupose_torch.apps.serve import (detect_batch_over_http,
                                          detect_over_http)
    from tpupose_torch.detectors.bucketed import (BucketedPoseDetector,
                                                  canvas_palette)

    rng = np.random.RandomState(9)
    frames = [rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
              for hw in BUCKET_SIZES]
    bdet = BucketedPoseDetector(f32_det, canvases=canvas_palette(640))
    want = [bdet(f) for f in frames]
    url = served.start(bdet)
    _reset_counts()
    got = [detect_over_http(url, f) for f in frames]
    counts = _read_counts()
    shapes = _read_shapes()
    for hw, g, w in zip(BUCKET_SIZES, got, want):
        if not _same_tables(g, w, 0.0):
            raise AssertionError(f"bucketed {hw}: HTTP != in-process")
    calls = []
    live = f32_det.detect_batch

    def counted(imgs):
        calls.append(np.asarray(imgs).shape)
        return live(imgs)

    f32_det.detect_batch = counted
    try:
        same = [frames[0]] * 3
        batch_ref = bdet.detect_batch(same)
        batched = detect_batch_over_http(url, same)
    finally:
        del f32_det.detect_batch
    if calls != [(3, 480, 640, 3)] * 2:
        raise AssertionError(f"bucketed detect_batch called the wrapped "
                             f"detect_batch as {calls}")
    if not all(_same_tables(g, r, 0.0) for g, r in zip(batched, batch_ref)):
        raise AssertionError("bucketed /v1/detect_batch != detect_batch")
    check_path_shapes("bucketed server", cfg, shapes)
    print(f"bucketed server (canvas_palette(640)): {list(BUCKET_SIZES)} on "
          f"canvases {[bdet._place(f)[0].shape[:2] for f in frames]} equal "
          f"in-process, poses {[len(p) for p, _ in got]}; a batch of 3 "
          f"same-size frames: one wrapped detect_batch {calls[0]}")
    return counts


def _serve_bundle(label, served, det, path, frames, numbers, per_call,
                  timed):
    """Export ``det`` (480x640, B = 2, CUDA), load it, serve it: tables and
    batched results equal the live detector's, every kernel re-checked at
    the shapes the bundle gave it.  Returns the counted launches."""
    from tpupose_torch.apps.serve import (detect_batch_over_http,
                                          detect_over_http)
    from tpupose_torch.serving import ServingPoseDetector, save_bundle

    t0 = time.perf_counter()
    save_bundle(det, path, [tuple(frames.shape[1:3])], platforms=("cuda",),
                batch_sizes=(2,))
    t1 = time.perf_counter()
    srv = ServingPoseDetector(path)
    t2 = time.perf_counter()
    numbers[f"bundle_{label}_export_s"] = t1 - t0
    numbers[f"bundle_{label}_load_s"] = t2 - t1
    url = served.start(srv)
    want = [det(f) for f in frames[:2]]
    batch_ref = det.detect_batch(frames[:2])
    detect_over_http(url, frames[0])                    # first sight
    _reset_counts()
    got = [detect_over_http(url, f) for f in frames[:2]]
    counts = _read_counts()
    shapes = _read_shapes()
    batched = detect_batch_over_http(url, frames[:2])
    totals = _read_counts()
    for i, (g, w) in enumerate(zip(got, want)):
        if not _same_tables(g, w, 0.0):
            raise AssertionError(f"bundle {label} frame {i}: tables != the "
                                 f"live detector's")
    if not all(_same_tables(g, r, 0.0) for g, r in zip(batched, batch_ref)):
        raise AssertionError(f"bundle {label}: detect_batch != the live "
                             f"detector's")
    grown = {k: counts[k] for k in per_call}
    expect = {k: v * 2 for k, v in per_call.items()}
    if grown != expect:
        raise AssertionError(f"bundle {label}: 2 requests launched {grown}, "
                             f"not {expect}")
    check_path_shapes(f"bundle {label}", det.cfg, shapes)
    if timed:
        _http_vs_call(f"bundle_{label}", url, srv, frames[0], numbers)
        _rps(f"bundle_{label}", url, frames, numbers)
    print(f"bundle {label}: export {t1 - t0:.2f} s, load {t2 - t1:.2f} s, "
          f"{len(os.listdir(path))} files; over HTTP tables equal the live "
          f"detector's (poses {[len(p) for p, _ in got]}), B = 2 equal its "
          f"detect_batch; launches per request {per_call}")
    return totals


def _serve_crop_bundle(face, path, cfg, frames, numbers):
    """An int8 FaceNet crop bundle at one crop size: keypoints over HTTP
    and in-process equal the live crop detector's."""
    from tpupose_torch.apps.serve import detect_crops_over_http
    from tpupose_torch.serving import ServingCropDetector, save_crop_bundle

    l, t, r, b = FIXED_FACE_BOXES[0]
    crops = [f[t:b, l:r].copy() for f in frames[:2]]
    t0 = time.perf_counter()
    save_crop_bundle(face, path, [crops[0].shape[:2]], batch_sizes=(1, 2),
                     flips=(False,), platforms=("cuda",))
    t1 = time.perf_counter()
    srv = ServingCropDetector(path)
    t2 = time.perf_counter()
    numbers["crop_bundle_int8_export_s"] = t1 - t0
    numbers["crop_bundle_int8_load_s"] = t2 - t1
    want = face.detect_crops(crops)
    served = _Served()
    try:
        url = served.start(srv)
        _reset_counts()
        got = detect_crops_over_http(url, crops)
        counts = _read_counts()
        shapes = _read_shapes()
    finally:
        served.close()
    if got != want or srv.detect_crops(crops) != want:
        raise AssertionError("int8 face crop bundle: keypoints != the live "
                             "crop detector's")
    if (counts["conv7_s8"], counts["conv_s8"]) != (25, 21):
        raise AssertionError(f"int8 face crop bundle launched {counts}")
    check_path_shapes("crop bundle", cfg, shapes)
    print(f"int8 face crop bundle {crops[0].shape[:2]}: export "
          f"{t1 - t0:.2f} s, load {t2 - t1:.2f} s; keypoints over HTTP "
          f"equal the live detector's "
          f"({sum(k is not None for row in got for k in row)} found)")
    return counts


def run_serving(f32_det, qdet, pdet, face, cfg, frames, smi):
    """Phase 9: ``apps/serve.py`` over the live f32 and int8 detectors and
    over bucketing, then ``torch.export`` bundles (fast f32, fast int8,
    precise int8, an int8 face crop bundle) served over HTTP.  Returns the
    kernel launches of its counted runs."""
    import numpy as np
    import shutil
    import tempfile

    from tpupose_torch.ops import _cuda_build

    t_phase = time.perf_counter()
    numbers = {}
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    rng = np.random.RandomState(5)
    other = rng.randint(0, 256, (2, *SERVE_OTHER_HW, 3)).astype(np.uint8)
    os.makedirs(_cuda_build.BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="bundles-", dir=_cuda_build.BUILD_DIR)
    served = _Served()
    int8_call = {"conv7_s8": 50, "conv_s8": 30, "blur_nms": 1}
    f32_call = {"conv7_s8": 0, "conv_s8": 0, "blur_nms": 1}
    try:
        add(_serve_live("f32", served, f32_det, cfg, frames, other, numbers,
                        f32_call))
        add(_serve_live("int8", served, qdet, cfg, frames, other, numbers,
                        int8_call))
        add(_serve_bucketed(served, f32_det, cfg, numbers))
        served.close()
        for label, det, per_call, timed in (
                ("f32", f32_det, f32_call, True),
                ("int8", qdet, int8_call, True),
                ("precise_int8", pdet, {"conv7_s8": 200, "conv_s8": 120,
                                        "blur_nms": 1}, False)):
            add(_serve_bundle(label, served, det, os.path.join(root, label),
                              frames, numbers, per_call, timed))
            served.close()
        add(_serve_crop_bundle(face, os.path.join(root, "face"), cfg,
                               frames, numbers))
    finally:
        served.close()
        shutil.rmtree(root, ignore_errors=True)
    numbers["phase9_s"] = time.perf_counter() - t_phase
    print(f"phase 9 serving numbers ({smi}; host clock, medians of 10; "
          f"rps: 16 requests from 4 client threads): "
          + json.dumps({k: round(v, 4) for k, v in numbers.items()}))
    return totals


TRAIN_INSIZE = 368       # the reference trainer's crop
TRAIN_BATCH = 10         # and batch
TRAIN_TIMED = 10         # timed steps after 2 warm-up steps
TRAIN_FALL_STEPS = 20    # steps on one fixed batch that must lower the loss
CROP_FALL_STEPS = 10     # the same for FaceNet and HandNet
LOADER_BATCHES = 6       # batches timed per loader setting


def _conv_flops(model, insize):
    """Forward multiply-adds x 2 of every conv of ``model`` on one
    ``insize``-square image, from the shapes (a meta-device forward)."""
    import torch

    total = []

    def hook(m, _, out):
        total.append(2 * m.kernel_size[0] * m.kernel_size[1]
                     * m.in_channels * m.out_channels
                     * out.shape[-2] * out.shape[-1])

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model.to("meta")(torch.zeros(1, insize, insize, 3,
                                         device="meta"))
    finally:
        for h in handles:
            h.remove()
    return sum(total)


def _train_state(arch, dtype, cfg, seed=0, device="cuda"):
    from tpupose_torch.models import ARCHS
    from tpupose_torch.train import trainer as ttr

    return ttr.init_train_state(ARCHS[arch](seed=seed, dtype=dtype), cfg,
                                arch=arch, device=device)


def _synthetic_batches(k, insize, batch, n, seed=0, pin=True):
    from tpupose_torch.data import BatchLoader, SyntheticCropDataset

    ds = SyntheticCropDataset(k, insize=insize, n_samples=batch * n,
                              seed=seed)
    return list(BatchLoader(ds, batch, max_persons=1, shuffle=False,
                            repeat=False, pin_memory=pin))


def _run_steps(state, step, batches, timed_from=None):
    """Take a step per batch; returns (losses, per-step CUDA-event ms of
    the steps from ``timed_from`` on)."""
    import torch

    losses, events = [], []
    for i, batch in enumerate(batches):
        timed = timed_from is not None and i >= timed_from
        if timed:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        state, metrics = step(state, batch)
        if timed:
            e1.record()
            events.append((e0, e1))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    return ([float(v) for v in torch.stack(losses).cpu()],
            [a.elapsed_time(b) for a, b in events])


def _check_finite(label, losses):
    import math

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite losses {losses}")


def _check_falls(label, losses):
    _check_finite(label, losses)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall on a fixed "
                             f"batch: {losses[0]} -> {losses[-1]}")


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _check_grads(label, got, ref, rel):
    """Each leaf of ``got`` within ``rel`` x max |ref leaf| of ``ref``;
    returns the worst ratio of error to max |g|."""
    worst = 0.0
    for name, r in ref.items():
        g = got[name].to(r.device)
        scale = r.abs().max().item()
        err = (g - r).abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        if err > rel * scale:
            raise AssertionError(f"{label}: {name} gradient off by {err} > "
                                 f"{rel} x {scale}")
    return worst


def _full_width_steps(cfg, batches, numbers):
    """Phase 10 step 1: CocoPoseNet (6 stages, 368, B = 10) in f32 and
    bf16: 2 warm-up and 10 timed steps under the default stem freeze (the
    10 frozen layers must not move), then 20 steps of a fresh state on one
    fixed batch without the freeze (the loss must fall)."""
    import dataclasses
    import statistics

    import torch

    from tpupose_torch.models import CocoPoseNet
    from tpupose_torch.train import trainer as ttr
    from tpupose_torch.train.optimizer import FREEZE_LAYERS

    fwd = _conv_flops(CocoPoseNet(), TRAIN_INSIZE)
    numbers["forward_gflop_per_image"] = fwd / 1e9
    step = ttr.make_train_step(cfg)
    unfrozen = dataclasses.replace(cfg, stem_freeze_steps=0)
    fall = ttr.make_train_step(unfrozen)
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        state = _train_state("posenet", dtype, cfg)
        frozen = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()
                  if n.split(".")[1] in FREEZE_LAYERS
                  and n.startswith("stem.")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, _ = _run_steps(state, step, batches[:2])  # warm-up
        t0 = time.perf_counter()
        timed, ms = _run_steps(state, step, batches[2:], timed_from=0)
        wall = (time.perf_counter() - t0) / len(ms)
        losses += timed
        numbers[f"{label}_peak_mib"] = (torch.cuda.max_memory_allocated()
                                        / 2 ** 20)
        _check_finite(label, losses)
        moved = [n for n, p in state.model.named_parameters()
                 if n in frozen and not torch.equal(p, frozen[n])]
        if len(frozen) != 2 * len(FREEZE_LAYERS) or moved:
            raise AssertionError(f"{label}: frozen stem moved: {moved}")
        numbers[f"{label}_step_ms_median"] = statistics.median(ms)
        numbers[f"{label}_step_ms_min"] = min(ms)
        numbers[f"{label}_step_ms_max"] = max(ms)
        numbers[f"{label}_images_per_s"] = (
            1000.0 * TRAIN_BATCH / statistics.median(ms))
        # a step is a forward and a backward of ~2 forwards' work
        numbers[f"{label}_tflop_per_s"] = (
            3 * fwd * TRAIN_BATCH / statistics.median(ms) / 1e9)
        numbers[f"{label}_host_ms_per_step"] = 1000.0 * wall
        print(f"posenet {label} {TRAIN_INSIZE} B={TRAIN_BATCH}: step ms "
              f"{[round(v, 2) for v in ms]}, losses {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, stem frozen bit-unchanged over "
              f"{len(batches)} steps, peak "
              f"{numbers[f'{label}_peak_mib']:.1f} MiB")
        del state
        state = _train_state("posenet", dtype, unfrozen, seed=1)
        losses, _ = _run_steps(state, fall, batches[:1] * TRAIN_FALL_STEPS)
        _check_falls(f"posenet {label}", losses)
        print(f"posenet {label}: {TRAIN_FALL_STEPS} steps on one batch, "
              f"no freeze: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
        del state
        torch.cuda.empty_cache()


def _crop_net_steps(cfg):
    """FaceNet and HandNet at 368, B = 10, f32: finite losses that fall
    on a fixed batch."""
    import torch

    from tpupose_torch.train import trainer as ttr

    step = ttr.make_train_step(cfg)
    for arch, k in (("facenet", 70), ("handnet", 21)):
        batch = _synthetic_batches(k, TRAIN_INSIZE, TRAIN_BATCH, 1)[0]
        state = _train_state(arch, torch.float32, cfg)
        losses, ms = _run_steps(state, step, [batch] * CROP_FALL_STEPS,
                                timed_from=2)
        _check_falls(arch, losses)
        print(f"{arch} f32 {TRAIN_INSIZE} B={TRAIN_BATCH}: {CROP_FALL_STEPS} "
              f"steps on "
              f"one batch, loss {losses[0]:.5f} -> {losses[-1]:.5f}, step "
              f"ms median {sorted(ms)[len(ms) // 2]:.2f}")
        del state
        torch.cuda.empty_cache()


def _card_vs_cpu(cfg):
    """Phase 10 step 2: the full 6-stage net at insize 64, B = 2, from one
    seeded parameter set and one batch, on the card and on the CPU: GT
    maps within atol 1e-5, loss rtol 1e-4, gradients 1e-3 x max |g|."""
    import dataclasses

    import torch

    from tpupose_torch.train import trainer as ttr

    cfg = dataclasses.replace(cfg, insize=64, stem_freeze_steps=0)
    batch = _synthetic_batches(18, 64, 2, 1, seed=3, pin=False)[0]
    out = {}
    for device in ("cuda", "cpu"):
        state = _train_state("posenet", torch.float32, cfg, seed=2,
                             device=device)
        b = batch.to(device)
        pafs, heat = ttr.render_batch_labels(b, cfg, out_hw=(8, 8))
        total, _ = ttr.loss_for_batch(state.model, b, cfg)
        total.backward()
        out[device] = (pafs.cpu(), heat.cpu(), total.item(),
                       _grads(state.model))
    gt_err = max((out["cuda"][i] - out["cpu"][i]).abs().max().item()
                 for i in (0, 1))
    if gt_err > 1e-5:
        raise AssertionError(f"GT maps card vs CPU off by {gt_err}")
    loss_rel = abs(out["cuda"][2] / out["cpu"][2] - 1)
    if loss_rel > 1e-4:
        raise AssertionError(f"loss card vs CPU off by rel {loss_rel}")
    worst = _check_grads("card vs CPU", out["cuda"][3], out["cpu"][3], 1e-3)
    print(f"card vs CPU (posenet, 6 stages, 64, B=2): GT max_abs_err "
          f"{gt_err:.3g}, loss rel err {loss_rel:.3g}, worst gradient "
          f"leaf err / max|g| {worst:.3g}")


def _remat(cfg, batch, numbers):
    """Phase 10 step 3: gradients with ``remat`` equal those without,
    within 1e-6 x max |g|, at 368, B = 10, f32; both peak memories."""
    import dataclasses

    import torch

    from tpupose_torch.train import trainer as ttr

    state = _train_state("posenet", torch.float32, cfg, seed=4)
    batch = batch.to("cuda")
    grads = {}
    for remat in (False, True):
        state.model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        total, _ = ttr.loss_for_batch(
            state.model, batch, dataclasses.replace(cfg, remat=remat))
        total.backward()
        torch.cuda.synchronize()
        numbers[f"{'remat' if remat else 'plain'}_grad_peak_mib"] = (
            torch.cuda.max_memory_allocated() / 2 ** 20)
        grads[remat] = _grads(state.model)
    worst = _check_grads("remat", grads[True], grads[False], 1e-6)
    print(f"remat: gradients equal the plain ones within "
          f"{worst:.3g} x max|g|; forward + backward peak "
          f"{numbers['plain_grad_peak_mib']:.1f} MiB plain, "
          f"{numbers['remat_grad_peak_mib']:.1f} MiB remat")
    del state, grads
    torch.cuda.empty_cache()


def _resume(cfg, batches, root):
    """Phase 10 step 4: save at step 2, restore into a fresh state, take
    step 3 (the stem's first live update): bit-equal to three
    uninterrupted steps; the npz export reloads unchanged."""
    import dataclasses

    import torch

    from tpupose_torch.models import CocoPoseNet
    from tpupose_torch.train import checkpoint as ckpt
    from tpupose_torch.train import trainer as ttr
    from tpupose_torch.weights import load_chainer_npz

    cfg = dataclasses.replace(cfg, stem_freeze_steps=2)
    step = ttr.make_train_step(cfg)
    full = _train_state("posenet", torch.float32, cfg, seed=5)
    _run_steps(full, step, batches[:3])
    part = _train_state("posenet", torch.float32, cfg, seed=5)
    _run_steps(part, step, batches[:2])
    path = ckpt.save_checkpoint(root, part)
    del part
    resumed = ckpt.restore_checkpoint(
        path, _train_state("posenet", torch.float32, cfg, seed=6))
    _run_steps(resumed, step, batches[2:3])
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"resume: {name} differs from the "
                                 "uninterrupted run")
    sa, sb = full.optimizer.state_dict(), resumed.optimizer.state_dict()
    if sa["param_groups"] != sb["param_groups"] or any(
            not torch.equal(sa["state"][i][k], sb["state"][i][k])
            for i in sa["state"] for k in ("exp_avg", "exp_avg_sq")):
        raise AssertionError("resume: optimizer state differs")
    npz = ckpt.export_model_npz(root, resumed)
    reloaded = CocoPoseNet(seed=7)
    report = load_chainer_npz(reloaded, npz)
    if report["missing"] or report["unused"]:
        raise AssertionError(f"npz export: {report}")
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            reloaded.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"npz export: {name} changed")
    print(f"resume: save at step 2, restore, step 3 bit-equal to the "
          f"uninterrupted run (parameters and Adam state); "
          f"{os.path.basename(npz)} reloads into CocoPoseNet unchanged")
    del full, resumed
    torch.cuda.empty_cache()


def _train_cli_runs(root, numbers):
    """Phase 10 step 5: ``train_cli.main(["--synthetic", "--test"])`` on
    the card, f32 and bf16."""
    import json as _json

    from tpupose_torch.apps import train_cli

    for label, flags in (("f32", []), ("bf16", ["--bf16"])):
        out = os.path.join(root, f"cli_{label}")
        t0 = time.perf_counter()
        train_cli.main(["--synthetic", "--test", "--out", out, *flags])
        numbers[f"cli_{label}_s"] = time.perf_counter() - t0
        with open(os.path.join(out, "log")) as f:
            log = _json.load(f)
        if [e["iteration"] for e in log] != list(range(1, 11)) or not all(
                e["main/loss"] == e["main/loss"] for e in log) \
                or "val/loss" not in log[-1]:
            raise AssertionError(f"train_cli {label}: log {log}")
        for name in ("posenet_final.npz", "model_iter_10.npz",
                     os.path.join("ckpt", "10", "state.pt"),
                     "params.json", "train_step.export.txt"):
            if not os.path.exists(os.path.join(out, name)):
                raise AssertionError(f"train_cli {label}: no {name}")
        print(f"train_cli --synthetic --test {' '.join(flags)}: 10 "
              f"iterations, loss {log[0]['main/loss']:.5f} -> "
              f"{log[-1]['main/loss']:.5f}, val {log[-1]['val/loss']:.5f}, "
              f"{numbers[f'cli_{label}_s']:.1f} s with set-up")


def _loader_rates(numbers):
    """The loader's samples/s at ``--loaderjob`` 0 and 4 (368-px synthetic
    posenet samples, B = 10), after its first batch."""
    from tpupose_torch.data import BatchLoader, SyntheticCropDataset

    for workers in (0, 4):
        loader = BatchLoader(
            SyntheticCropDataset(18, insize=TRAIN_INSIZE, n_samples=200),
            TRAIN_BATCH, max_persons=1, num_workers=workers,
            pin_memory=True)
        try:
            it = iter(loader)
            next(it)
            t0 = time.perf_counter()
            for _ in range(LOADER_BATCHES):
                next(it)
            dt = time.perf_counter() - t0
        finally:
            loader.close()
        numbers[f"loader_j{workers}_samples_per_s"] = (
            LOADER_BATCHES * TRAIN_BATCH / dt)


def run_training(smi):
    """Phase 10: the training path at full width on the card (see the
    module docstring)."""
    import shutil
    import tempfile

    import torch

    from tpupose_torch.config import TRAIN
    from tpupose_torch.detectors.pose import float32_numerics
    from tpupose_torch.ops import _cuda_build

    t_phase = time.perf_counter()
    numbers = {}
    cfg = TRAIN
    batches = _synthetic_batches(18, TRAIN_INSIZE, TRAIN_BATCH,
                                 2 + TRAIN_TIMED)
    os.makedirs(_cuda_build.BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="train-", dir=_cuda_build.BUILD_DIR)
    try:
        with float32_numerics():
            _full_width_steps(cfg, batches, numbers)
            _crop_net_steps(cfg)
            _card_vs_cpu(cfg)
            _remat(cfg, batches[0], numbers)
            _resume(cfg, batches, root)
        _train_cli_runs(root, numbers)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _loader_rates(numbers)
    numbers["phase10_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    print(f"phase 10 training numbers ({smi}; posenet 6 stages, 368, "
          f"B={TRAIN_BATCH}; step ms from CUDA events over "
          f"{TRAIN_TIMED} steps after 2 warm-up, images/s = steps/s x B; "
          f"peak MiB from max_memory_allocated; loader samples/s on the "
          f"host clock over {LOADER_BATCHES} batches): "
          + json.dumps({k: round(v, 4) for k, v in numbers.items()}))


def _start_resource_report(name):
    """Start ``nvcc -Xptxas -v`` on ``csrc/<name>.cu`` (registers, shared
    memory and spills of each kernel); returns (process, cubin path)."""
    import os

    from tpupose_torch.ops import _cuda_build

    os.makedirs(_cuda_build.BUILD_DIR, exist_ok=True)
    cubin = os.path.join(_cuda_build.BUILD_DIR, f"{name}-ptxas.cubin")
    proc = subprocess.Popen(
        [_cuda_build.nvcc(), *_cuda_build.ARCH_FLAGS, "-Xptxas", "-v",
         "-cubin", "-o", cubin, _cuda_build.source(name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, cubin


def _finish_resource_report(name, proc, cubin):
    import os

    try:
        report, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if os.path.exists(cubin):
            os.remove(cubin)
    print(f"nvcc -Xptxas -v {name}.cu (exit {proc.returncode}):")
    print(report.strip())
    if proc.returncode != 0:
        raise AssertionError(f"nvcc -Xptxas -v failed for {name}.cu")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    try:
        from tpupose_torch.config import INFERENCE
        from tpupose_torch.ops import _cuda_build
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
    reports = {name: _start_resource_report(name)
               for name in ("blur_nms", "conv7_s8", "conv_s8")}
    libs = _cuda_build.build_all(["blur_nms", "conv7_s8", "conv_s8",
                                  "requant"])
    print(f"built {sorted(libs.values())} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        _finish_resource_report(name, *report)

    # Relaxed subset filter (as tests/test_golden_parity.py) so random
    # weights form persons; sizes are the defaults, 368 in / 320 maps.
    cfg = dataclasses.replace(INFERENCE, max_subsets=128,
                              n_subset_limbs_thresh=2,
                              subset_score_thresh=0.05)
    blur_err, blur_times = check_kernel(bn, cfg)
    import numpy as np

    frames = np.random.RandomState(0).randint(
        0, 256, (3, 480, 640, 3)).astype(np.uint8)
    fast_launches, f32_det = run_slice(bn, cfg, frames)
    int8_kernels, conv7_grids = check_int8_kernels()
    int8_kernels["conv_s8"], conv_s8_layers = check_conv_s8()
    quant_counts, qdet, x = run_quantized(f32_det, cfg, frames)
    precise_counts, precise_ms, pdet = run_precise(f32_det, cfg, frames)
    im2col_counts = split_int8(qdet, x, frames[0], precise_ms, conv7_grids,
                               conv_s8_layers)
    profile_blur_nms(f32_det, cfg, frames[0])
    t0 = time.perf_counter()
    crop_counts, face = run_crop_nets(f32_det, cfg, frames)
    t1 = time.perf_counter()
    check_crop_kernels(cfg)
    t2 = time.perf_counter()
    check_tiny_frames(cfg, frames)
    print(f"phase 8: crop nets {t1 - t0:.2f} s, kernels {t2 - t1:.2f} s, "
          f"tiny frames {time.perf_counter() - t2:.2f} s")
    serving_counts = run_serving(f32_det, qdet, pdet, face, cfg, frames,
                                 smi.stdout.strip())
    del f32_det, qdet, pdet, face
    torch.cuda.empty_cache()
    run_training(smi.stdout.strip())

    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "cv2",
                                     "tpupose")]
    if leaked:
        raise AssertionError(f"the port imported {leaked[:4]}")
    # launches: the sum over the driven paths, each counted from zero
    launches = {name: quant_counts[name] + precise_counts[name]
                + crop_counts[name] + serving_counts[name]
                for name in quant_counts}
    launches["blur_nms"] += fast_launches
    # requant runs on the im2col route only: its launches are those of
    # phase 7's im2col forward
    launches["requant_epilogue"] = im2col_counts["requant_epilogue"]
    records = [
        ("blur_nms", "tpupose_torch/csrc/blur_nms.cu",
         "tpupose/ops/pallas/blur_nms.py:103",
         (blur_err, blur_times[(18, 320, 432)]["kernel"],
          blur_times[(18, 320, 432)]["plain"], blur_nms_bound(18, 320, 432))),
        ("conv7_s8", "tpupose_torch/csrc/conv7_s8.cu",
         "tpupose/ops/pallas/conv7.py:116", int8_kernels["conv7_s8"]),
        ("requant_epilogue", "tpupose_torch/csrc/requant.cu",
         "tpupose/ops/pallas/requant.py:74",
         int8_kernels["requant_epilogue"]),
        ("conv_s8", "tpupose_torch/csrc/conv_s8.cu",
         "tpupose/ops/pallas/requant.py:74", int8_kernels["conv_s8"]),
    ]
    fusions = {"conv_s8": "requant_epilogue fused into an s8 implicit GEMM "
                          "for the 1x1 and 3x3 int8 layers (kernel route)",
               "requant_epilogue": "standalone, after im2col + _int_mm "
                                   "(im2col route)"}
    # No single PyTorch call computes any of the four functions, so
    # library_ms is null; the yardstick of conv7 and conv_s8, torch._int_mm
    # on the prebuilt patch matrix, is printed per shape in phase 4.
    print(json.dumps({"kernels": [dict({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None},
        **({"fusion": fusions[name]} if name in fusions else {}))
        for name, source, replaces,
        (err, ms, plain_ms, (bound_ms, bound_by)) in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
