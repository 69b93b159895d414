"""Tiny cells for the CPU tests: the benchmark's configurations and mixes
at 64-px network inputs, run through ``run.measure`` on the CPU."""

from __future__ import annotations

import time

import torch

from posebench import run
from posebench.core import registry
from posebench.core.cell import Cell

SEED = 2**31 + 12345    # larger than 32 signed bits hold, as the driver's


def tiny_cell(name: str, seed: int = SEED, device: str = "cpu") -> Cell:
    bench = registry.benchmark(registry.checkout_root())
    w = registry.workload(bench, name)
    cfg, traffic = registry.config(w["config"]), registry.traffic(
        w["traffic"])
    cfg["img_size"] = 64
    if traffic["driver"] == "pose_live":
        cfg["heatmap_size"] = 56
        traffic.update(frames=3, frame_hw=[96, 128], warmup=1,
                       trace_requests=2)
    else:
        traffic.update(frames=2, requests=2, crops_per_request=4,
                       side_range=[24, 48], warmup_rounds=1,
                       trace_requests=2)
    return Cell(name=name, config=cfg, traffic=traffic, seed=seed,
                device=device)


def measure(cell: Cell, trace_on: bool = False, seconds: float = 0.5,
            package_dir: str = registry.PACKAGE_DIR, bench: dict = None):
    torch.set_num_threads(2)
    bench = bench or registry.benchmark(registry.checkout_root())
    return run.measure(cell, bench, seconds, trace_on, time.perf_counter(),
                       package_dir)
