"""Training observability: Chainer-LogReport-compatible JSON logging (port
of ``tpupose/utils/reporting.py``).

The reference trainer's artifacts: the ``log`` file (a JSON array, Chainer's
``LogReport``), console report lines (``PrintReport``), a progress bar, the
run's arguments in ``params.json`` with a timestamp marker file, and a dump
of the computation graph (here the ``torch.export`` graph of forward, GT
rendering and loss; Chainer's ``dump_graph`` wrote a .dot file).
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Dict, List, Optional


class TrainLogger:
    """Accumulates scalar observations and periodically flushes them to
    ``<out>/log`` as a JSON array (LogReport parity) + prints a report."""

    PRINT_KEYS = ("epoch", "iteration", "main/loss", "val/loss", "main/paf",
                  "val/paf", "main/heat", "val/heat", "elapsed_time")

    def __init__(self, out_dir: str, log_interval: int = 20):
        self.out_dir = out_dir
        self.log_interval = log_interval
        self.entries: List[dict] = []
        self._window: Dict[str, List[float]] = {}
        self._start = time.time()
        self._header_printed = False
        os.makedirs(out_dir, exist_ok=True)

    def observe(self, iteration: int, scalars: Dict[str, float],
                epoch: Optional[int] = None) -> None:
        for k, v in scalars.items():
            self._window.setdefault(k, []).append(float(v))
        if iteration % self.log_interval == 0 and self._window:
            entry = {k: sum(v) / len(v) for k, v in self._window.items()}
            entry["iteration"] = iteration
            entry["epoch"] = epoch if epoch is not None else 0
            entry["elapsed_time"] = time.time() - self._start
            self.entries.append(entry)
            self._window = {}
            self._flush()
            self._print(entry)

    def _flush(self) -> None:
        with open(os.path.join(self.out_dir, "log"), "w") as f:
            json.dump(self.entries, f, indent=2)

    def _print(self, entry: dict) -> None:
        if not self._header_printed:
            print("  ".join(f"{k:>12s}" for k in self.PRINT_KEYS))
            self._header_printed = True
        cells = []
        for k in self.PRINT_KEYS:
            v = entry.get(k)
            cells.append(f"{v:12.6g}" if isinstance(v, (int, float))
                         else " " * 12)
        print("  ".join(cells), flush=True)


class ProgressBar:
    """Console progress line with speed and ETA, Chainer's
    ``extensions.ProgressBar``.  Host-side iteration counting only: it
    never reads a device value, so it never waits for the device."""

    def __init__(self, total_iters: int, update_interval: int = 100,
                 bar_length: int = 50):
        self.total = max(total_iters, 1)
        self.interval = max(update_interval, 1)
        self.bar_length = bar_length
        self._start = time.time()
        self._start_iter: Optional[int] = None

    def update(self, iteration: int) -> None:
        first = self._start_iter is None
        if first:
            # timing starts at the FIRST observed iteration: its own work
            # happened before we saw it, so it anchors the window rather
            # than being (mis)counted in it.
            self._start_iter = iteration
            self._start = time.time()
        if iteration % self.interval and iteration != self.total:
            return
        frac = min(iteration / self.total, 1.0)
        filled = int(self.bar_length * frac)
        bar = "#" * filled + "." * (self.bar_length - filled)
        done = iteration - self._start_iter
        if first or done <= 0:
            rate = "   -- iters/sec  ETA --"
        else:
            speed = done / max(time.time() - self._start, 1e-9)
            eta = (self.total - iteration) / max(speed, 1e-9)
            rate = (f"{speed:.3f} iters/sec  "
                    f"ETA {datetime.timedelta(seconds=int(eta))}")
        print(f"     total [{bar}] {100 * frac:.2f}%  "
              f"{iteration}/{self.total} iter  {rate}", flush=True)


def dump_computation_graph(out_dir: str, model, cfg, batch) -> str:
    """Write the ``torch.export`` graph of ``model``'s forward, the GT
    rendering and the loss on ``batch`` (on the model's device) to
    ``<out>/train_step.export.txt``: the whole computation of a step's
    loss, inspectable offline."""
    import torch

    from tpupose_torch.train.trainer import TrainBatch, loss_for_batch

    class _StepLoss(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, imgs, poses, ignore_mask):
            return loss_for_batch(
                self.model, TrainBatch(imgs, poses, ignore_mask), cfg)[0]

    device = next(model.parameters()).device
    example = batch.to(device)
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        program = torch.export.export(
            _StepLoss(), (example.imgs, example.poses, example.ignore_mask),
            strict=False)
    path = os.path.join(out_dir, "train_step.export.txt")
    with open(path, "w") as f:
        f.write(str(program))
    return path


def dump_run_params(out_dir: str, args: dict) -> None:
    """``params.json`` and an ``@<timestamp>`` marker file."""
    os.makedirs(out_dir, exist_ok=True)
    stamp = "@" + datetime.datetime.now().strftime("%y%m%d_%H%M")
    open(os.path.join(out_dir, stamp), "w").close()
    with open(os.path.join(out_dir, "params.json"), "w") as f:
        json.dump(args, f)
