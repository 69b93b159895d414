"""The cost of one ``utils.profiling.annotate`` span with no profiler
running: ``--pairs`` enter/exit pairs timed on the host clock, in
``ROUNDS`` rounds, with CUDA initialised (the NVTX push and pop run
too) where a card is present, an empty loop's time taken off; beside it
the same for ``record_function`` alone and the NVTX range alone.

    python3 scripts/span_cost_probe.py [--pairs 100000] \
        [--out span_cost.json]

Prints one JSON line: microseconds a pair (median and least of the
rounds) and a request's cost at ``SPANS_PER_REQUEST`` spans.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpupose_torch.utils.profiling import annotate  # noqa: E402

ROUNDS = 7
SPANS_PER_REQUEST = 5   # the stage spans of a fast pose or a crop request


@contextlib.contextmanager
def _nvtx(name):
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


def _loop_s(pairs: int, span=None) -> float:
    t0 = time.perf_counter()
    if span is not None:
        for _ in range(pairs):
            with span("pose.resize"):
                pass
    else:
        for _ in range(pairs):
            pass
    return time.perf_counter() - t0


def _pair_us(pairs: int, rounds: int, span) -> list:
    """Microseconds a pair, each round, the empty loop's time taken off."""
    out = []
    for _ in range(rounds):
        empty = _loop_s(pairs)
        out.append((_loop_s(pairs, span) - empty) / pairs * 1e6)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=100_000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    cuda = torch.cuda.is_available()
    if cuda:   # annotate pushes NVTX ranges once CUDA is initialised
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    _loop_s(args.pairs // 10, annotate)   # warm
    span_us = _pair_us(args.pairs, ROUNDS, annotate)
    median = statistics.median(span_us)
    parts = {"record_function": torch.profiler.record_function}
    if cuda:
        parts["nvtx"] = _nvtx
    parts_us = {k: statistics.median(_pair_us(args.pairs, ROUNDS, f))
                for k, f in parts.items()}
    result = {
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "cuda_initialised": torch.cuda.is_initialized(),
        "profiler_running": torch.autograd.profiler._is_profiler_enabled,
        "pairs": args.pairs, "rounds": ROUNDS,
        "pair_us_median": median, "pair_us_min": min(span_us),
        "pair_us_rounds": span_us, "parts_pair_us_median": parts_us,
        "spans_per_request": SPANS_PER_REQUEST,
        "request_us": median * SPANS_PER_REQUEST,
    }
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
