"""Read the comparison's two readings for a cell over many seeds, in one
process: the program's numbers (sound runs, the lower reading) and the
control's (the reference in the next precision below, put in the
program's place: the upper reading).  The benchmark's own runs never run
this; its output sets the limits in ``traffic/<traffic>.json``, for the
numbers that the control separates.

    python3 -m posebench.control --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

Per seed: set-up, a closed-loop window of ``--seconds`` (it cycles every
input at least once), the program freed, the reference's answers, the
program's numbers against them, then the control's numbers.  Prints one
JSON line per seed and a summary line: the largest program reading and the
smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from posebench.core import guard, registry
from posebench.core.cell import Cell
from posebench.run import cache_env, closed_loop


def readings(cell: Cell, seconds: float, package_dir=registry.PACKAGE_DIR):
    """(program numbers, control numbers) of one seed."""
    import torch

    drv = registry.driver(cell.traffic["driver"], package_dir)
    program = drv.setup(cell)
    _, answered, _, failed = closed_loop(program.call, program.n_inputs,
                                         seconds, cell.device)
    if failed:
        raise RuntimeError(f"{failed} requests failed")
    seen = {i for i, _ in answered}
    if len(seen) < program.n_inputs:
        raise RuntimeError(f"the window answered {len(seen)} of "
                           f"{program.n_inputs} inputs: lengthen it")
    program.free()
    gc.collect()
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    want = drv.expected(cell, program)
    ours = drv.numbers(answered, want)
    low = drv.expected(cell, program, control=True)
    control = drv.numbers(list(enumerate(low)), want)
    return ours, control


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    root = registry.checkout_root()
    cache_env(root)
    import torch

    if not torch.cuda.is_available():
        print("posebench.control: CUDA is not available", file=sys.stderr)
        return 2
    bench = registry.benchmark(root)
    w = registry.workload(bench, args.workload)
    worst, least = {}, {}
    for seed in args.seeds:
        cell = Cell(name=w["name"], config=registry.config(w["config"]),
                    traffic=registry.traffic(w["traffic"]), seed=seed,
                    device="cuda")
        t0 = time.perf_counter()
        ours, control = readings(cell, args.seconds)
        for n in ours:
            worst[n] = max(worst.get(n, 0), ours[n])
            least[n] = min(least.get(n, float("inf")), control[n])
        print(json.dumps({"seed": seed, "program": ours, "control": control,
                          "s": time.perf_counter() - t0}), flush=True)
    bad = guard.forbidden_modules()
    if bad:
        print(f"posebench.control: JAX-side modules loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "program_max": worst, "control_min": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
