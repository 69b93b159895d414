"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files (and entries) in a copy of the benchmark are found and run,
with no edit to a file already there."""

import json
import os
import shutil

from posebench.core import registry
from posebench.tests import tiny


def test_new_files_are_found_and_run(tmp_path):
    pkg = tmp_path / "posebench"
    shutil.copytree(registry.PACKAGE_DIR, pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (pkg / p).read_bytes() for p in
              [os.path.relpath(os.path.join(d, f), pkg)
               for d, _, fs in os.walk(pkg) for f in fs]}

    cfg = registry.config("posenet")
    cfg.update(img_size=64, heatmap_size=56)
    (pkg / "configs" / "posenet_small.json").write_text(json.dumps(cfg))
    traffic = registry.traffic("live_f32")
    traffic.update(frames=2, frame_hw=[96, 128], warmup=1, trace_requests=2)
    (pkg / "traffic" / "small_f32.json").write_text(json.dumps(traffic))
    (pkg / "metrics" / "answers_traced.py").write_text(
        "def read(ctx):\n"
        "    return float(ctx.requests_traced) if ctx.events else None\n")

    bench = registry.benchmark(registry.checkout_root())
    bench["configs"].append({"name": "posenet_small", "source": "x",
                             "file": "posebench/configs/posenet_small.json",
                             "reduced": ["img_size"], "why": "test"})
    bench["workloads"].append({"name": "posenet_small.small_f32",
                               "config": "posenet_small",
                               "traffic": "small_f32", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "answers_traced", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "frame_ms",
                               "workloads": ["posenet_small.small_f32"]})
    # an end-to-end metric that lists its cells takes the new one by entry
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_ms_p95"):
            m["workloads"].append("posenet_small.small_f32")
    w = registry.workload(bench, "posenet_small.small_f32")
    cell = tiny.Cell(name=w["name"],
                     config=registry.config(w["config"], str(pkg)),
                     traffic=registry.traffic(w["traffic"], str(pkg)),
                     seed=tiny.SEED, device="cpu")
    result = tiny.measure(cell, trace_on=True, package_dir=str(pkg),
                          bench=bench)
    assert result["correct"]
    assert result["metrics"]["answers_traced"]["value"] == 2.0
    result = tiny.measure(cell, trace_on=False, package_dir=str(pkg),
                          bench=bench)
    assert set(result["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert list(result)[-1] == "checks"
    for p, data in before.items():
        assert (pkg / p).read_bytes() == data
