"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's
root, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py`` under this package.
A new cell, configuration, traffic mix or metric is a new file and an
entry in ``BENCHMARK.json``; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def checkout_root(package_dir: str = PACKAGE_DIR) -> str:
    return os.path.dirname(package_dir)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, package_dir: str = PACKAGE_DIR) -> dict:
    return load_json(os.path.join(package_dir, "configs", f"{name}.json"))


def traffic(name: str, package_dir: str = PACKAGE_DIR) -> dict:
    return load_json(os.path.join(package_dir, "traffic", f"{name}.json"))


def _module(kind: str, name: str, package_dir: str):
    path = os.path.join(package_dir, kind, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"posebench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, package_dir: str = PACKAGE_DIR):
    return _module("drivers", name, package_dir)


def metric_reader(name: str, package_dir: str = PACKAGE_DIR):
    return _module("metrics", name, package_dir)


def metrics_for(bench: dict, section: str, cell: str) -> List[dict]:
    """The entries of ``end_to_end`` or ``per_layer`` that ``cell``
    reports: those that list it, or list no cells."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def split_reader(path: str):
    """The reader of the metric that the reader at ``path``, a file
    ``metrics/<metric>.<part>.py``, splits: one quantity reported under
    two names because its cells report different end-to-end metrics."""
    name = os.path.basename(path).split(".")[0]
    return metric_reader(
        name, os.path.dirname(os.path.dirname(os.path.abspath(path))))
