"""BENCHMARK.json against its schema: names, units, lengths,
keys, and that every name it gives has its file."""

import json
import os
import re

import pytest

from posebench.core import registry

ROOT = registry.checkout_root()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def _line(text):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        _line(word)
    for path in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.startswith("/") and ".." not in path
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        _line(c["source"])
        _line(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key])
        assert w["chips"] in (1, 4)
        _line(w["why"])
        traffic = registry.traffic(w["traffic"])
        registry.driver(traffic["driver"])
        registry.config(w["config"])


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        _line(m["layer"])
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        registry.metric_reader(m["name"])


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = registry.metrics_for(bench, "end_to_end", w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert registry.metrics_for(bench, "per_layer", w["name"])


def test_four_card_share(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
