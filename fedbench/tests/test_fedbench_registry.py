"""Every cell of BENCHMARK.json resolves, by name, to its configuration,
traffic, driver, metric readers and check limits, and the file keeps the
benchmark contract's shapes."""
import importlib
import json
import os
import re

import pytest

from fedbench import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fedbench"]
    assert BENCH["command"] == ["python3", "fedbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = harness.cell_spec(BENCH, cell)
    assert NAME.match(cell) and spec["chips"] in (1, 4)
    assert 1 <= len(spec["why"]) <= 200
    cfg = harness.load_json(harness.HERE, "configs",
                            spec["config"] + ".json")
    traffic = harness.load_json(harness.HERE, "traffic",
                                spec["traffic"] + ".json")
    importlib.import_module("fedbench.drivers." + traffic["driver"])
    assert cfg["port"]["config"]
    names = [m["name"] for m in harness.metrics_of(BENCH, cell, False)]
    assert "setup_s" in names and len(names) >= 2
    layer = harness.metrics_of(BENCH, cell, True)
    assert layer
    for m in harness.metrics_of(BENCH, cell, False) + layer:
        assert callable(harness.reader(m["name"]))
    limits = harness.limits_of(cell)
    assert limits and all(v is not None for v in limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_entry(metric):
    m = next(x for x in METRICS if x["name"] == metric)
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                       metric + ".py"))
    for w in m.get("workloads", []):
        assert w in CELLS
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]


def test_configs_are_used_and_filed():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("fedbench/configs/")
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key)


def test_each_cell_reports_its_metrics():
    for cell in CELLS:
        e2e = [m["name"] for m in harness.metrics_of(BENCH, cell, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(BENCH, cell, True)
