"""The port's trend guard (``repro_torch.tools.bench_trend``): the gate
rules of the reference's ``tools/bench_trend.py`` on the same synthetic
artifacts through both tools, and the guard over artifacts that the
port's own writers (``bench_round_latency.run``,
``bench_serve_latency.run``) produce on the CPU, so a drift of their keys
away from what the guard reads shows as a failure here."""
import copy
import importlib.util
import json
import os

import pytest
import torch

from repro_torch.tools import bench_trend

torch.set_num_threads(1)

_TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "bench_trend.py")
_spec = importlib.util.spec_from_file_location("ref_bench_trend", _TOOL)
ref_bench_trend = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_bench_trend)


def _artifact(batched_s=1.0, event_rows=None):
    art = {"median_s": {"batched": batched_s, "sequential": batched_s * 2},
           "per_round_s": {}}
    if event_rows is not None:
        art["event"] = {"rows": event_rows}
    return art


def _event_row(trigger="count", frac=0.25, vt=10.0, aggs=40):
    return {"trigger": trigger, "straggler_frac": frac,
            "virtual_time_to_target_energy": vt, "aggregations": aggs,
            "final_higher_rank_energy": 0.9}


def _compare(tool, baseline, fresh):
    return tool.compare(baseline, fresh, threshold=1.25, absolute=False,
                        ref_threshold=3.0)


def _sequential_times(ratio):
    f = _artifact()
    f["median_s"]["sequential"] *= ratio
    return _artifact(), f


CASES = {
    "unchanged-events": (_artifact(event_rows=[_event_row()]),
                         _artifact(event_rows=[_event_row()]), 0),
    "mild-event-drift": (_artifact(event_rows=[_event_row(vt=10.0)]),
                         _artifact(event_rows=[_event_row(vt=25.0)]), 0),
    "catastrophic-event": (_artifact(event_rows=[_event_row(vt=10.0)]),
                           _artifact(event_rows=[_event_row(vt=40.0)]), 1),
    "fresh-null-event": (_artifact(event_rows=[_event_row(vt=10.0)]),
                         _artifact(event_rows=[_event_row(vt=None)]), 1),
    "both-null-event": (_artifact(event_rows=[_event_row(vt=None)]),
                        _artifact(event_rows=[_event_row(vt=None)]), 0),
    "finite-after-null": (_artifact(event_rows=[_event_row(vt=None)]),
                          _artifact(event_rows=[_event_row(vt=12.0)]), 0),
    "new-event-key": (
        _artifact(event_rows=[_event_row(trigger="count")]),
        _artifact(event_rows=[_event_row(trigger="count"),
                              _event_row(trigger="timeout", vt=99.0)]), 0),
    "latest-event-wins": (
        _artifact(event_rows=[_event_row(vt=10.0)]),
        _artifact(event_rows=[_event_row(vt=99.0), _event_row(vt=10.0)]),
        0),
    "per-trigger-keys": (
        _artifact(event_rows=[_event_row(trigger="count", vt=10.0),
                              _event_row(trigger="timeout", vt=10.0)]),
        _artifact(event_rows=[_event_row(trigger="count", vt=10.0),
                              _event_row(trigger="timeout", vt=50.0)]),
        1),
    "clean": (_artifact(), _artifact(), 0),
    "reference-row-4x": (_artifact(batched_s=1.0), _artifact(batched_s=4.0),
                         1),
    "normalized-1.1x": (*_sequential_times(1.1), 0),
    "normalized-2x": (*_sequential_times(2.0), 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_rules_equal_reference(case):
    baseline, fresh, want = CASES[case]
    assert _compare(ref_bench_trend, copy.deepcopy(baseline),
                    copy.deepcopy(fresh)) == want
    assert _compare(bench_trend, copy.deepcopy(baseline),
                    copy.deepcopy(fresh)) == want


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Baseline artifacts from the port's own writers, on the CPU."""
    from repro_torch.benchmarks import bench_round_latency, \
        bench_serve_latency
    tmp = tmp_path_factory.mktemp("bench_torch")
    mp = pytest.MonkeyPatch()
    mp.setattr(bench_round_latency, "ARTIFACT", str(tmp / "round.json"))
    mp.setattr(bench_serve_latency, "ARTIFACT", str(tmp / "serve.json"))
    try:
        bench_round_latency.run(rounds=2, warmup=1, d_model=16,
                                device="cpu")
        bench_serve_latency.run(batches=(2,), adapter_counts=(1,),
                                swap_rates=(0,), device="cpu")
    finally:
        mp.undo()
    with open(tmp / "round.json") as f:
        rnd = json.load(f)
    with open(tmp / "serve.json") as f:
        serve = json.load(f)
    return rnd, serve


def _main(tmp_path, base, fresh, serve_base=None, serve_fresh=None):
    def dump(name, obj):
        path = tmp_path / name
        path.write_text(json.dumps(obj))
        return str(path)
    argv = ["--baseline", dump("base.json", base),
            "--fresh", dump("fresh.json", fresh)]
    if serve_base is not None:
        argv += ["--serve-baseline", dump("sbase.json", serve_base),
                 "--serve-fresh", dump("sfresh.json", serve_fresh)]
    return bench_trend.main(argv)


def _scaled(art, engines, ratio):
    out = copy.deepcopy(art)
    for eng in engines:
        out["median_s"][eng] *= ratio
        out["per_round_s"][eng] = [t * ratio
                                   for t in out["per_round_s"][eng]]
    return out


def test_writers_rows_are_the_guards(written):
    rnd, serve = written
    assert set(bench_trend._rows(rnd)) == {"engine/sequential",
                                           "engine/batched"}
    assert list(bench_trend._serve_rows(serve)) == [(2, 1, 0)]


def test_unchanged_written_artifacts_pass(written, tmp_path):
    rnd, serve = written
    assert _main(tmp_path, rnd, rnd, serve, serve) == 0


@pytest.mark.parametrize("engines,ratio", [
    (("sequential",), 2.0),               # normalized by batched: 2x
    (("sequential", "batched"), 4.0),     # uniform: the absolute ref row
])
def test_slowed_written_round_artifact_fails(written, tmp_path, engines,
                                             ratio):
    rnd, _ = written
    assert _main(tmp_path, rnd, _scaled(rnd, engines, ratio)) == 1


def test_slowed_written_serve_artifact_fails(written, tmp_path):
    rnd, serve = written
    slow = copy.deepcopy(serve)
    slow["rows"][0]["virtual_p95_s"] *= 4.0
    assert _main(tmp_path, rnd, rnd, serve, slow) == 1


def test_artifacts_sharing_no_row_fail(written, tmp_path):
    rnd, serve = written
    renamed = {"median_s": {"batched_v2": 1.0}, "per_round_s": {}}
    assert _main(tmp_path, rnd, renamed) == 1
    moved = {"rows": [dict(serve["rows"][0], batch=3)]}
    assert _main(tmp_path, rnd, rnd, serve, moved) == 1
    assert _main(tmp_path, rnd, rnd, serve, {"cells": serve["rows"]}) == 1
