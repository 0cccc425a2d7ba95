"""One run of one cell: set-up, the measured window, the program's state
freed, the check against the reference, the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic mix in ``traffic/<traffic>.json`` (whose ``driver`` names the
module under ``drivers/``), each metric's reader in
``metrics/<metric>.py`` (``read(run) -> float or None``), and the limits
of the numbers the check compares in ``limits/<cell>.json``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "fedbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_spec(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, name: str, trace: bool) -> list:
    """The metric entries a run of cell ``name`` reports: its end-to-end
    ones without the trace, its per-layer ones with it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m
            or name in m["workloads"]]


def limits_of(name: str) -> dict:
    path = os.path.join(HERE, "limits", name + ".json")
    if not os.path.exists(path):
        return {}
    return {k: v["limit"] for k, v in load_json(path)["numbers"].items()}


def make_cell(bench: dict, name: str, seed: int, device, fault=None,
              cfg=None, traffic=None):
    spec = cell_spec(bench, name)
    cfg = cfg or load_json(HERE, "configs", spec["config"] + ".json")
    traffic = traffic or load_json(HERE, "traffic",
                                   spec["traffic"] + ".json")
    driver = importlib.import_module("fedbench.drivers." + traffic["driver"])
    return driver.Cell(cfg, traffic, seed, device, fault=fault)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", bench=None, fault=None, cfg=None, traffic=None,
             t_start=None) -> dict:
    """One run: the result dict of the contract's last line, or raises.
    ``cfg``/``traffic`` replace the cell's files (the CPU tests' small
    sizes); ``fault`` is planted in the program after its set-up."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell = make_cell(bench, name, seed, device, fault, cfg, traffic)
    cell.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    rec = cell.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    cell.release()
    t_check = time.perf_counter()
    numbers = cell.check()
    check_s = time.perf_counter() - t_check
    limits = limits_of(name)
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    correct = (not cell.failures and bool(checks)
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    run = {"cfg": cell.cfg, "traffic": cell.tr, "seconds": seconds,
           "setup_s": setup_s, "window": rec, "trace": cell.trace}
    metrics = {}
    for m in metrics_of(bench, name, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if "rounds" in rec:
        attempted, failed = rec["rounds"], len(cell.failures)
    else:
        attempted = rec["requests"]
        failed = sum(1 for r in cell.records
                     if any(t < 0 or t >= cell.cfg["vocab_size"]
                            for t in r["tokens"]))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": cell_spec(bench, name)["chips"],
                   "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device_info}
    if cell.trace is not None:
        device_info["busy_s"] = cell.trace.busy_s()
        device_info["window_s"] = cell.trace.window_s
        out["breakdown"] = {"device_ops": cell.trace.top_ops(),
                            "idle_gaps": cell.trace.idle_by_host()}
    if cell.failures:
        out["failures"] = cell.failures
    out["check_s"] = check_s
    out["checks"] = checks
    return out


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__("loaded after the window: " + ", ".join(found))
        self.found = found


def main(args, t_start: float) -> int:
    import torch
    bench = load_json(ROOT, "BENCHMARK.json")
    spec = cell_spec(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"fedbench: the cell needs {spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", bench, t_start=t_start)
    except ForbiddenModules as e:
        print(f"fedbench: {e}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0
