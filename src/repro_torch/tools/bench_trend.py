"""Round-latency trend guard of the port (a copy of
``tools/bench_trend.py`` pointed at the port's artifacts): compare a
FRESH ``repro_torch.benchmarks.bench_round_latency`` artifact against a
saved baseline and fail on a >25% per-round regression of any existing
engine x backend row.

    PYTHONPATH=src python -m repro_torch.tools.bench_trend \
        --baseline OLD.json [--fresh build/bench_torch/round_latency.json] \
        [--serve-baseline OLD_SERVE.json \
         --serve-fresh build/bench_torch/serve_latency.json] \
        [--threshold 1.25] [--absolute]

Rows compared (each a seconds-per-round statistic):

  engine/sequential, engine/batched        top-level study
  sharded/<shards>                         ``sharded`` study
  async/<depth-or-batched>                 ``async`` study
  kernel/<config>                          ``kernel_backend`` study
  transport/<mode>                         ``transport`` study

Defenses against shared-CPU noise (which drifts 2-3x between sessions
and is one-sided -- contention only ADDS time):

* TWO statistics are compared per row -- the MEDIAN and the MIN over the
  study's interleaved timed blocks (``per_round_s``; artifacts without
  raw blocks fall back to ``median_s`` for both). A row fails only when
  BOTH statistics regress past the threshold: a genuine slowdown shows
  up in every quantile, while a load spike inflates the median of one
  run or starves one section's min, but rarely corrupts both statistics
  of the same interleaved sample;
* every row is NORMALIZED by its own run's ``engine/batched`` row (the
  one row present in every artifact), so uniform machine
  drift cancels and the gate measures each engine's cost RELATIVE to the
  batched reference -- exactly the property the engine studies track.
  The reference row itself would be ungateable under its own
  normalization (always 1.0x -- a uniform slowdown of everything would
  pass), so ``engine/batched`` is gated in ABSOLUTE seconds instead,
  still under the median-AND-min rule but at a WIDER threshold
  (``--ref-threshold``, default 3.0x): absolute cross-session numbers
  legitimately drift 2-3x on a shared machine, so the reference gate can
  only catch catastrophic uniform regressions, not 25% ones -- that is
  the honest capability, and it is documented rather than flaky.
  ``--absolute`` compares every row in raw seconds at the strict
  threshold (meaningful on a quiet, pinned box).

Rows present only in the fresh run are reported as new; rows only in the
baseline (a study that was not rerun) are skipped. Two artifacts that
share no row (or, for serving, no cell) fail: a guard that compared
nothing would pass whatever the port's artifacts had drifted to.
``event`` rows are virtual-time simulation outcomes -- exactly
reproducible and appended across runs -- gated per (trigger,
straggler_frac) on the LATEST
``virtual_time_to_target_energy`` of each side at the same wide
catastrophic-only bar as the batched reference row (``--ref-threshold``):
virtual time is deterministic, so only a structural scheduler regression
moves it, but small drifts are expected when trigger constants are
intentionally retuned. A fresh ``null`` (target energy never reached)
against a finite baseline is always a regression.

Serving rows (``--serve-baseline``/``--serve-fresh``, the port's
``build/bench_torch/serve_latency.json``) are VIRTUAL-time continuous-batching
outcomes -- deterministic like the event rows -- gated per
(batch, adapters, swap_every) cell on ``virtual_p95_s`` (up = worse) and
``virtual_throughput_tok_per_s`` (down = worse) at the same wide
catastrophic-only bar: only a structural scheduler/engine regression can
move them, but intentional cost-constant retunes shift every cell a
little. Wall-clock context fields are never gated.

Exit status: 0 clean, 1 regression, 2 usage/IO error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.tools import ROOT

ROUND_ARTIFACT = os.path.join(ROOT, "build", "bench_torch",
                              "round_latency.json")
SERVE_ARTIFACT = os.path.join(ROOT, "build", "bench_torch",
                              "serve_latency.json")


def _section_rows(out: dict, section: dict, prefix: str) -> None:
    per_block = section.get("per_round_s") or {}
    for k, v in (section.get("median_s") or {}).items():
        blocks = per_block.get(str(k)) or per_block.get(k)
        med = float(v)
        out[f"{prefix}/{k}"] = (med, float(min(blocks)) if blocks else med)


def _rows(artifact: dict) -> dict:
    """{row: (median_s, min_s)} over every engine study in the artifact."""
    out = {}
    _section_rows(out, artifact, "engine")
    for key, prefix in (("sharded", "sharded"), ("async", "async"),
                        ("kernel_backend", "kernel"),
                        ("transport", "transport")):
        _section_rows(out, artifact.get(key) or {}, prefix)
    return out


def _event_latest(artifact: dict) -> dict:
    """{(trigger, straggler_frac): latest row} -- rows are append-only, so
    the last row per key is the current scheduler's outcome."""
    out = {}
    for row in (artifact.get("event") or {}).get("rows") or []:
        out[(row.get("trigger"), row.get("straggler_frac"))] = row
    return out


def _gate_events(baseline: dict, fresh: dict, ref_threshold: float,
                 regressions: list) -> None:
    """Gate event-mode rows on virtual_time_to_target_energy at the wide
    catastrophic-only bar (None = never reached target = infinity)."""
    base_ev, fresh_ev = _event_latest(baseline), _event_latest(fresh)
    if not fresh_ev:
        return
    print(f"[bench-trend] {len(fresh_ev)} event-mode rows (virtual time, "
          f"bar {ref_threshold:.1f}x)")
    for key in sorted(fresh_ev, key=str):
        trigger, frac = key
        row = fresh_ev[key]
        f_vt = row.get("virtual_time_to_target_energy")
        name = f"event/{trigger}/straggler={frac}"
        if key not in base_ev:
            print(f"  NEW    {name}: vt_to_target="
                  f"{'n/a' if f_vt is None else f_vt}")
            continue
        b_vt = base_ev[key].get("virtual_time_to_target_energy")
        b = float("inf") if b_vt is None else float(b_vt)
        f = float("inf") if f_vt is None else float(f_vt)
        if f <= b or b == float("inf"):   # faster, equal, or both n/a
            ratio, regressed = (1.0 if f == b else f / b), False
        else:
            ratio = f / b                 # inf when fresh stopped reaching
            regressed = ratio > ref_threshold
        flag = "REGRESS" if regressed else "ok"
        print(f"  {flag:7s}{name}: vt {ratio:.2f}x "
              f"(base {'n/a' if b_vt is None else b_vt}, "
              f"fresh {'n/a' if f_vt is None else f_vt}, "
              f"aggs={row.get('aggregations')})")
        if regressed:
            regressions.append((name, ratio))


def _serve_rows(artifact: dict) -> dict:
    """{(batch, adapters, swap_every): row} of a serving artifact."""
    return {(r.get("batch"), r.get("adapters"), r.get("swap_every")): r
            for r in artifact.get("rows") or []}


def gate_serve(baseline: dict, fresh: dict, ref_threshold: float,
               regressions: list) -> None:
    """Gate serving cells on virtual p95 latency and token throughput at
    the wide catastrophic-only bar (virtual time is deterministic)."""
    base_sv, fresh_sv = _serve_rows(baseline), _serve_rows(fresh)
    if not set(base_sv) & set(fresh_sv):
        print("[bench-trend] the serving artifacts share no cell: "
              "nothing to compare")
        regressions.append(("serve/no-shared-cell", float("inf")))
        return
    print(f"[bench-trend] {len(fresh_sv)} serving cells (virtual time, "
          f"bar {ref_threshold:.1f}x)")
    for key in sorted(fresh_sv, key=str):
        batch, adapters, swap = key
        row = fresh_sv[key]
        name = f"serve/b{batch}_a{adapters}_sw{swap}"
        if key not in base_sv:
            print(f"  NEW    {name}: p95={row.get('virtual_p95_s'):.3f}s")
            continue
        base = base_sv[key]
        ratios = []
        for field, worse_up in (("virtual_p95_s", True),
                                ("virtual_throughput_tok_per_s", False)):
            b, f = base.get(field), row.get(field)
            if not b or not f:
                continue
            ratios.append((field, f / b if worse_up else b / f))
        regressed = any(r > ref_threshold for _, r in ratios)
        flag = "REGRESS" if regressed else "ok"
        print(f"  {flag:7s}{name}: "
              + " ".join(f"{fld}={r:.2f}x" for fld, r in ratios))
        if regressed:
            regressions.append(
                (name, max(r for _, r in ratios)))


def compare(baseline: dict, fresh: dict, *, threshold: float,
            absolute: bool, ref_threshold: float = 3.0) -> int:
    base_rows, fresh_rows = _rows(baseline), _rows(fresh)
    if not (set(base_rows) & set(fresh_rows)
            or set(_event_latest(baseline)) & set(_event_latest(fresh))):
        print("[bench-trend] FAIL: the artifacts share no row: nothing to "
              "compare")
        return 1
    ref_key = "engine/batched"
    norm = not absolute
    if norm and (ref_key not in base_rows or ref_key not in fresh_rows):
        print(f"[bench-trend] WARNING: {ref_key} missing -- "
              "falling back to absolute seconds")
        norm = False
    b_ref = base_rows.get(ref_key, (1.0, 1.0)) if norm else (1.0, 1.0)
    f_ref = fresh_rows.get(ref_key, (1.0, 1.0)) if norm else (1.0, 1.0)

    regressions = []
    mode = "normalized-to-batched" if norm else "absolute"
    print(f"[bench-trend] comparing {len(fresh_rows)} fresh rows "
          f"({mode}, threshold {threshold:.2f}x on median AND min)")
    for key in sorted(fresh_rows):
        if key not in base_rows:
            print(f"  NEW    {key}: {fresh_rows[key][0] * 1e3:.2f} ms")
            continue
        # the normalization reference is always 1.0x against itself, which
        # would let a uniform slowdown through -- gate it absolutely, at
        # the wide catastrophic-only threshold (cross-session absolute
        # drift is 2-3x on shared machines)
        absolute_row = not norm or key == ref_key
        bar = ref_threshold if (absolute_row and norm) else threshold
        ratios = []
        for stat in (0, 1):                       # (median, min)
            b = base_rows[key][stat] / (1.0 if absolute_row
                                        else b_ref[stat])
            f = fresh_rows[key][stat] / (1.0 if absolute_row
                                         else f_ref[stat])
            ratios.append(f / b if b > 0 else float("inf"))
        regressed = all(r > bar for r in ratios)
        flag = "REGRESS" if regressed else "ok"
        note = (f" (absolute, bar {bar:.1f}x)" if absolute_row and norm
                else "")
        print(f"  {flag:7s}{key}: median {ratios[0]:.2f}x "
              f"min {ratios[1]:.2f}x{note}")
        if regressed:
            regressions.append((key, min(ratios)))
    for key in sorted(set(base_rows) - set(fresh_rows)):
        print(f"  SKIP   {key}: not in fresh run")

    _gate_events(baseline, fresh, ref_threshold, regressions)

    if regressions:
        worst = max(regressions, key=lambda kv: kv[1])
        print(f"[bench-trend] FAIL: {len(regressions)} row(s) regressed "
              f">{(threshold - 1) * 100:.0f}% (worst {worst[0]} "
              f"{worst[1]:.2f}x)")
        return 1
    print("[bench-trend] OK: no per-round regression")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True,
                    help="a saved round_latency.json snapshot")
    ap.add_argument("--fresh", default=ROUND_ARTIFACT,
                    help="freshly produced artifact (default %(default)s)")
    ap.add_argument("--threshold", type=float, default=1.25,
                    help="fail ratio (1.25 = >25%% per-round regression)")
    ap.add_argument("--absolute", action="store_true",
                    help="compare raw seconds (no batched normalization)")
    ap.add_argument("--ref-threshold", type=float, default=3.0,
                    help="absolute fail ratio for the engine/batched "
                         "reference row in normalized mode (wide: "
                         "cross-session absolute drift is 2-3x)")
    ap.add_argument("--serve-baseline", default=None,
                    help="a saved serve_latency.json snapshot (optional; "
                         "the serving cells are gated only with it)")
    ap.add_argument("--serve-fresh", default=SERVE_ARTIFACT,
                    help="freshly produced serving artifact (default "
                         "%(default)s)")
    args = ap.parse_args(argv)
    try:
        with open(args.baseline) as f:
            baseline = json.load(f)
        with open(args.fresh) as f:
            fresh = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"[bench-trend] cannot load artifacts: {e}")
        return 2
    rc = compare(baseline, fresh, threshold=args.threshold,
                 absolute=args.absolute,
                 ref_threshold=args.ref_threshold)
    if args.serve_baseline and args.serve_fresh:
        try:
            with open(args.serve_baseline) as f:
                serve_base = json.load(f)
            with open(args.serve_fresh) as f:
                serve_fresh = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"[bench-trend] cannot load serving artifacts: {e}")
            return 2
        serve_reg: list = []
        gate_serve(serve_base, serve_fresh, args.ref_threshold, serve_reg)
        if serve_reg:
            worst = max(serve_reg, key=lambda kv: kv[1])
            print(f"[bench-trend] FAIL: {len(serve_reg)} serving cell(s) "
                  f"regressed (worst {worst[0]} {worst[1]:.2f}x)")
            rc = max(rc, 1)
        else:
            print("[bench-trend] OK: no serving regression")
    return rc


if __name__ == "__main__":
    sys.exit(main())
