"""The port's complexity certifier (``repro_torch.analysis.complexity``):
the slope fit equals the reference's, the contract catalog is the
reference's, the contract unit tests (the reference's, on the port's
copy) hold in both directions, the real programs certify -- the kernel
backend linear in dn, the dense backend mislabelled as kernel flipping
red -- and at the ``--fast`` ladders the port's verdict on every
contract of the batched engine's rows is the reference's verdict. The
two measure differently (op traces and allocator events against HLO
walks), so slopes are compared as verdicts, never as values."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.analysis import complexity
from repro_torch.analysis.complexity import (Contract, Measurement,
                                             ScalingRow,
                                             dense_control_contracts,
                                             evaluate_row, fit_slope)
from repro_torch.analysis.report import AuditReport
from repro_torch.tools import certify_scaling

torch.set_num_threads(1)


def _row(backend, growth, engine="batched", method="raflora",
         metric="dot_flops", axis="dn", ladder=(128, 256, 512)):
    """Synthetic row whose ``metric`` grows as x**growth along ``axis``."""
    meas = [Measurement(axis, float(x), {metric: float(x) ** growth})
            for x in ladder]
    return ScalingRow(program=f"{engine}/{method}/{backend}",
                      engine=engine, method=method, backend=backend,
                      measurements=meas)


def test_fit_slope_equals_reference():
    from repro.analysis.complexity import fit_slope as ref_fit
    rng = np.random.default_rng(0)
    for _ in range(20):
        xs = np.sort(rng.uniform(1.0, 1e5, size=rng.integers(2, 6)))
        ys = rng.uniform(0.0, 1e9, size=xs.size)
        ys[rng.integers(0, xs.size)] = 0.0
        assert fit_slope(xs, ys) == pytest.approx(ref_fit(xs, ys), abs=1e-12)


def test_catalog_is_the_reference_catalog():
    from repro.analysis.complexity import CONTRACTS as REF
    assert len(complexity.CONTRACTS) == len(REF) == 15
    for c, r in zip(complexity.CONTRACTS, REF):
        assert (c.name, c.metric, c.axis, c.max_slope, c.min_slope,
                c.engines, c.methods, c.backends) == \
            (r.name, r.metric, r.axis, r.max_slope, r.min_slope, r.engines,
             r.methods, r.backends)


class TestFitSlope:
    def test_exact_powers(self):
        xs = (128, 256, 512)
        assert fit_slope(xs, [x ** 2 for x in xs]) == pytest.approx(2.0)
        assert fit_slope(xs, [7 * x for x in xs]) == pytest.approx(1.0)
        assert fit_slope(xs, [3.0, 3.0, 3.0]) == pytest.approx(0.0)

    def test_all_zero_series_is_constant(self):
        assert fit_slope((2, 4, 8), (0.0, 0.0, 0.0)) == 0.0

    def test_appearing_cost_blows_up_not_under(self):
        assert fit_slope((128, 256), (0.0, 1e6)) > 10.0

    def test_degenerate_inputs_raise(self):
        with pytest.raises(ValueError):
            fit_slope((128,), (1.0,))
        with pytest.raises(ValueError):
            fit_slope((128, 128), (1.0, 2.0))


class TestContracts:
    def test_applies_selectors(self):
        c = Contract("c", "dot_flops", "dn", max_slope=1.0,
                     engines=("batched",), backends=("kernel",))
        assert c.applies("batched", "anything", "kernel")
        assert not c.applies("sharded", "anything", "kernel")
        assert not c.applies("batched", "anything", "dense")
        assert Contract("w", "dot_flops", "dn", max_slope=1.0).applies(
            "x", "y", "z")

    def test_linear_low_rank_row_passes(self):
        assert evaluate_row(_row("factored", growth=1.0)) == []
        assert evaluate_row(_row("kernel", growth=1.0)) == []

    def test_injected_regression_flips_kernel_contract_red(self):
        findings = evaluate_row(_row("kernel", growth=2.0))
        assert findings
        assert all(f.rule == "scaling-contract" for f in findings)
        assert any("agg-flops-linear-dn" in f.message for f in findings)

    def test_min_slope_contract_catches_dead_measurement(self):
        assert any("dense-cert-flops" in f.message
                   for f in evaluate_row(_row("dense", growth=0.0)))
        assert not any("dense-cert" in f.message
                       for f in evaluate_row(_row("dense", growth=2.0)))

    def test_unmeasured_axis_is_not_a_violation(self):
        assert evaluate_row(_row("kernel", growth=1.0, axis="dn")) == []

    def test_host_registry_contract_both_directions(self):
        kw = dict(engine="host", method="round", metric="host_loop_iters",
                  axis="registry", ladder=(1000, 10000, 100000))
        assert not any("host-registry-iters" in f.message
                       for f in evaluate_row(_row("-", 0.0, **kw)))
        assert any("host-registry-iters" in f.message
                   for f in evaluate_row(_row("-", 1.0, **kw)))

    def test_dense_control_contracts(self):
        ctl = dense_control_contracts()
        assert ctl and all(c.backends == ("dense",) for c in ctl)
        assert evaluate_row(_row("dense", growth=2.0), ctl)
        assert evaluate_row(_row("dense", growth=1.0), ctl) == []

    def test_raising_control_fails_report(self):
        rep = AuditReport()

        def boom():
            raise RuntimeError("tripwire exploded")

        ctl = rep.run_control("crashy", "scaling-contract", boom)
        assert not ctl.tripped and not rep.ok
        assert "RuntimeError" in ctl.error


def _real_row(backend, label):
    meas = []
    for s in (128, 256):
        pt = certify_scaling._base_point("batched", "raflora", backend)
        meas.append(Measurement("dn", float(s), certify_scaling.point_costs(
            pt.scaled(d=s, n=s))))
    return ScalingRow(program=f"batched/raflora/{label}", engine="batched",
                      method="raflora", backend=label, measurements=meas)


class TestRealPrograms:
    def test_genuine_kernel_program_passes(self):
        row = _real_row("kernel", "kernel")
        assert evaluate_row(row) == []
        assert row.slopes()[("dn", "peak_live_bytes")] < 1.35

    def test_dense_program_mislabeled_kernel_flips_red(self):
        findings = evaluate_row(_real_row("dense", "kernel"))
        assert any("agg-flops-linear-dn" in f.message for f in findings)
        assert any("agg-live-linear-dn" in f.message for f in findings)


def _verdicts(row, contracts):
    """{contract name: holds} for every contract applying to the row
    whose (axis, metric) the row measured."""
    slopes = row.slopes()
    out = {}
    for c in contracts:
        s = slopes.get((c.axis, c.metric))
        if s is None or not c.applies(row.engine, row.method, row.backend):
            continue
        out[c.name] = ((c.max_slope is None or s <= c.max_slope)
                       and (c.min_slope is None or s >= c.min_slope))
    return out


def _reference_tool():
    tool = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "certify_scaling.py")
    spec = importlib.util.spec_from_file_location("ref_certify", tool)
    ref_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tool)
    return ref_tool


ROWS = [("fedavg", "-"), ("raflora", "dense"), ("raflora", "factored"),
        ("raflora", "kernel")]


def test_fast_verdicts_equal_reference():
    """The batched engine's rows at the ``--fast`` dn and m ladders: the
    same contracts apply, and each holds or fails in both packages
    alike, the dense controls included."""
    ref_tool = _reference_tool()
    from repro.analysis.complexity import CONTRACTS as REF
    from repro.analysis.complexity import \
        dense_control_contracts as ref_dense
    for method, label in ROWS:
        port = certify_scaling._measure_device_row("batched", method, label,
                                                   True)
        ref = ref_tool._measure_device_row("batched", method, label, True)
        assert port.axes() == ref.axes() == ["dn", "m"]
        want = _verdicts(ref, REF)
        assert want and _verdicts(port, complexity.CONTRACTS) == want
        if label == "dense":
            want = _verdicts(ref, ref_dense())
            assert want and not all(want.values())
            assert _verdicts(port, dense_control_contracts()) == want


def test_host_verdicts_equal_reference():
    """The host rows at the ``--fast`` registry and cohort ladders, in
    both packages: the same rows and axes, and each contract holds or
    fails alike."""
    from repro.analysis.complexity import CONTRACTS as REF
    ref = _reference_tool()._measure_host_rows(True, False)
    port = certify_scaling.measure_host_rows(fast=True)
    assert [r.program for r in port] == [r.program for r in ref]
    for p, r in zip(port, ref):
        assert p.axes() == r.axes()
        want = _verdicts(r, REF)
        assert want and _verdicts(p, complexity.CONTRACTS) == want, \
            p.program


def test_host_rows_certify():
    """The host rows at the fast ladders: registry-independent loop counts
    and bytes on the batched and event engines, work tracking the cohort
    (the loop counts themselves are the reference's, label for label:
    test_torch_host_cost.py)."""
    rows = certify_scaling.measure_host_rows(fast=True)
    assert [r.program for r in rows] == ["host/batched-round",
                                         "host/event-round"]
    for row in rows:
        assert evaluate_row(row) == [], row.program
        assert row.slopes()[("registry", "host_loop_iters")] == 0.0
    assert {"host-registry-iters", "host-registry-alloc",
            "host-cohort-iters"} <= set(
                _verdicts(rows[0], complexity.CONTRACTS))
