"""The port's program audit: the rule-engine core (the reference's unit
tests, on the port's copy), the op lint over op traces (materialization,
collective budgets, host reads, f64 upcasts), the dispatch audit's
steady-state and host-sync rules, and the batched round engine held
steady after its warmup. Every rule is exercised in both directions: a
clean program stays clean AND a deliberately broken one trips."""
import json

import pytest
import torch

from repro_torch.analysis import dispatch_audit, op_lint
from repro_torch.analysis.report import AuditReport, ProgramAudit
from repro_torch.analysis.rules import (Finding, ProgramContext, RuleSet,
                                        SEV_ERROR, SEV_WARNING)

torch.set_num_threads(1)


class TestRuleEngine:
    def _ruleset(self):
        rs = RuleSet("demo")

        @rs.rule("demo-threshold", "payload above meta['limit']")
        def _check(ctx):
            limit = ctx.meta.get("limit")
            if limit is None:
                return
            if ctx.payload > limit:
                yield f"{ctx.payload} > {limit}", "payload"

        @rs.rule("demo-warn", "always warns", severity=SEV_WARNING)
        def _warn(ctx):
            yield "heads up"

        return rs

    def test_rules_yield_findings_with_severity(self):
        rs = self._ruleset()
        ctx = ProgramContext("p", "demo", payload=5, meta={"limit": 3})
        by_rule = {f.rule: f for f in rs.run(ctx)}
        assert by_rule["demo-threshold"].severity == SEV_ERROR
        assert by_rule["demo-threshold"].location == "payload"
        assert by_rule["demo-warn"].severity == SEV_WARNING

    def test_unconfigured_rule_yields_nothing(self):
        rs = self._ruleset()
        fs = rs.run(ProgramContext("p", "demo", payload=10 ** 9, meta={}))
        assert [f.rule for f in fs] == ["demo-warn"]

    def test_only_filter(self):
        rs = self._ruleset()
        ctx = ProgramContext("p", "demo", payload=5, meta={"limit": 3})
        fs = rs.run(ctx, only=("demo-threshold",))
        assert [f.rule for f in fs] == ["demo-threshold"]

    def test_duplicate_rule_id_raises(self):
        rs = self._ruleset()
        with pytest.raises(ValueError, match="duplicate"):
            rs.rule("demo-warn", "again")(lambda ctx: ())

    def test_report_roundtrip_and_control_semantics(self, tmp_path):
        rep = AuditReport(matrix={"demo": True})
        err = Finding("demo-threshold", SEV_ERROR, "p1", "boom")
        rep.add(ProgramAudit("p1", "demo", [err], {}))
        rep.add(ProgramAudit("p0", "demo", [], {"n": 1}))
        rep.add_control("live", "demo-threshold", [err])
        rep.add_control("dead", "demo-threshold", [])
        js = rep.to_json()
        assert [p["program"] for p in js["programs"]] == ["p0", "p1"]
        assert js["controls"]["live"]["tripped"] is True
        assert js["controls"]["dead"]["tripped"] is False
        assert rep.failed_controls == ["dead"]
        assert not rep.ok
        out = tmp_path / "sub" / "AUDIT_demo.json"
        rep.write(str(out))                      # makes its directory
        assert json.loads(out.read_text())["summary"]["ok"] is False


def _svd_point(backend, **kw):
    return op_lint.ProgramPoint("batched", "raflora", backend, **kw)


MAT = {"forbid_elems": 160 * 192, "forbid_dims": (160, 192)}


class TestOpRules:
    @pytest.mark.parametrize("backend", ["factored", "kernel"])
    def test_low_rank_aggregate_is_clean(self, backend):
        """The factored backend and the kernel backend (K1/K2 through
        ``kernels.ops``, their plain versions on the CPU) form no (d, n)
        product: clean under every rule."""
        trace, out = op_lint.trace_ops(op_lint.program_fn(
            _svd_point(backend)))
        assert op_lint.lint_ops(trace, backend, MAT) == []
        assert trace.flops > 0 and trace.hbm_bytes > 0
        assert out[0].shape == (2, 160, 8)

    def test_dense_backend_trips_materialization(self):
        trace, _ = op_lint.trace_ops(op_lint.program_fn(_svd_point("dense")))
        fs = op_lint.lint_ops(trace, "dense", MAT)
        assert fs and {f.rule for f in fs} == {"op-materialization"}
        assert op_lint.lint_ops(trace, "dense",
                                {"forbid_elems": 10 ** 9}) == []

    def test_materialization_rule_mechanics(self):
        a, b = torch.ones(32, 16), torch.ones(16, 24)
        trace, _ = op_lint.trace_ops(lambda: a @ b)
        fs = op_lint.lint_ops(trace, "mm", {"forbid_elems": 32 * 24,
                                            "forbid_dims": (32, 24)})
        assert any(f.rule == "op-materialization" for f in fs)
        assert trace.flops == 2 * 32 * 16 * 24

    def test_f64_trips_unless_waived(self):
        x = torch.ones(4)
        trace, _ = op_lint.trace_ops(lambda: x.double().sum())
        fs = op_lint.lint_ops(trace, "f64")
        assert fs and {f.rule for f in fs} == {"op-dtype-upcast"}
        assert op_lint.lint_ops(trace, "f64", {"allow_f64": True}) == []

    def test_transport_residual_is_f64_and_waived_by_the_sweep(self):
        """The int8 transport's error-feedback residual is computed in
        float64 on purpose: the program trips the rule, and the sweep
        waives it with its reason."""
        from repro_torch.federation.transport import (TransportConfig,
                                                      UpdateTransport)
        from repro_torch.tools import lint_programs
        t = UpdateTransport(TransportConfig(mode="int8"))
        g = torch.Generator().manual_seed(0)
        factors = {("l", "q"): (torch.randn(2, 16, 4, generator=g),
                                torch.randn(2, 4, 24, generator=g))}
        trace, _ = op_lint.trace_ops(t.encode_group, [0, 1], factors)
        assert {f.rule for f in op_lint.lint_ops(trace, "t")} == {
            "op-dtype-upcast"}
        meta = lint_programs.TRANSPORT_META
        assert meta["f64_reason"] and op_lint.lint_ops(trace, "t",
                                                       meta) == []

    def test_bf16_upcast_rule(self):
        b = torch.ones(64, 64, dtype=torch.bfloat16)
        trace, _ = op_lint.trace_ops(lambda: b.float() @ b.float())
        fs = op_lint.lint_ops(trace, "bf16", {"bf16_min_elems": 64 * 64})
        assert {f.rule for f in fs} == {"op-dtype-upcast"}

    @pytest.mark.parametrize("read", ["item", "tolist", "bool", "numpy"])
    def test_host_read_inside_trace_trips(self, read):
        x = torch.ones(4, 4)
        fn = {"item": lambda: (x * 2).sum().item(),
              "tolist": lambda: (x * 2).tolist(),
              "bool": lambda: bool((x > 0).all()),
              "numpy": lambda: (x * 2).numpy()}[read]
        trace, _ = op_lint.trace_ops(fn)
        fs = op_lint.lint_ops(trace, read)
        assert {f.rule for f in fs} == {"op-host-transfer"}
        assert len(fs) == 1                      # one read, one finding

    def test_read_of_a_copied_result_counts_once(self):
        """A device-to-host copy's result read by ``.numpy()`` or
        ``.tolist()`` is not counted again (the copy was); the membership
        check never compares tensors by value."""
        import weakref
        trace = op_lint.OpTrace()
        copied, other = torch.ones(3), torch.ones(3)
        with op_lint.OpTraceMode(trace) as mode:
            mode._copied[id(copied)] = weakref.ref(copied)
            copied.numpy()
            copied.tolist()
            other.tolist()
        assert trace.host_reads == ["tolist"]

    def test_tolist_patch_is_undone(self):
        had = "tolist" in torch.Tensor.__dict__
        orig = torch.Tensor.tolist
        with op_lint.OpTraceMode(op_lint.OpTrace()):
            assert torch.Tensor.tolist is not orig
        assert torch.Tensor.tolist is orig
        assert ("tolist" in torch.Tensor.__dict__) == had

    def test_collective_budget_on_one_rank_mesh(self):
        with op_lint.one_rank_mesh() as mesh:
            pt = op_lint.ProgramPoint("sharded", "raflora", "factored")
            trace, _ = op_lint.trace_ops(op_lint.program_fn(pt, mesh=mesh))
        assert trace.collective_count == 2        # u_c and v_c
        assert op_lint.lint_ops(trace, "sh", {"max_collective_count": 2,
                                              "max_collective_bytes":
                                              trace.collective_bytes}) == []
        fs = op_lint.lint_ops(trace, "sh", {"max_collective_count": 1,
                                            "max_collective_bytes": 0})
        assert [f.rule for f in fs] == ["op-collective-budget"] * 2

    def test_grouped_aggregate_makes_no_float64_tensor(self):
        """The weights cross from numpy as f32 (cast on the host), so the
        batched engine's aggregate holds no float64 tensor: the op lint's
        finding against the port, fixed."""
        from repro_torch.core.aggregation import Aggregator
        agg = Aggregator("raflora", (4, 8))
        g = torch.Generator().manual_seed(0)
        gb = ((torch.randn(2, 16, 4, generator=g),),
              (torch.randn(2, 16, 8, generator=g),))
        ga = ((torch.randn(2, 4, 24, generator=g),),
              (torch.randn(2, 8, 24, generator=g),))
        trace, _ = op_lint.trace_ops(
            agg.aggregate_grouped, gb, ga, [4, 4, 8, 8], [3, 1, 2, 5],
            present=[True, True, True, False])
        assert op_lint.lint_ops(trace, "grouped") == []


class TestDispatchRules:
    def _rounds(self, fn, n=4):
        mon = dispatch_audit.DispatchMonitor()
        with mon:
            for r in range(n):
                fn(r)
                mon.mark(f"round{r}")
        return mon

    def test_steady_state_clean(self):
        mon = self._rounds(lambda r: (torch.ones(8) * 2.0).sum())
        assert dispatch_audit.lint_dispatch(mon, "steady",
                                            {"warmup": 1}) == []

    def test_shape_varying_rounds_trip(self):
        mon = self._rounds(lambda r: (torch.ones(8 + r) * 2.0).sum())
        fs = dispatch_audit.lint_dispatch(mon, "vary", {"warmup": 1})
        assert {f.rule for f in fs} == {"dispatch-steady-state"}
        assert len(fs) == 2                      # rounds 2-3 vs round 1

    def test_period_compares_like_rounds(self):
        mon = self._rounds(lambda r: (torch.ones(8 + r % 2) * 2.0).sum(),
                           n=6)
        assert dispatch_audit.lint_dispatch(
            mon, "cycle", {"warmup": 2, "period": 2}) == []
        assert dispatch_audit.lint_dispatch(mon, "cycle", {"warmup": 2})

    def test_library_build_after_warmup_trips(self, monkeypatch):
        from repro_torch.kernels import build
        mon = dispatch_audit.DispatchMonitor()
        with mon:
            mon.mark("round0")
            monkeypatch.setattr(build, "loads", build.loads + 1)
            mon.mark("round1")
        fs = dispatch_audit.lint_dispatch(mon, "load", {"warmup": 1})
        assert [f.rule for f in fs] == ["dispatch-steady-state"]

    def test_host_sync_budget(self):
        mon = self._rounds(lambda r: (torch.ones(4) * 2.0).sum().item(), 3)
        assert all(p.sync_count == 1 for p in mon.phases)
        fs = dispatch_audit.lint_dispatch(
            mon, "sync", {"warmup": 1, "max_host_syncs_per_phase": 0})
        assert {f.rule for f in fs} == {"dispatch-host-sync-budget"}
        assert dispatch_audit.lint_dispatch(
            mon, "sync", {"warmup": 1, "max_host_syncs_per_phase": 1}) == []

    def test_nesting_raises(self):
        with dispatch_audit.DispatchMonitor():
            with pytest.raises(RuntimeError, match="nested"):
                with dispatch_audit.DispatchMonitor():
                    pass


def test_batched_round_engine_is_steady_state():
    """End to end: a real multi-round federated run on the batched engine
    (kernel backend, its plain versions here) loads nothing and runs the
    same ops every round after its warmup, with its host reads within
    budget (the engine the reference gates in TestFederatedDispatchAudit)."""
    from repro_torch.federation.experiment import build_experiment
    exp = build_experiment(
        "raflora",
        fl_overrides={"num_rounds": 6, "num_clients": 4,
                      "participation": 1.0},
        lora_overrides={"rank_levels": (4, 8), "rank_probs": (0.5, 0.5)},
        num_classes=4, d_model=32, samples_per_class=20,
        batches_per_round=1, backend="kernel", round_engine="batched",
        device="cpu")
    mon = dispatch_audit.DispatchMonitor()
    with mon:
        for r in range(4):
            exp.server.run_round()
            mon.mark(f"round{r}")
    assert dispatch_audit.lint_dispatch(
        mon, "federated/batched",
        {"warmup": 2, "max_host_syncs_per_phase": 4}) == []
    assert all(p.op_count > 0 and p.sync_count > 0 for p in mon.phases)


@pytest.mark.parametrize("tool,argv", [
    ("lint_programs", []), ("certify_scaling", ["--fast"]),
    ("ci", ["lint", "--fast"]), ("ci", ["certify"])])
def test_tools_take_the_card_unless_asked_for_the_cpu(monkeypatch, tool,
                                                      argv):
    """Run without ``--device``, the lint and the certifier take the card,
    as every entry point of the port: with no card they raise before any
    sweep, never passing on the plain versions unasked."""
    import importlib
    mod = importlib.import_module(f"repro_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
