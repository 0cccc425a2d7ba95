"""The port's protocol verifier (``repro_torch.analysis.protocol``, driving
the port's own ``EventScheduler``, ``flatten_cohort`` and
``cohort_weights``) against the reference's: on every ``--fast`` scenario
of the sweep both checkers enumerate the same schedules, checkpoint-cut
at the same boundaries and record the same fires -- times, delivered
members, staleness and present masks exactly, weights within 1e-12 --
and every injected protocol bug trips its rule in the port. The
reference's tool is not a package; it is loaded by file path."""
import importlib.util
import json
import os

import pytest
import torch

from repro_torch.analysis import protocol
from repro_torch.federation.events import (ClientLifecycle, CountTrigger,
                                           LifecycleEvent,
                                           StalenessBoundTrigger,
                                           TimeoutTrigger)
from repro_torch.tools import verify_protocol

torch.set_num_threads(1)

_TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "verify_protocol.py")
_spec = importlib.util.spec_from_file_location("ref_verify_protocol", _TOOL)
ref_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_tool)

FAST = {sc.name: sc for sc in verify_protocol.build_scenarios(fast=True)}
REF_FAST = {sc.name: sc for sc in ref_tool.build_scenarios(fast=True)}


def test_fast_scopes_name_the_same_scenarios():
    assert sorted(FAST) == sorted(REF_FAST)
    assert len(FAST) == 6


@pytest.mark.parametrize("name", sorted(FAST))
def test_scenario_equals_reference(name):
    from repro.analysis.protocol import check_scenario as ref_check
    f_port, s_port, r_port = protocol.check_scenario(FAST[name],
                                                     keep_records=True)
    f_ref, s_ref, r_ref = ref_check(REF_FAST[name], keep_records=True)
    assert f_port == [] and f_ref == []
    assert s_port.to_json() == s_ref.to_json()
    assert s_port.replays == s_port.boundaries > 0
    assert len(r_port) == len(r_ref) == s_port.unique_schedules
    for rp, rr in zip(r_port, r_ref):
        assert rp.signature == rr.signature
        assert rp.consume_counts == rr.consume_counts
        assert rp.dropped == rr.dropped
        assert len(rp.fires) == len(rr.fires)
        for fp, fr in zip(rp.fires, rr.fires):
            assert (fp.time, fp.phase, fp.delivered, fp.staleness,
                    fp.present, fp.ghost) == \
                (fr.time, fr.phase, fr.delivered, fr.staleness, fr.present,
                 fr.ghost)
            assert fp.weights == pytest.approx(fr.weights, abs=1e-12)


def _lc_drop():
    return ClientLifecycle([
        LifecycleEvent(time=0.4, kind="dropout", client=2),
        LifecycleEvent(time=1.6, kind="rejoin", client=2)])


def _scenario(trigger_fn, lifecycle_fn=ClientLifecycle, **kw):
    return protocol.Scenario(name="t", num_clients=3, num_plans=2,
                             trigger_fn=trigger_fn,
                             lifecycle_fn=lifecycle_fn, grid=(0.5, 1.5),
                             n_k=(3, 1, 2), ranks=(8, 4, 8), **kw)


def test_double_consume_trips_exactly_once():
    f, _, _ = protocol.check_scenario(
        _scenario(lambda: CountTrigger(3)), replay=False,
        sched_cls=protocol.DoubleConsumeScheduler)
    assert f and {x.rule for x in f} == {"proto-exactly-once"}


def test_cancelled_delivery_trips():
    f, _, _ = protocol.check_scenario(
        _scenario(lambda: CountTrigger(2), _lc_drop), replay=False,
        sched_cls=protocol.CancelledDeliveryScheduler)
    assert "proto-cancelled-consumed" in {x.rule for x in f}


def test_present_mask_leak_trips_ghost_rule():
    f, _, _ = protocol.check_scenario(
        _scenario(lambda: CountTrigger(2), _lc_drop), replay=False,
        break_present=True)
    assert f and {x.rule for x in f} == {"proto-ghost-weight"}


def test_torn_snapshot_trips_replay_divergence():
    f, _, _ = protocol.check_scenario(_scenario(lambda: CountTrigger(3)),
                                      corrupt_replay=True)
    assert f and {x.rule for x in f} == {"proto-replay-divergence"}


def test_understated_staleness_bound_trips():
    f, _, _ = protocol.check_scenario(
        _scenario(lambda: StalenessBoundTrigger(2), staleness_bound=0),
        replay=False)
    assert "proto-staleness-bound" in {x.rule for x in f}


def test_replay_from_every_boundary_kind():
    sc = _scenario(lambda: TimeoutTrigger(1.5))
    slots = protocol.discover_slots(sc)
    table = protocol.table_of(slots, (0.5,) * len(slots))
    d = protocol.Driver(sc, table)
    bounds = d.run_full(cuts=True)
    assert {"dispatch", "fire", "window"} <= {b.kind for b in bounds}
    for b in bounds:
        assert protocol.replay_from(sc, table, b, d.record) == []


def test_verify_sweep_fast_green(tmp_path):
    out = tmp_path / "AUDIT_protocol.json"
    assert verify_protocol.main(["--fast", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["summary"]["ok"] is True and art["summary"]["errors"] == 0
    assert {"double-fire", "cancelled-delivery", "ghost-weight-leak",
            "torn-snapshot", "understated-staleness-bound",
            "injected-host-clock", "torch-global-sampler",
            "torch-manual-seed"} <= set(art["controls"])
    assert all(c["tripped"] for c in art["controls"].values())
    assert {p["kind"] for p in art["programs"]} == {"protocol", "rng-host"}
