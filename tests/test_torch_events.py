"""The port's event engine held to the JAX package: the scheduler
(``federation/events.py``) and the traces module byte for byte, the
partial-cohort weights (``Aggregator._present_weight_args``) exactly, the
event engine's rounds at the round tolerances, and the paper's straggler
scenario (``tests/test_invariants.py::TestStragglerRankCollapse``) on the
port alone.

Tolerances: fire logs, scheduler ``state_dict``s and weights are equal
byte for byte / bit for bit; an all-present ``present=`` aggregation is
bit-equal to the unmasked one; the event engine against JAX from the same
weights: same clients, fire log and virtual times exactly, losses at rtol
1e-4, spectra within 1e-3 * sigma_max and adapter products within
2e-3 * max(1, sigma_max) (the kernel path's, ``tests/test_torch_round.py``)."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.lora import merge_lora as j_merge
from repro.data import traces as jtr
from repro.federation import events as jev
from repro.federation.experiment import build_experiment as j_build
from repro.federation.topology import ClientRegistry as JReg
from repro.federation.transport import TransportConfig as JTx
from repro_torch.convert import params_from_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.data import traces as ttr
from repro_torch.federation import events as tev
from repro_torch.federation.experiment import build_experiment as t_build
from repro_torch.federation.topology import ClientRegistry as TReg
from repro_torch.federation.transport import TransportConfig as TTx

torch.set_num_threads(1)


def _random_plans(seed, n_plans, n_clients, m):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n_clients, size=m, replace=False).tolist())
            for _ in range(n_plans)]


def _scheduler(ev, latency, trigger, seed, lifecycle):
    m = 4
    lat = {"lognormal": lambda: ev.LognormalLatency(median=1.0, sigma=0.5,
                                                    seed=seed),
           "bimodal": lambda: ev.BimodalLatency(fast=0.7, slow=3.1,
                                                slow_prob=0.3, seed=seed),
           "straggler": lambda: ev.StragglerTailLatency(
               median=0.9, sigma=0.3, tail_scale=5.0, straggler_frac=0.25,
               seed=seed),
           "constant": lambda: ev.ConstantLatency(1.0)}[latency]()
    trig = {"count": ev.CountTrigger(2 * m), "timeout": ev.TimeoutTrigger(1.7),
            "staleness": ev.StalenessBoundTrigger(2)}[trigger]
    life = (ev.ClientLifecycle([ev.LifecycleEvent(1.2, "dropout", 1),
                                ev.LifecycleEvent(3.4, "rejoin", 1)])
            if lifecycle else None)
    return ev.EventScheduler(lat, trig, lifecycle=life)


def _run_bytes(ev, latency, trigger, seed, lifecycle=False):
    """``TestFireLogByteStability``'s blob: every fire with its consumed
    (plan, member, arrival) triples, the fire log and the final state,
    plus the state halfway (the checkpointed form)."""
    sched = _scheduler(ev, latency, trigger, seed, lifecycle)
    fires, mid = [], None
    plans = _random_plans(seed, 6, 10, 4)
    for r, clients in enumerate(plans):
        active = sched.active_clients(10)
        sched.dispatch(r, clients if active is None else
                       [c for c in clients if c in set(active.tolist())])
        for t in sched.advance_window():
            fires.append((t, sched.take_ready()))
        if r == 2:
            mid = sched.state_dict()
    for t in sched.drain():
        fires.append((t, sched.take_ready()))
    blob = {"fires": [[t, sorted([pr, m, a] for pr, rd in ready.items()
                                 for m, a in rd.items())]
                      for t, ready in fires],
            "log": [[f.time, f.consumed, f.max_staleness, f.trigger]
                    for f in sched.fire_log],
            "completed": sched.completed_plans(),
            "mid": mid, "state": sched.state_dict()}
    return json.dumps(blob, sort_keys=True).encode()


@pytest.mark.parametrize("trigger", ["count", "timeout", "staleness"])
@pytest.mark.parametrize("latency", ["lognormal", "bimodal", "straggler",
                                     "constant"])
def test_scheduler_bytes_equal_jax(latency, trigger):
    """The fire log and ``state_dict`` of the port's scheduler equal the
    reference's byte for byte, for every trigger and latency family of
    ``tests/test_events.py``, over two seeds."""
    for seed in (0, 7):
        assert (_run_bytes(tev, latency, trigger, seed)
                == _run_bytes(jev, latency, trigger, seed))


def test_scheduler_lifecycle_and_restore_match_jax():
    """Dropout and rejoin events byte for byte; a JAX ``state_dict``
    loaded into the port's scheduler continues exactly as the JAX one."""
    assert (_run_bytes(tev, "bimodal", "timeout", 3, lifecycle=True)
            == _run_bytes(jev, "bimodal", "timeout", 3, lifecycle=True))
    js = _scheduler(jev, "lognormal", "timeout", 5, True)
    ts = _scheduler(tev, "lognormal", "timeout", 5, True)
    plans = _random_plans(5, 6, 10, 4)
    for r in range(3):
        js.dispatch(r, plans[r])
        for _ in js.advance_window():
            js.take_ready()
    ts.load_state_dict(json.loads(json.dumps(js.state_dict())))
    for sched in (js, ts):
        for r in range(3, 6):
            sched.dispatch(r, plans[r])
            for _ in sched.advance_window():
                sched.take_ready()
        for _ in sched.drain():
            sched.take_ready()
    assert (json.dumps(ts.state_dict(), sort_keys=True)
            == json.dumps(js.state_dict(), sort_keys=True))


def test_traces_match_jax(tmp_path):
    """Record a latency stream, write it as JSONL in one package and
    replay it in the other: the same file bytes, the same draws."""
    rec = tev.RecordingLatency(tev.BimodalLatency(seed=21))
    draws = [rec.sample(c) for c in (3, 1, 3, 0, 2)]
    t_path, j_path = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    ttr.write_trace(t_path, rec.records)
    jtr.write_trace(j_path, [jtr.TraceRecord(r.client, r.latency)
                             for r in rec.records])
    assert open(t_path, "rb").read() == open(j_path, "rb").read()
    replay = jev.TraceLatency(jtr.read_trace(t_path))
    assert [replay.sample(c) for c in (3, 1, 3, 0, 2)] == draws
    assert ttr.trace_schedule(ttr.read_trace(j_path)) == [3, 1, 3, 0, 2]
    assert ttr.constant_trace([4, 2]) == [ttr.TraceRecord(4, 1.0),
                                          ttr.TraceRecord(2, 1.0)]


@pytest.mark.parametrize("grow", ["default-rng", "seeded", "shrink"])
def test_registry_growth_and_active_sampling_match_jax(grow):
    """``ClientRegistry.inflate``, ``add_client`` and ``sample_round``
    (with and without an ``active`` pool) against the reference's from
    the same rng: the same ranks, shards aliased onto the same originals,
    and the same samples, exactly."""
    shards = [np.arange(3 * k, 3 * k + 3) for k in range(5)]
    ranks = np.array([4, 16, 8, 4, 32])
    regs = [cls(ranks=ranks.copy(), shards=list(shards),
                rank_levels=(4, 8, 16, 32)) for cls in (JReg, TReg)]
    for reg in regs:
        if grow == "default-rng":
            reg.inflate(23)
        elif grow == "seeded":
            reg.inflate(23, np.random.default_rng(7))
        else:
            reg.inflate(3)                   # fewer than there are: no-op
        cid = reg.add_client(8, [40, 41])
        assert cid == reg.num_clients - 1
    jreg, treg = regs
    np.testing.assert_array_equal(treg.ranks, jreg.ranks)
    assert treg.num_clients == (24 if grow != "shrink" else 6)
    for k in range(treg.num_clients - 1):
        assert treg.shards[k] is shards[k % 5]
    np.testing.assert_array_equal(treg.shards[-1], jreg.shards[-1])
    assert treg.shards[-1].dtype == np.int64
    rngs = [np.random.default_rng(11) for _ in regs]
    pool = np.array([0, 2, 3, treg.num_clients - 1])
    for active in (None, pool, None, pool[:2]):
        draws = [reg.sample_round(3, rng, active=active)
                 for reg, rng in zip(regs, rngs)]
        np.testing.assert_array_equal(draws[1], draws[0])
        if active is not None:
            assert set(draws[1].tolist()) <= set(active.tolist())
            assert draws[1].size == min(3, active.size)


@pytest.mark.parametrize("method", ["raflora", "flexlora", "hetlora",
                                    "raflora-partial8"])
def test_present_weight_args_match_jax(method):
    """``_present_weight_args`` bit-equal to the reference's on partial
    cohorts (raFLoRA's Eq. 8 fallback included), and with everyone present
    bit-equal to the unfiltered ``_weight_args``."""
    name, partial = (("raflora", 8) if method == "raflora-partial8"
                     else (method, None))
    rng = np.random.default_rng(len(method))
    for _ in range(8):
        m = int(rng.integers(3, 9))
        ranks = [int(r) for r in rng.choice((4, 8, 16), size=m)]
        n_arr = rng.integers(1, 300, size=m).astype(np.float64)
        present = rng.random(m) < 0.6
        present[int(rng.integers(m))] = True
        for pres in (present, np.ones(m, bool)):
            jw = jagg.Aggregator(name, (4, 8, 16), partial_up_to=partial
                                 )._present_weight_args(ranks, n_arr, pres)
            tw = tagg.Aggregator(name, (4, 8, 16), partial_up_to=partial
                                 )._present_weight_args(ranks, n_arr, pres)
            for t, j in zip(tw, jw):
                assert (t is None) == (j is None)
                if j is not None:
                    np.testing.assert_array_equal(t, np.asarray(j))
        uw = tagg.Aggregator(name, (4, 8, 16), partial_up_to=partial
                             )._weight_args(ranks, n_arr)
        for t, u in zip(tw, uw):
            if u is not None:
                np.testing.assert_array_equal(t, u)


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_all_present_bit_equal_and_absent_change_nothing(backend):
    """``aggregate_grouped(present=all True)`` is bit-identical to the
    call without ``present``; absent clients' factors change nothing (the
    masked call equals the present subset aggregated alone)."""
    rng = np.random.default_rng(3)
    m, d, n, r = 6, 12, 10, 8
    bs = torch.from_numpy(rng.normal(size=(m, 1, d, r)).astype(np.float32))
    as_ = torch.from_numpy(rng.normal(size=(m, 1, r, n)).astype(np.float32))
    gb = torch.from_numpy(rng.normal(size=(1, d, r)).astype(np.float32))
    ga = torch.from_numpy(rng.normal(size=(1, r, n)).astype(np.float32))
    ranks, n_k = [4, 8, 4, 8, 4, 8], [10, 20, 30, 40, 50, 60]
    agg = tagg.Aggregator("raflora", (4, 8), backend=backend)
    kw = dict(global_bs=[gb], global_as=[ga], staleness=[0, 1, 0, 2, 1, 0],
              gamma=0.7)
    full = agg.aggregate_grouped([[bs]], [[as_]], ranks, n_k, **kw)
    allp = agg.aggregate_grouped([[bs]], [[as_]], ranks, n_k,
                                 present=[True] * m, **kw)
    for x, y in ((full.b_g, allp.b_g), (full.a_g, allp.a_g),
                 (full.sigma, allp.sigma)):
        assert torch.equal(x, y)
    present = [True, False, True, True, False, True]
    idx = np.flatnonzero(present)
    masked = agg.aggregate_grouped([[bs]], [[as_]], ranks, n_k,
                                   global_bs=[gb], global_as=[ga],
                                   present=present)
    subset = agg.aggregate_grouped(
        [[bs[idx]]], [[as_[idx]]], [ranks[i] for i in idx],
        [n_k[i] for i in idx], global_bs=[gb], global_as=[ga])
    np.testing.assert_allclose((masked.b_g @ masked.a_g).numpy(),
                               (subset.b_g @ subset.a_g).numpy(), atol=1e-5)


SMALL = dict(fl_overrides={"num_rounds": 4, "num_clients": 8,
                           "participation": 0.5},
             lora_overrides={"rank_levels": (4, 8, 16),
                             "rank_probs": (0.34, 0.33, 0.33)},
             samples_per_class=20, num_classes=4, d_model=32,
             batches_per_round=1, backend="kernel", round_engine="async",
             staleness_gamma=0.8)


def _straggler_sched(ev, high):
    return ev.EventScheduler(
        ev.StragglerTailLatency(median=0.8, sigma=0.15, tail_scale=2.5,
                                straggler_clients=high, seed=5),
        ev.TimeoutTrigger(2.0), round_interval=1.0)


def _products(server):
    return {p: np.asarray(b) @ np.asarray(a) for p, (b, a) in
            server._extract_factors(server.global_lora,
                                    server.lora_cfg.r_max).items()}


def _assert_round_parity(hj, ht, sj, st):
    """Round parity of two servers from the same weights: clients, losses
    (rtol 1e-4), the last probe (1e-3 * sigma_max) and the adapter
    products (2e-3 * max(1, sigma_max))."""
    assert [h.clients for h in ht] == [h.clients for h in hj]
    np.testing.assert_allclose([h.mean_client_loss for h in ht],
                               [h.mean_client_loss for h in hj], rtol=1e-4)
    j_sig = np.asarray(hj[-1].sigma_probe)
    scale = max(1.0, float(np.abs(j_sig).max()))
    np.testing.assert_allclose(ht[-1].sigma_probe, j_sig, atol=1e-3 * scale)
    np.testing.assert_allclose(st.energy.rho_r1, sj.energy.rho_r1, atol=1e-3)
    pj, pt = _products(sj), _products(st)
    assert list(pt) == list(pj)
    for p, want in pj.items():
        np.testing.assert_allclose(pt[p], want, atol=2e-3 * scale)


@pytest.mark.parametrize("mode", [None, "bf16"], ids=["f32", "bf16"])
def test_event_engine_matches_jax(mode):
    """The event engine (straggler latency, timeout trigger, partial
    cohorts) in both packages from the same weights. Round parity holds at
    the first fire (round 1's window end), the first aggregation from
    identical state: later fires start from globals that differ by float
    noise, which local AdamW amplifies (multi-round trajectories diverge,
    as in ``TestRoundEngineEquivalence``). The rest of the run -- four
    rounds and the drain -- must match in everything the events decide:
    clients, virtual times and the fire log, exactly."""
    tx = {} if mode is None else {"jax": JTx(mode=mode),
                                  "torch": TTx(mode=mode)}
    je = j_build("raflora", transport=tx.get("jax"), **SMALL)
    params = jax.tree.map(np.asarray,
                          j_merge(je.server.base, je.server.global_lora))
    te = t_build("raflora", device="cpu", transport=tx.get("torch"),
                 base_params=params_from_numpy(params, "cpu"), **SMALL)
    high = np.flatnonzero(je.registry.ranks > 4)
    je.server.set_event_scheduler(_straggler_sched(jev, high))
    te.server.set_event_scheduler(_straggler_sched(tev, high))
    masks, inner = [], te.server._aggregate_grouped

    def record(*a, **k):
        masks.append(k["present"])
        return inner(*a, **k)
    te.server._aggregate_grouped = record
    hj, ht = je.server.run(2), te.server.run(2)
    assert len(je.server.event_scheduler.fire_log) == 1
    _assert_round_parity(hj, ht, je.server, te.server)
    hj, ht = je.server.run(2), te.server.run(2)
    je.server.drain_pending()
    te.server.drain_pending()
    assert [h.clients for h in ht] == [h.clients for h in hj]
    assert [h.virtual_time for h in ht] == [h.virtual_time for h in hj]
    jlog, tlog = je.server.event_scheduler.fire_log, \
        te.server.event_scheduler.fire_log
    assert [vars(f) for f in tlog] == [vars(f) for f in jlog]
    assert len(masks) == len(tlog)
    assert any(not all(m) for m in masks)          # partial cohorts
    assert np.isfinite(te.server.energy.rho_r1).all()


def test_unit_latency_event_equals_cadence():
    """``TestUnitLatencyCadenceEquivalence`` on the port: CountTrigger
    (2 M) on the unit-latency trace is bit-equal to pipeline_depth=2."""
    cad = t_build("raflora", device="cpu", pipeline_depth=2, **SMALL)
    base = cad.server.global_params()
    evt = t_build("raflora", device="cpu", base_params=base,
                  event_scheduler=tev.EventScheduler(
                      tev.ConstantLatency(1.0), tev.CountTrigger(8),
                      round_interval=1.0), **SMALL)
    cad.server.run(4)
    evt.server.run(4)
    assert [s.clients for s in cad.server.history] == \
        [s.clients for s in evt.server.history]
    assert [s.mean_client_loss for s in cad.server.history] == \
        [s.mean_client_loss for s in evt.server.history]
    assert cad.server.energy.rho_r1 == evt.server.energy.rho_r1
    pc, pe = _products(cad.server), _products(evt.server)
    for p in pc:
        np.testing.assert_array_equal(pc[p], pe[p])
    assert [s.virtual_time for s in evt.server.history] == [1.0, 2.0, 3.0,
                                                            4.0]
    assert [f.consumed for f in evt.server.event_scheduler.fire_log] == [8, 8]


def _straggler_energy(method, transport=None):
    exp = t_build(
        method, fl_overrides={"num_rounds": 12, "num_clients": 12,
                              "participation": 0.5},
        samples_per_class=60, num_classes=12, d_model=96,
        batches_per_round=1, round_engine="async", staleness_gamma=0.6,
        transport=transport, device="cpu")
    high = np.flatnonzero(
        exp.registry.ranks > min(exp.server.lora_cfg.rank_levels))
    assert high.size > 0
    exp.server.set_event_scheduler(_straggler_sched(tev, high))
    exp.server.run(12)
    exp.server.drain_pending()
    return exp.server.energy.higher_rank_ratio


@pytest.mark.parametrize("mode", [None, "int8"], ids=["f32", "int8-ef"])
def test_straggler_rank_collapse(mode):
    """``TestStragglerRankCollapse`` on the port alone, on the default
    (factored) backend as the reference runs it: with the high-rank
    clients as stragglers, FlexLoRA's higher-rank energy collapses and
    raFLoRA's holds, also under int8 with error feedback (absolute floor
    0.4). ``chip_smoke.py``'s ``straggler_contrast`` runs the same
    scenario on the kernel backend on the card."""
    tx = None if mode is None else TTx(mode=mode, error_feedback=True)
    ratios = {m: _straggler_energy(m, tx) for m in ("flexlora", "raflora")}
    assert ratios["flexlora"][-1] < 0.5 * ratios["flexlora"][0]
    if mode is None:
        assert ratios["raflora"][-1] > 0.8 * ratios["raflora"][0]
    else:
        assert ratios["raflora"][-1] >= 0.4
    assert ratios["raflora"][-1] > 2.0 * ratios["flexlora"][-1]
