"""The port's host-cost counters (``repro_torch.analysis.host_cost``)
against the reference's: the shim's lifecycle and accounting (the
reference's unit tests, on the port's copy), the hooks on the port's
round path counting the same loops as the reference's on the same
experiment, label for label, per-round host cost independent of the
registry size, and sampling through the instrumented registry bit-equal
to a direct ``rng.choice``. The two packages' monitors each patch the
``numpy`` module, so they run one after the other, never nested."""
import numpy as np
import pytest
import torch

from repro_torch.analysis import host_cost
from repro_torch.analysis.host_cost import HostCostMonitor, measure_rounds

torch.set_num_threads(1)


class TestShim:
    def test_inactive_hooks_are_noops(self):
        host_cost.tick("nobody/listening", 100)
        host_cost.alloc("nobody/listening", 1 << 20)
        mon = HostCostMonitor()
        assert mon.total_loop_iters == 0
        assert mon.total_alloc_bytes == 0

    def test_tick_and_alloc_accumulate_under_monitor(self):
        with HostCostMonitor() as mon:
            host_cost.tick("loop/a", 5)
            host_cost.tick("loop/a", 3)
            host_cost.alloc("buf", 64)
        assert mon.loop_iters == {"loop/a": 8}
        assert mon.alloc_bytes == {"buf": 64}

    def test_numpy_constructors_traced_and_restored(self):
        orig_zeros = np.zeros
        with HostCostMonitor() as mon:
            np.zeros((16,), np.float32)          # 64 B
            np.asarray([1.0, 2.0])               # 16 B
        assert np.zeros is orig_zeros            # patch undone on exit
        assert mon.alloc_bytes["np.zeros"] == 64
        assert mon.alloc_bytes["np.asarray"] == 16
        before = mon.total_alloc_bytes
        np.zeros((1024,))                        # monitor closed: unseen
        assert mon.total_alloc_bytes == before

    def test_mark_isolates_phase_deltas(self):
        with HostCostMonitor() as mon:
            host_cost.tick("x", 2)
            mon.mark("round0")
            host_cost.tick("x", 7)
            host_cost.alloc("y", 10)
            mon.mark("round1")
        p0, p1 = mon.phases
        assert (p0.loop_iters, p0.alloc_bytes) == (2, 0)
        assert (p1.loop_iters, p1.alloc_bytes) == (7, 10)
        assert p1.loop_detail == {"x": 7}

    def test_nesting_raises(self):
        with HostCostMonitor():
            with pytest.raises(RuntimeError, match="nested"):
                with HostCostMonitor():
                    pass


class TestRegistryHooks:
    def test_sample_round_preserves_rng_stream(self):
        """A tick consumes no rng draw: sampling through the instrumented
        registry (under a monitor, so the tick is live) is bit-equal to a
        direct rng.choice."""
        from repro_torch.configs.base import FLConfig, LoRAConfig
        from repro_torch.federation.topology import ClientRegistry
        fl = FLConfig(num_clients=12)
        lora = LoRAConfig(rank_levels=(4, 8), rank_probs=(0.5, 0.5))
        shards = [np.arange(i, i + 3) for i in range(12)]
        reg = ClientRegistry.create(fl, lora, shards)
        expected = np.random.default_rng(7).choice(12, size=5,
                                                   replace=False)
        with HostCostMonitor() as mon:
            got = reg.sample_round(5, np.random.default_rng(7))
            pool = reg.sample_round(3, np.random.default_rng(7),
                                    active=np.arange(6))
        np.testing.assert_array_equal(got, expected)
        np.testing.assert_array_equal(
            pool, np.random.default_rng(7).choice(6, size=3, replace=False))
        assert mon.loop_iters == {"registry/sample": 5,
                                  "registry/active_pool": 6}

    def test_add_client_ticks(self):
        from repro_torch.configs.base import FLConfig, LoRAConfig
        from repro_torch.federation.topology import ClientRegistry
        fl = FLConfig(num_clients=4)
        lora = LoRAConfig(rank_levels=(4, 8), rank_probs=(0.5, 0.5))
        reg = ClientRegistry.create(fl, lora,
                                    [np.arange(3) for _ in range(4)])
        with HostCostMonitor() as mon:
            assert reg.add_client(8, np.arange(2)) == 4
        assert mon.loop_iters == {"registry/add_client": 1}


EXPERIMENT = dict(
    fl_overrides={"num_rounds": 60, "num_clients": 16,
                  "participation": 0.5, "partition": "iid"},
    lora_overrides={"rank_levels": (8,), "rank_probs": (1.0,)},
    num_classes=4, d_model=32, samples_per_class=20, batches_per_round=1,
    backend="factored")


def _phases(monitor_cls, server, rounds=3):
    with monitor_cls() as mon:
        for r in range(rounds):
            server.run_round()
            server.flush_stats()
            mon.mark(f"round{r}")
    return mon.phases


def _without_unused_weights(ref_detail):
    """The reference's loop counts less the one loop the port skips: the
    reference's grouped aggregation computes ``cohort_weights`` over its
    members at every aggregation and uses them only for DoRA magnitudes;
    the port computes them only when the model has magnitudes. That is
    one ``agg/weight_counts`` pass of ``server/agg_members`` clients."""
    detail = dict(ref_detail)
    if "server/agg_members" in detail:
        detail["agg/weight_counts"] -= detail["server/agg_members"]
    return detail


def test_loop_counts_equal_reference_label_for_label():
    """The same tiny raFLoRA experiment in both packages, three rounds
    under each package's monitor (one after the other): every phase's
    per-label loop counts are equal (less the reference's unused cohort
    weights), and every hook on the path fired."""
    from repro.analysis.host_cost import HostCostMonitor as RefMonitor
    from repro.federation.experiment import build_experiment as ref_build
    from repro_torch.federation.experiment import build_experiment
    port = _phases(HostCostMonitor,
                   build_experiment("raflora", device="cpu",
                                    **EXPERIMENT).server)
    ref = _phases(RefMonitor, ref_build("raflora", **EXPERIMENT).server)
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        want = _without_unused_weights(r.loop_detail)
        assert p.loop_detail == want, (p.label, p.loop_detail, want)
        assert p.loop_iters == sum(want.values())
    assert set(port[-1].loop_detail) == {
        "registry/sample", "server/plan_clients", "server/train_groups",
        "server/train_stack_steps", "server/agg_members",
        "server/agg_buckets", "agg/weight_counts"}


def test_event_engine_loop_counts_equal_reference():
    """The event engine's hooks (dispatch, the book scan, the ready sets)
    count the same loops in both packages."""
    from repro.analysis.host_cost import HostCostMonitor as RefMonitor
    from repro.federation import events as ref_events
    from repro.federation.experiment import build_experiment as ref_build
    from repro_torch.federation import events
    from repro_torch.federation.experiment import build_experiment

    def sched(ev):
        return ev.EventScheduler(ev.ConstantLatency(1.0),
                                 ev.CountTrigger(4))

    kw = dict(EXPERIMENT, round_engine="async", pipeline_depth=1)
    port = _phases(HostCostMonitor, build_experiment(
        "raflora", device="cpu", event_scheduler=sched(events),
        **kw).server, rounds=4)
    ref = _phases(RefMonitor, ref_build(
        "raflora", event_scheduler=sched(ref_events), **kw).server,
        rounds=4)
    for p, r in zip(port, ref):
        want = _without_unused_weights(r.loop_detail)
        assert p.loop_detail == want, (p.label, p.loop_detail, want)
    assert {"events/dispatch", "events/book_scan", "events/ready"} <= set(
        port[-1].loop_detail)


def test_1k_vs_100k_registered_clients():
    """Growing the registry 100x at a fixed cohort leaves per-round loop
    iterations EXACTLY equal and per-round allocated bytes within 1%."""
    from repro_torch.federation.experiment import build_experiment
    exp = build_experiment("raflora", device="cpu", **EXPERIMENT)
    exp.registry.inflate(1_000)
    small = measure_rounds(exp.server, rounds=3, warmup=1)
    exp.registry.inflate(100_000)
    large = measure_rounds(exp.server, rounds=3, warmup=1)
    assert large["loop_iters"] == small["loop_iters"]
    assert large["alloc_bytes"] == pytest.approx(small["alloc_bytes"],
                                                 rel=0.01)
    detail = large["phases"][-1]["loop_detail"]
    for label in ("registry/sample", "server/plan_clients",
                  "server/agg_members"):
        assert detail.get(label, 0) > 0, detail
