"""The buffered server's round-latency studies of the port
(``repro_torch.benchmarks.bench_round_latency``: the async engine, the
transport and the event sweep) held to the JAX package's, as
``test_torch_bench_latency.py`` holds the engines' studies; a file of
its own so that the tier-1 run's ``--dist loadfile`` runs the two on two
workers."""
import pytest

from test_torch_bench_latency import _names, check_study, j_latency, t_latency
from test_torch_bench_latency import latency  # noqa: F401  (fixture)
from test_torch_benches import recorder  # noqa: F401  (fixture)


@pytest.mark.parametrize("study,kw", [
    ("run_async", dict(rounds=1, warmup=0, depths=(2,),
                       rounds_per_block=2, d_model=32)),
    ("run_transport", dict(rounds=1, warmup=0)),
], ids=["async", "transport"])
def test_round_latency_study_matches_reference(study, kw, latency):
    """One timed round (a block of two for async depth 2): the same rows
    and artifact keys; the transport's bytes exactly; the momentum audit's
    counts equal."""
    check_study(study, kw, latency)


def test_round_latency_event_matches_reference(latency):
    """The event sweep at one round and the drain, straggler fraction
    0.5, each trigger: the same fires, updates, staleness and virtual times, the
    final energy at atol 1e-3."""
    j_res = j_latency.run_event(rounds=1, straggler_fracs=(0.5,))
    t_res = t_latency.run_event(rounds=1, straggler_fracs=(0.5,),
                                device="cpu")
    t_names, j_names = _names()
    assert t_names == j_names
    assert len(t_res["rows"]) == len(j_res["rows"]) == 3
    for t, j in zip(t_res["rows"], j_res["rows"]):
        for key in ("trigger", "straggler_frac", "aggregations",
                    "updates_aggregated", "max_staleness", "rounds"):
            assert t[key] == j[key], key
        assert t["virtual_time_total"] == pytest.approx(
            j["virtual_time_total"], rel=1e-12)
        assert abs(t["final_higher_rank_energy"]
                   - j["final_higher_rank_energy"]) <= 1e-3
