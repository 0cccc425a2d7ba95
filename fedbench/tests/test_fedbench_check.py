"""The harness's check on the CPU at small sizes: the port agrees with the
plain reference, and a run whose measured path is broken underneath
comes out not correct, once for each fault the cell can have. These runs
skip the harness's look for a card and drive the rest of a run."""
import pytest
import torch

from fedbench import harness
from fedbench.tests import tiny

SEED = 2 ** 31 + 7
# f32 on the CPU: the round's numbers stay within these of the reference
# (the kernel backend's Gram route squares the stacks' condition, so its
# products and spectra keep about half of f32's digits)
ROUND_CPU = {"loss": 1e-5, "grad": 1e-4, "client": 2e-3, "approx": 2e-3,
             "sigma": 2e-3, "change": 2e-3}


def round_run(traffic, fault=None, trace=False):
    """The round cell's run at small sizes under traffic mix ``traffic``
    (``paper_cohort``, kept for the cell that the eigensolver's fault
    keeps out, runs through the same cell's limits)."""
    return harness.run_cell("vit_base.local_epoch", SEED, 0.01, trace,
                            device="cpu", fault=fault,
                            cfg=tiny.vit_config(),
                            traffic=tiny.round_traffic(traffic))


def serve_run(cell, fault=None, trace=False):
    traffic = cell.split(".")[1]
    return harness.run_cell(cell, SEED, 1.0, trace, device="cpu",
                            fault=fault, cfg=tiny.decoder_config(),
                            traffic=tiny.serve_traffic(traffic))


ROUND_MIXES = ["paper_cohort", "local_epoch"]
SERVE_CELLS = ["nemotron_4_340b.decode_batch",
               "nemotron_4_340b.prefill_heavy"]


@pytest.mark.parametrize("traffic", ROUND_MIXES)
def test_round_agrees_with_reference(traffic):
    out = round_run(traffic)
    for k, tol in ROUND_CPU.items():
        assert out["checks"][k]["value"] <= tol, (k, out["checks"])
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "round_ms"}


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serving_agrees_with_reference(cell):
    out = serve_run(cell)
    # f32 on the CPU: every served token is the reference's first choice
    # but for rounding
    assert out["checks"]["gap"]["value"] <= 1e-4, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {"setup_s", "serve_tok_per_s"}
    if cell.endswith("prefill_heavy"):
        want.add("ttft_p95_ms")
    assert set(out["metrics"]) == want


def test_traced_round_reports_its_per_layer_metrics():
    out = round_run("local_epoch", trace=True)
    # no device on the CPU: the trace's readers find nothing and stay out
    assert {"train_ms.round", "aggregate_ms.round", "round_mfu"} <= \
        set(out["metrics"])
    assert "busy_s" in out["device"] and "breakdown" in out


# -- planted faults: each must make the run come out not correct ----------------

def state_unchanged(cell):
    """Local training returns the factors it was given."""
    s = cell.server
    trainer = s.trainer
    orig = trainer.train_group_masked

    def same(base, global_lora, ranks, stacks, lr):
        return orig(base, global_lora, ranks, stacks, 0.0)
    trainer.train_group_masked = same


def half_batch(cell):
    """Each local step sees the first half of its rows, its loss the mean
    over them."""
    model = cell.model
    orig = model.train_loss_clients

    def half(base, lora_c, batch, scales, **k):
        n = next(iter(batch.values())).shape[1] // 2
        return orig(base, lora_c, {key: v[:, :n] for key, v in
                                   batch.items()}, scales, **k)
    model.train_loss_clients = half


def token_altered(cell):
    """The window's second decode step's tokens move to the next id."""
    eng = cell.engine
    orig = eng.decode
    calls = {"n": 0}
    v = cell.cfg["vocab_size"]

    def decode(mask):
        toks = orig(mask)
        calls["n"] += 1
        if calls["n"] == 2 + 3:          # after the warm-up's 3 steps
            toks = (toks + 1) % v
            eng.tokens = toks
        return toks
    eng.decode = decode


def cache_unchanged(cell):
    """A decode step leaves the KV cache as it found it."""
    eng = cell.engine
    orig = eng.decode

    def decode(mask):
        cache = eng.cache
        toks = orig(mask)
        eng.cache = {"layers": cache["layers"], "len": eng.cache["len"]}
        return toks
    eng.decode = decode


def in_window(fault):
    """``fault``, planted once set-up's checked rounds have run, so that
    only the window's rounds have it."""
    def plant(cell):
        orig = cell._capture

        def capture(rounds):
            out = orig(rounds)
            fault(cell)
            return out
        cell._capture = capture
    return plant


ROUND_FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
                "state_unchanged_in_window": in_window(state_unchanged),
                "half_batch_in_window": in_window(half_batch)}


@pytest.mark.parametrize("traffic", ROUND_MIXES)
@pytest.mark.parametrize("fault", list(ROUND_FAULTS.values()),
                         ids=list(ROUND_FAULTS))
def test_round_fault_is_not_correct(traffic, fault):
    out = round_run(traffic, fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), \
        out["checks"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
@pytest.mark.parametrize("fault", [token_altered, cache_unchanged],
                         ids=["token_altered", "cache_unchanged"])
def test_serving_fault_is_not_correct(cell, fault):
    out = serve_run(cell, fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), \
        out["checks"]
