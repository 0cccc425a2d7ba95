"""The port's continuous batcher (``repro_torch.serving.scheduler``), its
serving launcher, example and latency bench, held to the JAX package on
the CPU.

Models are the reduced gemma-2b of ``tests/test_serving.py`` (rank levels
4/8/16) with the reference's weights carried over (``convert.py``), and
tenants' adapters drawn with numpy. The reference's two scheduler
scenarios run through both packages' batchers: each request's tokens
equal the JAX batcher's and an isolated port engine's, and ``stats()``
equals the JAX batcher's bit for bit (virtual time only). A hot-swap
scenario logs one snapshot version per engine call in both packages. The
launcher runs at the reduced size, and the bench's cell at one grid
point gives the reference cell's virtual fields."""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.bench_serve_latency as j_bench
from repro.configs import LoRAConfig as JLoRA
from repro.configs import get_config as j_config
from repro.core.lora import split_lora as j_split
from repro.federation.events import LognormalLatency as JLognormal
from repro.models import build_model
from repro.serving import AdapterStore as JStore
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import ServeRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.benchmarks import bench_serve_latency as t_bench
from repro_torch.configs import LoRAConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.federation.events import LognormalLatency
from repro_torch.launch import serve
from repro_torch.models.transformer import Model
from repro_torch.serving import (AdapterStore, ContinuousBatcher,
                                 ServeRequest, ServingEngine)
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

LEVELS = (4, 8, 16)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def gemma():
    """The reduced gemma-2b of both packages on the reference's weights
    (PRNGKey(0), as ``tests/test_serving.py::attn_setup``), and the
    reference's adapter tree (None at base leaves)."""
    jcfg = j_config("gemma-2b").reduced()
    jm = build_model(jcfg, JLoRA(rank_levels=LEVELS), dtype=jnp.float32,
                     remat=False, block_q=16, block_kv=16)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = Model(get_config("gemma-2b").reduced(),
               LoRAConfig(rank_levels=LEVELS), device="cpu")
    _, jlora = j_split(params)
    return jcfg, jm, params, tm, params_from_numpy(params, "cpu"), jlora


def _tenants(jlora, n, seed, scale=0.05):
    """n random nonzero adapter trees (init has B = 0), numpy leaves."""
    rng = np.random.default_rng(seed)
    return [jax.tree.map(
        lambda x: None if x is None else
        (scale * rng.normal(size=x.shape)).astype(np.float32), jlora,
        is_leaf=lambda x: x is None) for _ in range(n)]


def _stores(tenants):
    """Both packages' stores with ``tenants`` {id: (tree, rank)} put and
    published."""
    js, ts = JStore(LEVELS), AdapterStore(LEVELS)
    for aid, (tree, rank) in tenants.items():
        js.put(aid, tree, rank)
        ts.put(aid, params_from_numpy(tree, "cpu"), rank)
    js.publish()
    ts.publish()
    return js, ts


def _scenario(gemma, tenants, reqs, *, slots, max_len, latency=None,
              swap=None):
    """The same requests through the JAX and the port batcher; ``swap``
    (step, tenant id, tree) publishes a new version of a tenant before
    that scheduler step in both. Returns (JAX batcher, port batcher)."""
    jcfg, jm, params, tm, tparams, _ = gemma
    js, ts = _stores(tenants)
    out = []
    for pkg, store in (("jax", js), ("torch", ts)):
        if pkg == "jax":
            eng = JEngine(jm, params, store, max_len=max_len, slots=slots)
            batcher = JBatcher(eng, latency=latency and JLognormal(*latency),
                               step_cost=0.01, prefill_cost=0.05)
            make = JRequest
        else:
            eng = ServingEngine(tm, tparams, store, max_len=max_len,
                                slots=slots)
            batcher = ContinuousBatcher(
                eng, latency=latency and LognormalLatency(*latency),
                step_cost=0.01, prefill_cost=0.05)
            make = ServeRequest
        for r in reqs:
            batcher.submit(make(**r))
        if swap is None:
            batcher.run()
        else:
            calls = _count_calls(eng)
            at, aid, tree = swap
            while batcher.queue or any(batcher.slots):
                if batcher.steps == at:
                    store.put(aid, tree if pkg == "jax" else
                              params_from_numpy(tree, "cpu"),
                              tenants[aid][1])
                    store.publish()
                if batcher.queue and not any(batcher.slots) \
                        and batcher.queue[0].arrival > batcher.clock.now:
                    batcher.clock.advance(batcher.queue[0].arrival)
                batcher.step()
            batcher.engine_calls = calls
        out.append(batcher)
    return out


def _count_calls(eng):
    """Wrap the engine's admit and decode to log each call's kind."""
    calls = []
    for kind in ("admit", "decode"):
        inner = getattr(eng, kind)

        def logged(*a, _inner=inner, _kind=kind, **k):
            calls.append(_kind)
            return _inner(*a, **k)
        setattr(eng, kind, logged)
    return calls


def _isolated(gemma, store, req, n_new, slots, max_len):
    """A request alone in its own port engine (slot 0)."""
    _, _, _, tm, tparams, _ = gemma
    iso = ServingEngine(tm, tparams, store, max_len=max_len, slots=slots)
    toks = [int(iso.admit([0], np.asarray(req.prompt)[None],
                          [req.adapter_id])[0])]
    mask = np.zeros(slots, bool)
    mask[0] = True
    for _ in range(n_new - 1):
        toks.append(int(iso.decode(mask)[0]))
    return toks


def _assert_same_run(jb, tb):
    """Equal requests (rid order of completion, tokens, admit / first /
    done times) and bit-equal stats."""
    assert [r.rid for r in tb.done] == [r.rid for r in jb.done]
    for jr, tr in zip(jb.done, tb.done):
        assert tr.tokens == jr.tokens, tr.rid
        assert (tr.t_admit, tr.t_first, tr.t_done) == \
            (jr.t_admit, jr.t_first, jr.t_done)
    assert tb.stats() == jb.stats()
    assert tb.steps == jb.steps and tb.clock.now == jb.clock.now


def test_scheduler_matches_isolated_requests_and_jax(gemma):
    """``tests/test_serving.py::test_scheduler_matches_isolated_requests``
    through both packages: 5 requests over 2 slots (tenants at ranks 16
    and 4 alternating, arrivals 0.01 i, 8-token prompts, 4 new tokens):
    slot recycling and interleaved tenants change no request's tokens
    against an isolated port engine, and the run equals the JAX
    batcher's."""
    jcfg = gemma[0]
    hi, lo = _tenants(gemma[5], 2, seed=11)
    lp, n_new, slots = 8, 4, 2
    rng = np.random.default_rng(13)
    reqs = [dict(rid=i, prompt=rng.integers(0, jcfg.vocab_size, size=lp),
                 adapter_id=("hi", "lo")[i % 2], max_new_tokens=n_new,
                 arrival=0.01 * i) for i in range(5)]
    jb, tb = _scenario(gemma, {"hi": (hi, 16), "lo": (lo, 4)}, reqs,
                       slots=slots, max_len=lp + n_new + 1)
    stats = tb.stats()
    assert stats["completed"] == len(reqs)
    assert stats["tokens"] == len(reqs) * n_new
    assert stats["virtual_p95_s"] >= stats["virtual_p50_s"] > 0
    _assert_same_run(jb, tb)
    for req in tb.done:
        assert req.tokens == _isolated(gemma, tb.engine.store, req, n_new,
                                       slots, lp + n_new + 1), req.rid


def test_scheduler_latency_draws_replay_and_match_jax(gemma):
    """``test_scheduler_latency_draws_are_deterministic`` through both
    packages: one tenant at rank 8, lognormal(0.02, 0.3) latency draws, 4
    requests of 3 tokens over 2 slots; the port's stats replay bit for
    bit and equal the JAX batcher's."""
    jcfg = gemma[0]
    (tree,) = _tenants(gemma[5], 1, seed=21)
    rng = np.random.default_rng(22)
    reqs = [dict(rid=i, prompt=rng.integers(0, jcfg.vocab_size, size=8),
                 adapter_id="t", max_new_tokens=3, arrival=0.02 * i)
            for i in range(4)]
    runs = [_scenario(gemma, {"t": (tree, 8)}, reqs, slots=2, max_len=12,
                      latency=(0.02, 0.3, 0)) for _ in range(2)]
    (jb, tb), (_, tb2) = runs
    _assert_same_run(jb, tb)
    assert tb2.stats() == tb.stats()


def test_hot_swap_one_version_per_engine_call(gemma):
    """6 requests over 2 slots (tenants at ranks 16 and 8), tenant "a"
    republished before scheduler step 4: the port's engine logs one
    snapshot version per engine call, both versions appear, no call
    after the publish reads the old one, and the log, the tokens and the
    stats equal the JAX batcher's."""
    jcfg = gemma[0]
    a, b, a2 = _tenants(gemma[5], 3, seed=31)
    rng = np.random.default_rng(32)
    reqs = [dict(rid=i, prompt=rng.integers(0, jcfg.vocab_size, size=6),
                 adapter_id=("a", "b")[i % 2], max_new_tokens=4,
                 arrival=0.015 * i) for i in range(6)]
    jb, tb = _scenario(gemma, {"a": (a, 16), "b": (b, 8)}, reqs, slots=2,
                       max_len=11, latency=(0.02, 0.25, 0),
                       swap=(4, "a", a2))
    log = tb.engine.version_log
    assert len(log) == len(tb.engine_calls)
    assert set(log) == {1, 2}
    flip = log.index(2)
    assert log == [1] * flip + [2] * (len(log) - flip)
    assert log == jb.engine.version_log
    assert tb.engine_calls == jb.engine_calls
    _assert_same_run(jb, tb)


def test_serve_launcher_and_example(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` at the reduced
    qwen2-7b: one line with the reference's fields (2 tenants at the two
    highest rank levels, version 1) and two requests' tokens; an
    encoder-only arch has no decode path; the example is the launcher."""
    from repro_torch.examples import serve_finetuned
    assert serve_finetuned.main is serve.main
    assert serve.main(["--device", "cpu", "--prompt-len", "8", "--tokens",
                       "4", "--batch", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(
        r"arch=qwen2-7b-reduced batch=3 tenants=2 ranks=\(8, 16\) "
        r"adapter_v1 prefill\(8 toks\)=[0-9.]+s decode\(4 toks\)=[0-9.]+s "
        r"\[[0-9.]+ tok/s\]", lines[0]), lines[0]
    assert len(lines) == 3 and lines[1].startswith("  req0 [tenant0]: [")
    assert len(json.loads(lines[1].split(": ", 1)[1])) == 4
    assert serve.main(["--arch", "hubert-xlarge", "--device", "cpu"]) == 1


VIRTUAL = ("batch", "adapters", "swap_every", "requests", "swaps",
           "versions_seen", "completed", "tokens",
           "virtual_throughput_tok_per_s", "virtual_p50_s", "virtual_p95_s",
           "virtual_ttft_p50_s", "virtual_elapsed_s", "steps")


def test_bench_cell_matches_reference_and_writes_its_own_artifact(
        gemma, tmp_path, monkeypatch):
    """bench_serve_latency's cell at batch 2, 4 adapters, a swap every 4
    steps: every virtual field equal to the reference's ``_run_cell``
    (its ``run`` is never called: it rewrites the tracked
    ``BENCH_serve_latency.json``); ``run`` at one grid point writes only
    its own artifact."""
    jcfg, jm, params, _, _, jlora = gemma
    want = j_bench._run_cell(jm, params, jlora, batch=2, n_adapters=4,
                             swap_every=4, vocab=jcfg.vocab_size)
    cfg, _, model = t_bench._build_model("cpu")
    tparams = model.init(torch.Generator().manual_seed(0))
    from repro_torch.core.lora import split_lora
    _, tlora = split_lora(tparams)
    got = t_bench._run_cell(model, tparams, tlora, batch=2, n_adapters=4,
                            swap_every=4, vocab=cfg.vocab_size)
    assert got["swaps"] == 2 and got["versions_seen"] == [1, 2, 3]
    assert {k: got[k] for k in VIRTUAL} == {k: want[k] for k in VIRTUAL}

    assert t_bench.ARTIFACT == os.path.join(ROOT, "build", "bench_torch",
                                            "serve_latency.json")
    tracked = os.path.join(ROOT, "BENCH_serve_latency.json")
    with open(tracked, "rb") as f:
        before = f.read()
    art = tmp_path / "serve_latency.json"
    monkeypatch.setattr(t_bench, "ARTIFACT", str(art))
    res = t_bench.run(batches=(2,), adapter_counts=(1,), swap_rates=(0,),
                      device="cpu")
    assert json.loads(art.read_text())["rows"] == res["rows"]
    with open(tracked, "rb") as f:
        assert f.read() == before
