"""Driver of the serving cells: the port's ``ServingEngine`` under a closed
loop of clients, one slot each.

Set-up draws the base weights and the tenants' adapters in the served
dtype, stages every tenant in an ``AdapterStore`` (one page each, ranks
cycled over the levels), builds the engine with room for the longest
request, and warms it up with one admit of every slot and a few decode
steps: the cell's only shapes. The window then loops: every slot whose
client has a request waiting is admitted in one ``admit`` (each client's
next request is due when its previous one completes), and one ``decode``
advances every slot that still owes tokens. Every token is read back to
the host as it is made, as a server streams it.

The check samples finished requests, the longest among them, and runs the
reference over each prompt with its served tokens (``numbers``).
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from fedbench import counts, port, workload
from fedbench.drivers import patched
from fedbench.reference.decoder import Decoder

TRACE_SECONDS = 4.0   # the opening seconds of a traced run's window
WARM_STEPS = 3


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 fault=None):
        self.cfg, self.tr, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.fault = fault
        self.failures = []
        self.trace = None

    def setup(self) -> None:
        from repro_torch.configs import LoRAConfig
        from repro_torch.models.transformer import Model
        from repro_torch.serving import AdapterStore, ServingEngine

        cfg, tr, dev = self.cfg, self.tr, self.device
        dtype = getattr(torch, cfg["dtype"])
        serving = cfg["serving"]
        levels = tuple(serving["rank_levels"])
        lora = LoRAConfig(rank_levels=levels,
                          rank_probs=(1.0 / len(levels),) * len(levels))
        model = Model(port.model_config(cfg), lora, device=dev, dtype=dtype,
                      use_kernels=True)
        shapes = {p: tuple(t.shape) for p, t in
                  workload.leaves(model.param_shapes()).items()}
        is_lora = ("lora_a", "lora_b")
        base = workload.draw_tree(
            {p: s for p, s in shapes.items() if p[-1] not in is_lora},
            workload.generator(self.seed, 0, dev), dtype, dev)
        self.base = workload.build(base)
        self.fingerprint = self._fingerprint()
        n_tenants = tr["tenants"]
        lora_shapes = {p: s for p, s in shapes.items() if p[-1] in is_lora}
        tflat = workload.draw_tree(
            {(t,) + p: s for t in range(n_tenants)
             for p, s in lora_shapes.items()},
            workload.generator(self.seed, 5, dev), dtype, dev,
            rule=workload.tenant_rule)
        self.tenants = [workload.build({p[1:]: v for p, v in tflat.items()
                                        if p[0] == t})
                        for t in range(n_tenants)]
        self.tenant_ranks = [levels[t % len(levels)]
                             for t in range(n_tenants)]
        store = AdapterStore(levels)
        for t in range(n_tenants):
            store.put(t, self.tenants[t], self.tenant_ranks[t])
        store.publish()
        self.slots = tr["slots"]
        self.max_len = tr["prompt_len"] + tr["out_max"]
        self.engine = ServingEngine(model, self.base, store,
                                    max_len=self.max_len, slots=self.slots)
        if self.fault is not None:
            self.fault(self)
        warm = workload.Requests(self.seed + 1, tr["traffic_seed"] + 1,
                                 self.slots, tr["prompt_len"], 1, 1,
                                 n_tenants, cfg["vocab_size"])
        reqs = [warm.next(c) for c in range(self.slots)]
        self.engine.admit(range(self.slots),
                          np.stack([r["prompt"] for r in reqs]),
                          [r["tenant"] for r in reqs]).cpu()
        active = torch.ones(self.slots, dtype=torch.bool, device=dev)
        for _ in range(WARM_STEPS):
            self.engine.decode(active).cpu()
        self.requests = workload.Requests(
            self.seed, tr["traffic_seed"], self.slots, tr["prompt_len"],
            tr["out_min"], tr["out_max"], n_tenants, cfg["vocab_size"])

    def _fingerprint(self) -> float:
        return workload.fingerprint(self.base)

    # -- the window -------------------------------------------------------------

    def window(self, seconds: float, trace: bool) -> dict:
        eng, dev, s = self.engine, self.device, self.slots
        rec = {"decode_s": [], "decode_bound_s": [], "admit_s": [],
               "admit_flops": [], "k4_bound_s": 0.0, "tracing": False}
        self.records = []
        live = [None] * s               # the request in each slot
        due = [0.0] * s                 # when each client's next is due
        tracer = None
        stack = contextlib.ExitStack()
        if trace:
            stack.enter_context(self._instrument(rec))
        with stack:
            if trace:       # the profiler's start takes seconds: before t0
                from fedbench.trace import Tracer
                tracer = Tracer(torch)
                tracer.__enter__()
                rec["tracing"] = True
            t0 = time.perf_counter()
            due = [t0] * s
            while True:
                now = time.perf_counter()
                if now - t0 >= seconds:
                    break
                if tracer is not None and rec["tracing"] and \
                        now - t0 >= TRACE_SECONDS:
                    tracer.__exit__(None, None, None)
                    rec["tracing"] = False
                waiting = [c for c in range(s) if live[c] is None]
                if waiting:
                    reqs = [self.requests.next(c) for c in waiting]
                    t = time.perf_counter()
                    first = eng.admit(waiting,
                                      np.stack([r["prompt"] for r in reqs]),
                                      [r["tenant"] for r in reqs]).cpu()
                    t1 = time.perf_counter()
                    rec["admit_s"].append(t1 - t)
                    rec["admit_flops"].append(sum(
                        counts.prefill_row_flops(
                            self.cfg, self.tr["prompt_len"],
                            self.tenant_ranks[r["tenant"]]) for r in reqs))
                    for c, r, tok in zip(waiting, reqs, first.tolist()):
                        r.update(client=c, due=due[c], first_t=t1,
                                 tokens=[tok], done_t=None)
                        self.records.append(r)
                        live[c] = r
                        self._maybe_done(c, live, due, t1)
                active = [c for c in range(s) if live[c] is not None]
                if not active:
                    continue
                mask = torch.zeros(s, dtype=torch.bool, device=dev)
                mask[active] = True
                lens = [self.tr["prompt_len"] + len(live[c]["tokens"]) - 1
                        for c in active]
                ranks = [self.tenant_ranks[live[c]["tenant"]]
                         for c in active]
                pages = {live[c]["tenant"]: self.tenant_ranks[live[c]
                                                              ["tenant"]]
                         for c in active}
                t = time.perf_counter()
                toks = eng.decode(mask).cpu().tolist()
                t1 = time.perf_counter()
                rec["decode_s"].append(t1 - t)
                rec["decode_bound_s"].append(counts.bound_s(
                    *counts.decode_step_work(self.cfg, lens, ranks,
                                             list(pages.values())),
                    counts.PEAK_BF16_FLOPS))
                for c in active:
                    live[c]["tokens"].append(toks[c])
                    self._maybe_done(c, live, due, t1)
            if tracer is not None and rec["tracing"]:
                tracer.__exit__(None, None, None)
                rec["tracing"] = False
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            rec["elapsed_s"] = time.perf_counter() - t0
        rec["tokens"] = sum(len(r["tokens"]) for r in self.records)
        rec["requests"] = len(self.records)
        rec["ttft_s"] = [r["first_t"] - r["due"] for r in self.records]
        if tracer is not None:
            rec["traced_window_s"] = tracer.window_s
            self.trace = tracer.read()
        return rec

    def _maybe_done(self, c, live, due, t):
        r = live[c]
        if len(r["tokens"]) >= r["out_len"]:
            r["done_t"] = t
            live[c] = None
            due[c] = t

    @contextlib.contextmanager
    def _instrument(self, rec: dict):
        """Host ranges around admit and decode, and around every K4 call
        that a decode step makes, whose work is counted from its shapes."""
        from torch.profiler import record_function
        from repro_torch.models.layers import dense
        state = {"in_decode": False}

        def ranged(name, flag=None):
            def make(fn):
                def wrapper(*a, **k):
                    if flag:
                        state[flag] = True
                    try:
                        with record_function("fedbench::" + name):
                            return fn(*a, **k)
                    finally:
                        if flag:
                            state[flag] = False
                return wrapper
            return make

        def k4(fn):
            def wrapper(x, w, a, b, scales, ids):
                if not state["in_decode"]:
                    return fn(x, w, a, b, scales, ids)
                if rec["tracing"]:
                    rows = x.shape[0] * x.shape[1]
                    rec["k4_bound_s"] += counts.bound_s(*counts.k4_work(
                        rows, w.shape[0], w.shape[1], a.shape[-2],
                        a.shape[0], x.element_size()),
                        counts.PEAK_BF16_FLOPS)
                with record_function("fedbench::k4.decode"):
                    return fn(x, w, a, b, scales, ids)
            return wrapper

        with patched([(self.engine, "admit", ranged("admit")),
                      (self.engine, "decode", ranged("decode", "in_decode")),
                      (dense, "batched_lora_apply", k4)]):
            yield

    # -- the check --------------------------------------------------------------

    def release(self) -> None:
        self.engine = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """Finished requests drawn from the seed, the longest first."""
        done = [r for r in self.records if r["done_t"] is not None]
        if not done:
            return []
        longest = max(range(len(done)), key=lambda i: len(done[i]["tokens"]))
        rest = [i for i in range(len(done)) if i != longest]
        rng = workload.host_rng(self.seed, 7)
        k = min(len(rest), self.tr["checked_requests"] - 1)
        pick = [longest] + list(rng.choice(rest, size=k, replace=False))
        return [done[i] for i in pick]

    def numbers_for(self, reqs: list, served: list, fp8: bool = False
                    ) -> dict:
        """``gap``: the widest margin by which a served token's logit lies
        below the reference's best at its position. ``served[i]`` are
        request i's tokens; with ``fp8`` the control's own first choices
        at the same positions stand in for them."""
        dev = self.device
        v = self.cfg["vocab_size"]
        seqs, pos = [], []
        for r, toks in zip(reqs, served):
            if any(t < 0 or t >= v for t in toks):
                return {"gap": float("inf")}
            seqs.append(torch.as_tensor(np.concatenate(
                [r["prompt"], np.asarray(toks[:-1], np.int64)]),
                device=dev))
            lp = len(r["prompt"])
            pos.append(list(range(lp - 1, lp - 1 + len(toks))))
        tenants = [self.tenants[r["tenant"]] for r in reqs]
        ranks = [self.tenant_ranks[r["tenant"]] for r in reqs]
        with _ieee():
            ref = Decoder(self.cfg, self.base).logits(seqs, tenants, ranks,
                                                      pos)
            if fp8:
                ctl = Decoder(self.cfg, self.base, fp8=True).logits(
                    seqs, tenants, ranks, pos)
                pick = ctl.argmax(-1)
                del ctl
            else:
                pick = torch.as_tensor(np.concatenate(served), device=dev)
        gaps = ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]
        return {"gap": float(gaps.max())}

    def check(self) -> dict:
        if abs(self._fingerprint() - self.fingerprint) > 0:
            self.failures.append("the base weights changed under the "
                                 "program")
        reqs = self.sample()
        if not reqs:
            self.failures.append("no request finished in the window")
            return {"gap": float("inf")}
        return self.numbers_for(reqs, [r["tokens"] for r in reqs])


@contextlib.contextmanager
def _ieee():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
