"""Serving launcher: multi-tenant batched greedy decoding with the
fine-tuned adapters (DESIGN.md §11), ported from ``repro/launch/serve.py``
with the same flags plus ``--device`` (default: the card; ``cpu`` runs
the plain PyTorch path on request, and without CUDA the default raises).

Runs the serving subsystem end to end at the architecture's reduced
size -- adapters are staged in an ``AdapterStore`` (paged,
rank-bucketed, versioned) and a ``ServingEngine`` prefills the KV/SSM
cache up front at full ``max_len`` via ``Model.init_cache`` (path-aware
seeding; SSM ``conv``/``ssm`` states transfer correctly), then decodes
token-by-token.

The serving rank is DERIVED from the LoRA config (``r_max``) -- never
hardcoded -- so train-side rank-level changes cannot desync serving.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --tokens 32 [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--tenants", type=int, default=2,
                    help="number of adapter pages to serve across the batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import flatten, split_lora, unflatten
    from repro_torch.models.transformer import Model
    from repro_torch.serving import AdapterStore, ServingEngine

    cfg = get_config(args.arch).reduced()
    if not cfg.supports_decode:
        print(f"{args.arch} is encoder-only; no decode path")
        return 1
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    model = Model(cfg, lora, device=args.device, dtype=torch.float32,
                  remat=False)
    # independent streams: params (torch) and prompts (numpy) never share
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    _, lora_tree = split_lora(params)

    # stage one tenant per rank level (cycled), highest level = the config's
    # serving rank r_max -- derived, never hardcoded
    store = AdapterStore(lora.rank_levels, scaling_fn=lora.scaling)
    levels = sorted(lora.rank_levels, reverse=True)
    for t in range(max(1, args.tenants)):
        perturb = unflatten({p: x + 0.01 * t
                             for p, x in flatten(lora_tree).items()})
        store.put(f"tenant{t}", perturb, levels[t % len(levels)])
    store.publish()

    b, lp = args.batch, args.prompt_len
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(b, lp))
    engine = ServingEngine(model, params, store,
                           max_len=lp + args.tokens, slots=b)
    tenant_of = [f"tenant{i % max(1, args.tenants)}" for i in range(b)]

    def sync():   # the clock is read after the card has finished
        if model.device.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.time()   # host-clock: ok (CLI wall phase timing, off the round path)
    first = engine.admit(range(b), prompts, tenant_of)
    sync()
    t_prefill = time.time() - t0   # host-clock: ok (CLI wall phase timing)

    generated = [first]
    active = np.ones((b,), bool)
    t0 = time.time()   # host-clock: ok (CLI wall phase timing)
    for _ in range(args.tokens - 1):
        generated.append(engine.decode(active).clone())
    seqs = torch.stack(generated, dim=1).cpu().numpy()
    t_decode = time.time() - t0   # host-clock: ok (CLI wall phase timing)
    print(f"arch={cfg.name} batch={b} tenants={store.published.num_pages} "
          f"ranks={store.published.ranks} adapter_v{store.published.version} "
          f"prefill({lp} toks)={t_prefill:.2f}s "
          f"decode({args.tokens} toks)={t_decode:.2f}s "
          f"[{args.tokens * b / max(t_decode, 1e-9):.1f} tok/s]")
    for i in range(min(b, 2)):
        print(f"  req{i} [{tenant_of[i]}]: {seqs[i].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
