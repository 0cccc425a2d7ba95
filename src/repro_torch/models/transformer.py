"""The encoder of the federated round (port of the ``kind="vlm"`` path of
``repro/models/transformer.py``: vision frontend projection, bidirectional
attention, GELU MLP, LoRA on q/k/v/o/up/down).

Parameters keep the JAX package's tree and layouts at the public
boundary: ``w (in, out)``, ``lora_a (L, r, in)``, ``lora_b (L, out, r)``,
per-layer leaves stacked on axis 0 under ``params["layers"]``.

Training many clients at once writes the client axis out as a batch
dimension: ``train_loss_clients`` takes the shared base tree, a LoRA tree
whose leaves carry a leading client axis C, batches with a leading C and
per-client scales, and returns per-client losses. Client k's loss depends
on its own factors only, so the gradient of the summed loss is every
client's own gradient. ``train_loss`` is the single-model C = 1 case.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ATTN_BIDIR, LoRAConfig, ModelConfig
from repro_torch.core.lora import split_lora
from repro_torch.device import resolve_device
from repro_torch.models.layers.attention import bidirectional_attention
from repro_torch.models.layers.dense import dense_apply, dense_init
from repro_torch.models.layers.mlp import mlp_apply, mlp_init
from repro_torch.models.layers.norms import rms_norm, rms_norm_init


def _lora_ranks_for(cfg: ModelConfig, lora: Optional[LoRAConfig]) -> dict:
    if lora is None:
        return {}
    return {t: lora.r_max for t in cfg.lora_targets}


def _index(tree: dict, fn) -> dict:
    return {k: (_index(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and k in out else v
    return out


class Model:
    """Functional model over parameter trees (nested dicts of tensors)."""

    def __init__(self, cfg: ModelConfig, lora: Optional[LoRAConfig] = None,
                 *, device=None, dtype=torch.float32):
        unsupported = []
        if cfg.moe is not None or cfg.mla is not None or cfg.ssm is not None:
            unsupported.append("MoE / MLA / SSM mixers")
        if cfg.attn_type != ATTN_BIDIR:
            unsupported.append(f"attn_type={cfg.attn_type!r}")
        if cfg.rope_type != "none":
            unsupported.append(f"rope_type={cfg.rope_type!r}")
        if cfg.logit_softcap or cfg.tie_embeddings:
            unsupported.append("logit softcap / tied embeddings")
        if cfg.frontend.kind == "none":
            unsupported.append("token inputs")
        if lora is not None and lora.variant != "lora":
            unsupported.append(f"PEFT variant {lora.variant!r}")
        if unsupported:
            raise NotImplementedError(
                f"{', '.join(unsupported)} not ported yet (ROADMAP.md "
                "queue 1 item 10)")
        self.cfg = cfg
        self.lora = lora
        self.device = resolve_device(device)
        self.dtype = dtype
        self.lora_ranks = _lora_ranks_for(cfg, lora)

    # -- init -----------------------------------------------------------------

    def _layer_init(self, gen: torch.Generator) -> dict:
        cfg, lr = self.cfg, self.lora_ranks
        kw = dict(dtype=self.dtype, device=self.device)
        hd = cfg.resolved_head_dim
        q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd
        return {
            "norm1": rms_norm_init(cfg.d_model, **kw),
            "attn": {
                "q": dense_init(gen, cfg.d_model, q_out, bias=cfg.qkv_bias,
                                lora_rank=lr.get("q_proj", 0), **kw),
                "k": dense_init(gen, cfg.d_model, kv_out, bias=cfg.qkv_bias,
                                lora_rank=lr.get("k_proj", 0), **kw),
                "v": dense_init(gen, cfg.d_model, kv_out, bias=cfg.qkv_bias,
                                lora_rank=lr.get("v_proj", 0), **kw),
                "o": dense_init(gen, q_out, cfg.d_model,
                                lora_rank=lr.get("o_proj", 0), **kw),
            },
            "norm2": rms_norm_init(cfg.d_model, **kw),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                            lora_ranks=lr, **kw),
        }

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen`` (a generator on ``self.device``),
        with the reference's shapes and init distributions."""
        cfg, kw = self.cfg, dict(dtype=self.dtype, device=self.device)
        return {
            # the token table is unused by the frontend path, kept so the
            # tree matches the reference's
            "embed": (torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                                  device=self.device)
                      * cfg.d_model ** -0.5).to(self.dtype),
            "final_norm": rms_norm_init(cfg.d_model, **kw),
            "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, **kw),
            "layers": _stack([self._layer_init(gen)
                              for _ in range(cfg.num_layers)]),
            "frontend_proj": dense_init(gen, cfg.frontend.embed_dim,
                                        cfg.d_model, **kw),
        }

    # -- forward ----------------------------------------------------------------

    def _block(self, p: dict, x: torch.Tensor, lk: dict) -> torch.Tensor:
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        lead = x.shape[:-1]
        h = rms_norm(p["norm1"], x, eps=cfg.rms_norm_eps)
        q = dense_apply(p["attn"]["q"], h, **lk).reshape(
            lead + (cfg.num_heads, hd))
        k = dense_apply(p["attn"]["k"], h, **lk).reshape(
            lead + (cfg.num_kv_heads, hd))
        v = dense_apply(p["attn"]["v"], h, **lk).reshape(
            lead + (cfg.num_kv_heads, hd))
        att = bidirectional_attention(q, k, v).reshape(
            lead + (cfg.num_heads * hd,))
        x = x + dense_apply(p["attn"]["o"], att, **lk)
        h2 = rms_norm(p["norm2"], x, eps=cfg.rms_norm_eps)
        return x + mlp_apply(p["mlp"], h2, cfg.activation, **lk)

    def _embed_inputs(self, base: dict, batch: dict) -> torch.Tensor:
        """Frontend embeddings (C, B, T, E) -> (C, B, T, D)."""
        return dense_apply(base["frontend_proj"],
                           batch["embeds"].to(self.dtype))

    def _logits(self, base: dict, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(base["final_norm"], x, eps=self.cfg.rms_norm_eps)
        return dense_apply(base["lm_head"], x)

    def forward_clients(self, base: dict, lora_c: dict, batch: dict,
                        scales: torch.Tensor, *, lora_rank: int = -1
                        ) -> torch.Tensor:
        """Logits (C, B, T, V). ``base`` holds no adapter leaves; every
        ``lora_c`` leaf carries a leading client axis C."""
        x = self._embed_inputs(base, batch)
        lk = dict(lora_scale=scales, lora_rank=lora_rank)
        for li in range(self.cfg.num_layers):
            p = _merge(_index(base["layers"], lambda t: t[li]),
                       _index(lora_c.get("layers", {}), lambda t: t[:, li]))
            x = self._block(p, x, lk)
        return self._logits(base, x)

    def train_loss_clients(self, base: dict, lora_c: dict, batch: dict,
                           scales: torch.Tensor, *, lora_rank: int = -1):
        """Per-client masked cross-entropy: (loss (C,), metrics of (C,))."""
        logits = self.forward_clients(base, lora_c, batch, scales,
                                      lora_rank=lora_rank).float()
        targets = batch["targets"].long()
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=targets.device)
        mask = mask.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        red = tuple(range(1, targets.ndim))
        denom = torch.clamp(mask.sum(dim=red), min=1.0)
        loss = ((logz - gold) * mask).sum(dim=red) / denom
        acc = ((logits.argmax(-1) == targets).float() * mask).sum(dim=red)
        metrics = {"loss": loss, "aux_loss": torch.zeros_like(loss),
                   "accuracy": acc / denom}
        return loss, metrics

    def train_loss(self, params: dict, batch: dict, *, lora_rank: int = -1,
                   lora_scale: float = 1.0):
        """Single-model loss with the reference's signature: (loss, metrics)
        as 0-d tensors."""
        base, lora = split_lora(params)
        lora_c = _index(lora, lambda t: t[None])
        batch_c = {k: torch.as_tensor(v, device=self.device)[None]
                   for k, v in batch.items()}
        scales = torch.full((1,), float(lora_scale), device=self.device)
        loss, metrics = self.train_loss_clients(base, lora_c, batch_c, scales,
                                                lora_rank=lora_rank)
        return loss[0], {k: v[0] for k, v in metrics.items()}


def _stack(layers: list) -> dict:
    first = layers[0]
    return {k: (_stack([layer[k] for layer in layers])
                if isinstance(v, dict)
                else torch.stack([layer[k] for layer in layers]))
            for k, v in first.items()}
