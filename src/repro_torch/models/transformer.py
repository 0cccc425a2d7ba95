"""The port's transformer (``repro/models/transformer.py``) for three kinds
of model: the encoder of the federated round (the ``kind="vlm"`` path:
vision frontend projection, bidirectional attention, GELU MLP, LoRA on
q/k/v/o/up/down), dense causal decoders for serving (token embedding,
RoPE, causal attention with a KV cache, SwiGLU MLP, untied head: Qwen2-7B
with LoRA on q/k/v/o) and attention-free SSM decoders (``kind="ssm"``:
norm, SSD mixer and residual per layer, tied head: Mamba-2 1.3B with LoRA
on the mixer's in/out projections).

Parameters keep the JAX package's tree and layouts at the public
boundary: ``w (in, out)``, ``lora_a (L, r, in)``, ``lora_b (L, out, r)``,
per-layer leaves stacked on axis 0 under ``params["layers"]``.

Many adapters at once write the adapter axis out as a leading batch
dimension C: the ``*_clients`` entry points take the shared base tree, a
LoRA tree whose leaves carry a leading axis C (layer leaves (C, L, ...)),
inputs with a leading C and per-adapter scales. Training runs C sampled
clients at once; serving runs C request slots with one sequence each, and
``use_kernels`` sends their q/k/v/o projections through the paged LoRA
kernel K4, and an SSM model's prefill scan through K6.
``train_loss``, ``forward_seq``, ``prefill`` and ``decode_step`` are the
single-model C = 1 cases with the reference's signatures.

Caches keep the reference's stacked layout, ``{"layers": {...}, "len":
scalar or (B,) int32}``, rows B = C * (batch per client), client-major:
``"k", "v": (G, B, S_c, KVH, hd)`` for attention, ``"conv": (G, B, K-1,
conv_ch)`` in the model dtype and ``"ssm": (G, B, H, P, N)`` f32 for SSD.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import (ATTN_BIDIR, ATTN_SLIDING, LoRAConfig,
                                      ModelConfig)
from repro_torch.core.lora import split_lora
from repro_torch.device import resolve_device
from repro_torch.models.layers.attention import (bidirectional_attention,
                                                 causal_attention,
                                                 decode_attention)
from repro_torch.models.layers.dense import dense_apply, dense_init
from repro_torch.models.layers.mlp import mlp_apply, mlp_init
from repro_torch.models.layers.norms import rms_norm, rms_norm_init
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.layers.ssd import (ssd_dims, ssd_init,
                                           ssd_mixer_apply, ssd_mixer_decode)


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


class CacheSpec(NamedTuple):
    """Shape and dtype of one cache leaf (the reference's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


class Model:
    """Functional model over parameter trees (nested dicts of tensors)."""

    def __init__(self, cfg: ModelConfig, lora: Optional[LoRAConfig] = None,
                 *, device=None, dtype=torch.float32,
                 use_kernels: bool = False):
        unsupported = []
        if cfg.moe is not None or cfg.mla is not None:
            unsupported.append("MoE / MLA mixers")
        if cfg.kind == "hybrid":
            unsupported.append("hybrid attention + SSM mixers")
        if cfg.attn_type == ATTN_SLIDING:
            unsupported.append("sliding-window attention")
        if cfg.rope_type == "mrope":
            unsupported.append("M-RoPE")
        if cfg.logit_softcap:
            unsupported.append("logit softcap")
        if cfg.kind == "dense" and cfg.name.startswith("gemma"):
            unsupported.append("Gemma's embedding scale")
        if cfg.is_encoder_only and cfg.frontend.kind == "none":
            unsupported.append("frontend-free encoders")
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
        self.use_kernels = use_kernels
        self.lora_ranks = _lora_ranks_for(cfg, lora)

    # -- init -----------------------------------------------------------------

    def _layer_init(self, gen: torch.Generator) -> dict:
        cfg, lr = self.cfg, self.lora_ranks
        kw = dict(dtype=self.dtype, device=self.device)
        if cfg.kind == "ssm":   # mamba2 block: norm + mixer + residual only
            return {"norm1": rms_norm_init(cfg.d_model, **kw),
                    "ssm": ssd_init(gen, cfg.d_model, cfg.ssm,
                                    lora_ranks=lr, **kw)}
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
        with the reference's shapes and init distributions. Each stacked
        layer leaf is allocated once and filled layer by layer, so the
        peak is the model plus one layer."""
        cfg, kw = self.cfg, dict(dtype=self.dtype, device=self.device)
        params = {
            # the token table is unused by the frontend path, kept so the
            # tree matches the reference's
            "embed": (torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                                  device=self.device)
                      * cfg.d_model ** -0.5).to(self.dtype),
            "final_norm": rms_norm_init(cfg.d_model, **kw),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                           **kw)
        layers = None
        for li in range(cfg.num_layers):
            layer = self._layer_init(gen)
            if layers is None:
                layers = _index(layer, lambda t: t.new_empty(
                    (cfg.num_layers,) + tuple(t.shape)))
            _fill(layers, layer, li)
            del layer             # free it before drawing the next layer
        params["layers"] = layers
        if cfg.frontend.kind != "none":
            params["frontend_proj"] = dense_init(
                gen, cfg.frontend.embed_dim, cfg.d_model, **kw)
        return params

    # -- forward pieces ---------------------------------------------------------

    def _apply_rope(self, t: torch.Tensor, positions) -> torch.Tensor:
        if self.cfg.rope_type == "none":
            return t
        return apply_rope(t, positions, self.cfg.rope_theta)

    def _qkv(self, p: dict, h: torch.Tensor, positions, lk: dict):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        lead = h.shape[:-1]
        lk = dict(lk, use_kernel=self.use_kernels)
        q = dense_apply(p["q"], h, **lk).reshape(lead + (cfg.num_heads, hd))
        k = dense_apply(p["k"], h, **lk).reshape(
            lead + (cfg.num_kv_heads, hd))
        v = dense_apply(p["v"], h, **lk).reshape(
            lead + (cfg.num_kv_heads, hd))
        return (self._apply_rope(q, positions),
                self._apply_rope(k, positions), v)

    def _out(self, p: dict, att: torch.Tensor, x: torch.Tensor, lk: dict):
        """Residual attention output, then the MLP block."""
        cfg = self.cfg
        att = att.reshape(att.shape[:-2] + (cfg.num_heads
                                            * cfg.resolved_head_dim,))
        x = x + dense_apply(p["attn"]["o"], att, **lk,
                            use_kernel=self.use_kernels)
        h2 = rms_norm(p["norm2"], x, eps=cfg.rms_norm_eps)
        return x + mlp_apply(p["mlp"], h2, cfg.activation, **lk)

    def _block_seq(self, p: dict, x: torch.Tensor, positions, lk: dict):
        """One layer over full sequences x (C, B, T, D): (x, cache entry
        with rows C*B: {"k", "v"} or {"conv", "ssm"})."""
        cfg = self.cfg
        h = rms_norm(p["norm1"], x, eps=cfg.rms_norm_eps)
        if cfg.kind == "ssm":
            mixed, (conv_s, ssm_s) = ssd_mixer_apply(
                p["ssm"], h, cfg.d_model, cfg.ssm, **lk,
                use_kernel=self.use_kernels)
            return x + mixed, {"conv": conv_s, "ssm": ssm_s}
        rows = x.shape[0] * x.shape[1]
        q, k, v = self._qkv(p["attn"], h, positions, lk)
        if cfg.attn_type == ATTN_BIDIR:
            att = bidirectional_attention(q, k, v)
        else:
            att = causal_attention(q, k, v)
        return self._out(p, att, x, lk), {
            "k": k.reshape((rows,) + k.shape[2:]),
            "v": v.reshape((rows,) + v.shape[2:])}

    def _block_decode(self, p: dict, x: torch.Tensor, cache_l: dict,
                      cache_len, positions, lk: dict) -> torch.Tensor:
        """One layer, one token per row: x (C, B, 1, D). Updates this
        layer's cache views ``cache_l`` (rows B' = C*B) in place: the
        token's k/v at the ring index ``len % S_c``, or the new conv and
        SSM states."""
        cfg = self.cfg
        h = rms_norm(p["norm1"], x, eps=cfg.rms_norm_eps)
        if cfg.kind == "ssm":
            mixed, (conv_s, ssm_s) = ssd_mixer_decode(
                p["ssm"], h, cfg.d_model, cfg.ssm, cache_l["conv"],
                cache_l["ssm"], **lk)
            cache_l["conv"].copy_(conv_s)
            cache_l["ssm"].copy_(ssm_s)
            return x + mixed
        k_cache, v_cache = cache_l["k"], cache_l["v"]
        q, k, v = self._qkv(p["attn"], h, positions, lk)
        rows, s_cache = k_cache.shape[:2]
        ar = torch.arange(rows, device=x.device)
        write_idx = (cache_len % s_cache).expand(rows)
        k_cache[ar, write_idx] = k.reshape((rows,) + k.shape[-2:]).to(
            k_cache.dtype)
        v_cache[ar, write_idx] = v.reshape((rows,) + v.shape[-2:]).to(
            v_cache.dtype)
        eff_len = torch.clamp(cache_len, max=s_cache - 1)
        att = decode_attention(q.reshape((rows, 1) + q.shape[-2:]), k_cache,
                               v_cache, eff_len + 1)
        return self._out(p, att.reshape(q.shape), x, lk)

    def _layer(self, base: dict, lora_c: dict, li: int) -> dict:
        return _merge(_index(base["layers"], lambda t: t[li]),
                      _index(lora_c.get("layers", {}), lambda t: t[:, li]))

    def _embed_inputs(self, base: dict, batch: dict) -> torch.Tensor:
        """Frontend embeddings (C, B, T, E) and/or tokens (C, B, T) ->
        (C, B, T', D), frontend positions first."""
        parts = []
        if self.cfg.frontend.kind != "none" and "embeds" in batch:
            parts.append(dense_apply(base["frontend_proj"],
                                     batch["embeds"].to(self.dtype)))
        if "tokens" in batch:
            parts.append(base["embed"][batch["tokens"].long()].to(
                self.dtype))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)

    def _logits(self, base: dict, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(base["final_norm"], x, eps=self.cfg.rms_norm_eps)
        if self.cfg.tie_embeddings:
            return x @ base["embed"].to(x.dtype).T
        return dense_apply(base["lm_head"], x)

    # -- client-axis entry points -------------------------------------------------

    def forward_seq_clients(self, base: dict, lora_c: dict, batch: dict,
                            scales: torch.Tensor, *, mode: str = "train",
                            lora_rank: int = -1):
        """Full sequences: (logits (C, B, T, V), caches). ``mode`` "train"
        returns no caches; "prefill" returns every layer's cache entry
        stacked on a leading layer axis: post-RoPE k/v (G, C*B, T, KVH, hd),
        or the final conv (G, C*B, K-1, conv_ch) and SSM (G, C*B, H, P, N)
        states."""
        if mode not in ("train", "prefill"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg = self.cfg
        x = self._embed_inputs(base, batch)
        c, b, t = x.shape[:3]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(t, dtype=torch.int32, device=x.device)
        lk = dict(lora_scale=scales, lora_rank=lora_rank)
        caches = None
        for li in range(cfg.num_layers):
            x, entry = self._block_seq(self._layer(base, lora_c, li), x,
                                       positions, lk)
            if mode != "prefill":
                continue
            if caches is None:
                caches = {k: v.new_empty((cfg.num_layers,) + v.shape)
                          for k, v in entry.items()}
            for k, v in entry.items():
                caches[k][li] = v
        return self._logits(base, x), caches

    def forward_clients(self, base: dict, lora_c: dict, batch: dict,
                        scales: torch.Tensor, *, lora_rank: int = -1
                        ) -> torch.Tensor:
        """Logits (C, B, T, V). ``base`` holds no adapter leaves; every
        ``lora_c`` leaf carries a leading client axis C."""
        return self.forward_seq_clients(base, lora_c, batch, scales,
                                        lora_rank=lora_rank)[0]

    def prefill_clients(self, base: dict, lora_c: dict, batch: dict,
                        scales: torch.Tensor, *, lora_rank: int = -1):
        """(logits (C, B, T, V), stacked caches: {"k", "v"} or {"conv",
        "ssm"}, see ``forward_seq_clients``)."""
        return self.forward_seq_clients(base, lora_c, batch, scales,
                                        mode="prefill", lora_rank=lora_rank)

    def decode_step_clients(self, base: dict, lora_c: dict, batch: dict,
                            cache: dict, scales: torch.Tensor, *,
                            lora_rank: int = -1):
        """One token per row. batch {"token": (C, B, 1)}; cache rows C*B,
        ``cache["len"]`` a scalar or a (C*B,) vector of per-row lengths
        (each row's RoPE position and ring write index; SSM rows keep no
        position). Returns (logits (C, B, 1, V), new cache); the input
        cache is left as it was."""
        if not self.cfg.supports_decode:
            raise ValueError(f"{self.cfg.name} is encoder-only")
        cfg = self.cfg
        x = base["embed"][batch["token"].long()].to(self.dtype)
        c, b = x.shape[:2]
        cache_len = torch.as_tensor(cache["len"], dtype=torch.int32,
                                    device=x.device)
        positions = cache_len.reshape(-1).expand(c * b).reshape(c, b, 1)
        layers = _index(cache["layers"], torch.clone)
        lk = dict(lora_scale=scales, lora_rank=lora_rank)
        for li in range(cfg.num_layers):
            x = self._block_decode(self._layer(base, lora_c, li), x,
                                   _index(layers, lambda t: t[li]),
                                   cache_len, positions, lk)
        return self._logits(base, x), {"layers": layers,
                                       "len": cache_len + 1}

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

    # -- single-model entry points (the reference's signatures) -------------------

    def _single(self, params: dict, batch: dict, lora_scale: float):
        base, lora = split_lora(params)
        lora_c = _index(lora, lambda t: t[None])
        batch_c = {k: torch.as_tensor(v, device=self.device)[None]
                   for k, v in batch.items()}
        scales = torch.full((1,), float(lora_scale), device=self.device)
        return base, lora_c, batch_c, scales

    def train_loss(self, params: dict, batch: dict, *, lora_rank: int = -1,
                   lora_scale: float = 1.0):
        """Single-model loss with the reference's signature: (loss, metrics)
        as 0-d tensors."""
        base, lora_c, batch_c, scales = self._single(params, batch,
                                                     lora_scale)
        loss, metrics = self.train_loss_clients(base, lora_c, batch_c, scales,
                                                lora_rank=lora_rank)
        return loss[0], {k: v[0] for k, v in metrics.items()}

    def forward_seq(self, params: dict, batch: dict, *, mode: str = "train",
                    lora_rank: int = -1, lora_scale: float = 1.0):
        """(logits (B, T, V), aux (0-d, no MoE), caches or None)."""
        base, lora_c, batch_c, scales = self._single(params, batch,
                                                     lora_scale)
        logits, caches = self.forward_seq_clients(
            base, lora_c, batch_c, scales, mode=mode, lora_rank=lora_rank)
        return logits[0], torch.zeros((), device=self.device), caches

    def prefill(self, params: dict, batch: dict, *, lora_rank: int = -1,
                lora_scale: float = 1.0):
        logits, _, caches = self.forward_seq(
            params, batch, mode="prefill", lora_rank=lora_rank,
            lora_scale=lora_scale)
        return logits, caches

    def decode_step(self, params: dict, batch: dict, cache: dict, *,
                    lora_rank: int = -1, lora_scale: float = 1.0):
        """batch {"token": (B, 1)}; cache {"layers", "len"} ->
        (logits (B, 1, V), new cache)."""
        base, lora_c, batch_c, scales = self._single(params, batch,
                                                     lora_scale)
        logits, new_cache = self.decode_step_clients(
            base, lora_c, batch_c, cache, scales, lora_rank=lora_rank)
        return logits[0], new_cache

    # -- cache construction -------------------------------------------------------

    def cache_seq_len(self, max_len: int) -> int:
        """Ring-buffer length: pure sliding-window archs only ever need the
        last ``window`` positions."""
        cfg = self.cfg
        if (cfg.attn_type == ATTN_SLIDING and cfg.sliding_window
                and not cfg.global_attn_every):
            return min(max_len, cfg.sliding_window)
        return max_len

    def cache_shapes(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        g = cfg.num_layers
        if cfg.kind == "ssm":
            dims = ssd_dims(cfg.d_model, cfg.ssm)
            layers = {
                "conv": CacheSpec((g, batch_size, cfg.ssm.conv_dim - 1,
                                   dims["conv_ch"]), self.dtype),
                "ssm": CacheSpec((g, batch_size, dims["nheads"],
                                  dims["head_dim"], cfg.ssm.state_dim),
                                 torch.float32)}
        else:
            shape = (g, batch_size, self.cache_seq_len(max_len),
                     cfg.num_kv_heads, cfg.resolved_head_dim)
            layers = {"k": CacheSpec(shape, self.dtype),
                      "v": CacheSpec(shape, self.dtype)}
        return {"layers": layers, "len": CacheSpec((), torch.int32)}

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        return _index(self.cache_shapes(batch_size, max_len),
                      lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                            device=self.device))


def _fill(stacked: dict, layer: dict, li: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _fill(stacked[k], v, li)
        else:
            stacked[k][li].copy_(v)
