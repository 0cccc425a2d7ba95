"""The port's transformer (``repro/models/transformer.py``) for four kinds
of model: encoders (bidirectional attention, GELU MLP): the federated
round's ``kind="vlm"`` path (vision frontend projection, LoRA on
q/k/v/o/up/down; ViT-base), an audio frontend (HuBERT X-Large) or token
embeddings with no positions and an untied head (RoBERTa-base); causal
decoders (token embedding, RoPE, causal attention with a KV cache, a
SwiGLU, GeGLU or squared-ReLU MLP, a tied or untied head, GQA/MQA:
Qwen2-7B, LLaMA-3.2-3B, Granite-3-8B, Nemotron-4-340B; Gemma-2B with its
token embeddings scaled by sqrt(d_model); Qwen2-VL-7B with patch
embeddings before the tokens and M-RoPE); attention-free SSM decoders
(``kind="ssm"``: norm, SSD mixer and residual per layer, tied head:
Mamba-2 1.3B with LoRA on the mixer's in/out projections); and hybrid
decoders (``kind="hybrid"``, Hymba-1.5B: attention and an SSD mixer read
the same normed input, ``r * attn + (1 - r) * ssm`` joins the residual,
then the MLP). Causal attention takes a sliding window (every layer but
each ``global_attn_every``-th) and a softcap on its scores.

Two more mixers follow the reference's routing: DeepSeek-V2's multi-head
latent attention (``cfg.mla``: ``models/layers/mla.py``, K and V from a
shared latent, a decode cache of the latents only) and mixture-of-experts
FFNs (``cfg.moe``: ``models/layers/moe.py``, a router's top-k over stacked
experts plus shared experts, its Switch aux loss times
``router_aux_loss_coef`` summed over the layers and added to each
client's training loss). A dense layer of an MoE model has ``d_ff = 2 *
expert_d_ff``. Llama-4 alternates dense and MoE layers (period 2): layers
are stacked in GROUPS of ``moe_layer_period``, ``params["layers"]
["sub{i}"]`` for layer ``g * period + i``, each leaf stacked over the G =
L / period groups, and the caches' layer trees likewise; with period 1
(every other model) the layer leaves sit under ``params["layers"]``
directly, G = L. ``moe_impl="ep"`` takes the reference's expert-parallel
dispatch (``moe_apply_ep``) over the ``"model"`` axis of ``mesh`` (without
one, a ``launch.mesh.make_host_mesh()`` made at the first MoE layer, over
a one-rank group if there is none, which stays until its caller destroys
it), and ``moe_capacity_factor > 0`` its capacity dispatch; as in the
reference, the default ``"tp"`` path ignores the capacity factor.

``remat`` (default on, as the reference's) runs each layer group of the
training forward under ``torch.utils.checkpoint`` when a gradient is
taken: only the group's inputs are kept, and its forward runs again in the
backward (the reference's ``jax.checkpoint`` with ``nothing_saveable``
around its layer scan's body); prefill, decode and forwards without a
gradient never take it. The federated rounds, the serve launcher and the
benches pass ``remat=False``, as their reference counterparts do. A model
in ``dtype`` bf16 keeps every leaf bf16 but the router and the SSD
constants, and ``use_kernels`` sends its q/k/v/o to K4's bf16 instances.
``init`` writes each leaf straight into its stacked leaf, so its peak is
the model's bytes plus one group's small constant leaves.

The PEFT variants of the paper's Table 5 are applied after ``init`` on
the stacked leaves, as the reference does: ``variant="dora"`` adds a
trainable magnitude ``lora_m`` (the column norms of ``w``) next to every
adapter, ``variant="qlora"`` fake-quantizes the frozen ``w`` of every
adapted layer at ``quant_bits``; any other name leaves the tree as it is.

Parameters keep the JAX package's tree and layouts at the public
boundary: ``w (in, out)``, ``lora_a (G, r, in)``, ``lora_b (G, out, r)``,
``lora_m (G, out)``, per-layer leaves stacked on axis 0 under
``params["layers"]`` (and ``["sub{i}"]`` in groups).

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
``"k", "v": (G, B, S_c, KVH, hd)`` for attention, ``"ckv": (G, B, S_c,
kv_lora_rank)`` and ``"krope": (G, B, S_c, qk_rope_head_dim)`` for MLA,
``"conv": (G, B, K-1, conv_ch)`` in the model dtype and ``"ssm": (G, B, H,
P, N)`` f32 for SSD; a hybrid layer's entry holds k, v, conv and ssm. S_c
is ``cache_seq_len``: a ring of the window for a pure sliding-window
model.

Positions: (..., L) integers, or for M-RoPE (3, ..., L) with the stream
axis first (the reference's (3, B, L) at the single-model entries, (3, C,
B, L) at the client-axis ones); by default 0..L-1 on every stream.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_BIDIR, ATTN_SLIDING, LoRAConfig,
                                      ModelConfig)
from repro_torch.core.lora import split_lora
from repro_torch.device import resolve_device
from repro_torch.models.layers import draw
from repro_torch.models.layers.attention import (bidirectional_attention,
                                                 causal_attention,
                                                 decode_attention,
                                                 decode_attention_windowed)
from repro_torch.models.layers.dense import (dense_apply, dense_init,
                                             dora_magnitude_init,
                                             quantize_dequantize)
from repro_torch.models.layers.mla import mla_attention, mla_decode, mla_init
from repro_torch.models.layers.mlp import mlp_apply, mlp_init
from repro_torch.models.layers.moe import moe_apply, moe_apply_ep, moe_init
from repro_torch.models.layers.norms import rms_norm, rms_norm_init
from repro_torch.models.layers.rope import apply_mrope, apply_rope
from repro_torch.models.layers.ssd import (ssd_dims, ssd_init,
                                           ssd_mixer_apply, ssd_mixer_decode)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` (...) of ``table`` (V, D) -> (..., D), by the rule of
    the reference's ``jnp.take(table, ids, axis=0)``: an id in [-V, V)
    selects row ``id mod V``, any other id gives a row of NaN in the
    table's dtype. Computed on the device (a gather of the wrapped ids,
    then one select), with no read of the ids to the host."""
    v = table.shape[0]
    ids = ids.long()
    rows = table[ids.remainder(v)]
    return torch.where(((ids >= -v) & (ids < v))[..., None], rows,
                       float("nan"))


def gold_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The reference's gold logit ``sum(logits * one_hot(targets, V), -1)``
    without the (..., V) one-hot: ``logits[t]`` for a target t in [0, V),
    0 for any other t, and NaN wherever a column other than t is infinite
    (0 * inf in the contraction; a NaN column makes the loss NaN through
    its logsumexp either way). That NaN is a constant, so the gradient
    stays the contraction's: the one-hot, zero for an out-of-range
    target."""
    v = logits.shape[-1]
    inside = (targets >= 0) & (targets < v)
    picked = torch.gather(logits, -1,
                          targets.clamp(0, v - 1)[..., None])[..., 0]
    gold = torch.where(inside, picked, 0.0)
    with torch.no_grad():
        lg = logits.detach()
        infinite = torch.isposinf(lg).sum(-1) + torch.isneginf(lg).sum(-1)
        stray = infinite > (inside & torch.isinf(picked.detach())).long()
        fill = torch.where(stray, float("nan"), 0.0)
    return gold + fill


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
                 remat: bool = True, use_kernels: bool = False,
                 moe_impl: str = "tp", mesh=None, batch_axes=("data",),
                 moe_capacity_factor: float = 0.0):
        if moe_impl not in ("tp", "ep"):
            raise ValueError(f"unknown moe_impl {moe_impl!r}")
        self.remat = remat
        self.moe_impl = moe_impl
        self.mesh = mesh
        self.batch_axes = batch_axes
        self.moe_capacity_factor = moe_capacity_factor
        self.cfg = cfg
        self.lora = lora
        self.device = resolve_device(device)
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.lora_ranks = _lora_ranks_for(cfg, lora)
        moe = cfg.moe
        self.group_size = (moe.moe_layer_period
                           if moe and moe.moe_layer_period > 1 else 1)
        if cfg.num_layers % self.group_size:
            raise ValueError(f"{cfg.num_layers} layers do not split into "
                             f"groups of {self.group_size}")
        self.num_groups = cfg.num_layers // self.group_size

    # -- init -----------------------------------------------------------------

    def _layer_init(self, gen: torch.Generator, li: int,
                    out: Optional[dict] = None) -> dict:
        """Layer ``li``'s parameters (its index picks an MoE or a dense
        FFN); with ``out``, written into its tensors (``draw``)."""
        cfg, lr = self.cfg, self.lora_ranks

        def to(*path):
            o = out
            for key in path:
                o = draw.sub(o, key)
            return dict(dtype=self.dtype, device=self.device, out=o)
        if cfg.kind == "ssm":   # mamba2 block: norm + mixer + residual only
            return {"norm1": rms_norm_init(cfg.d_model, **to("norm1")),
                    "ssm": ssd_init(gen, cfg.d_model, cfg.ssm,
                                    lora_ranks=lr, **to("ssm"))}
        if cfg.mla is not None:
            attn = mla_init(gen, cfg.d_model, cfg.num_heads, cfg.mla,
                            lora_ranks=lr, **to("attn"))
        else:
            hd = cfg.resolved_head_dim
            q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd
            attn = {
                "q": dense_init(gen, cfg.d_model, q_out, bias=cfg.qkv_bias,
                                lora_rank=lr.get("q_proj", 0),
                                **to("attn", "q")),
                "k": dense_init(gen, cfg.d_model, kv_out, bias=cfg.qkv_bias,
                                lora_rank=lr.get("k_proj", 0),
                                **to("attn", "k")),
                "v": dense_init(gen, cfg.d_model, kv_out, bias=cfg.qkv_bias,
                                lora_rank=lr.get("v_proj", 0),
                                **to("attn", "v")),
                "o": dense_init(gen, q_out, cfg.d_model,
                                lora_rank=lr.get("o_proj", 0),
                                **to("attn", "o")),
            }
        layer = {"norm1": rms_norm_init(cfg.d_model, **to("norm1")),
                 "attn": attn,
                 "norm2": rms_norm_init(cfg.d_model, **to("norm2"))}
        if cfg.moe is not None and cfg.moe.is_moe_layer(li):
            layer["moe"] = moe_init(gen, cfg.d_model, cfg.moe,
                                    cfg.activation, **to("moe"))
        else:
            d_ff = cfg.d_ff if cfg.moe is None else 2 * cfg.moe.expert_d_ff
            layer["mlp"] = mlp_init(gen, cfg.d_model, d_ff, cfg.activation,
                                    lora_ranks=lr, **to("mlp"))
        if cfg.kind == "hybrid":   # parallel SSD heads beside attention
            layer["ssm"] = ssd_init(gen, cfg.d_model, cfg.ssm,
                                    lora_ranks=lr, **to("ssm"))
        return layer

    def _group_init(self, gen: torch.Generator, g: int,
                    out: Optional[dict] = None) -> dict:
        if self.group_size == 1:
            return self._layer_init(gen, g, out)
        return {f"sub{i}": self._layer_init(gen, g * self.group_size + i,
                                            draw.sub(out, f"sub{i}"))
                for i in range(self.group_size)}

    def _sub(self, tree: dict, i: int) -> dict:
        """A group-stacked tree's part for the group's i-th layer."""
        return tree if self.group_size == 1 else tree.get(f"sub{i}", {})

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen`` (a generator on ``self.device``),
        with the reference's shapes and init distributions. Each stacked
        layer leaf is allocated once, and each layer group's init writes
        its leaves straight into the group's slices of them (``draw``): no
        drawn group, and no whole-tensor draw in another dtype, exists
        beside the model, so the peak is the model plus one group's
        constant leaves, each made before it is copied in. The embedding
        and the head are drawn in place too: a draw in f32 and its scaled
        copy would stand beside them at twice and four times their bf16
        bytes (Nemotron-4-340B's 256000 x 18432 table: 17.6 GiB each). In
        f32 the values are bit for bit those of drawing each group whole
        and copying it in."""
        cfg, kw = self.cfg, dict(dtype=self.dtype, device=self.device)
        table = (cfg.vocab_size, cfg.d_model)
        params = {
            # the token table is unused by the frontend path, kept so the
            # tree matches the reference's
            "embed": draw.normal(gen, table, cfg.d_model ** -0.5,
                                 self.dtype, self.device,
                                 torch.empty(table, **kw)),
            "final_norm": rms_norm_init(cfg.d_model, **kw),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(
                gen, cfg.d_model, cfg.vocab_size,
                out={"w": torch.empty(table[::-1], **kw)}, **kw)
        layers = self._stacked_layers()
        for g in range(self.num_groups):
            self._group_init(gen, g, _index(layers, lambda t: t[g]))
        params["layers"] = layers
        if self.lora is not None and self.lora.variant != "lora":
            params = self._apply_peft_variant(params)
        if cfg.frontend.kind != "none":
            params["frontend_proj"] = dense_init(
                gen, cfg.frontend.embed_dim, cfg.d_model, **kw)
        return params

    def _stacked_layers(self) -> dict:
        """The stacked layer leaves, allocated empty on ``self.device``
        from one group's tree on the meta device."""
        meta = copy.copy(self)
        meta.device = torch.device("meta")
        return _index(meta._group_init(None, 0), lambda t: torch.empty(
            (self.num_groups,) + tuple(t.shape), dtype=t.dtype,
            device=self.device))

    def _apply_peft_variant(self, params: dict) -> dict:
        """Table 5's variants: DoRA adds trainable magnitudes next to every
        adapter; QLoRA fake-quantizes the frozen base of adapted layers."""
        variant, bits = self.lora.variant, self.lora.quant_bits

        def walk(node):
            if not isinstance(node, dict):
                return node
            out = {k: walk(v) for k, v in node.items()}
            if "w" in out and "lora_a" in out:
                if variant == "dora":
                    out["lora_m"] = dora_magnitude_init(out["w"])
                elif variant == "qlora":
                    out["w"] = quantize_dequantize(out["w"], bits)
            return out

        return walk(params)

    def param_shapes(self) -> dict:
        """``init``'s tree as meta tensors (shape and dtype, no storage)
        for the full config: nothing is allocated, on the card or the
        host (the reference's ``jax.eval_shape``)."""
        meta = copy.copy(self)
        meta.device = torch.device("meta")
        return meta.init(None)

    # -- forward pieces ---------------------------------------------------------

    def _apply_rope(self, t: torch.Tensor, positions) -> torch.Tensor:
        cfg = self.cfg
        if cfg.rope_type == "none":
            return t
        if cfg.rope_type == "mrope":
            return apply_mrope(t, positions, cfg.rope_theta,
                               cfg.mrope_sections)
        return apply_rope(t, positions, cfg.rope_theta)

    def _window(self, li: int) -> int:
        """Layer ``li``'s sliding window: 0 (none) unless the config slides;
        each ``global_attn_every``-th layer (by absolute index) sees every
        key, through a window of 2**30, as the reference's ``_is_global``."""
        cfg = self.cfg
        if cfg.attn_type != ATTN_SLIDING or not cfg.sliding_window:
            return 0
        if cfg.global_attn_every and li % cfg.global_attn_every == 0:
            return 2 ** 30
        return cfg.sliding_window

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

    def _attn_out(self, p: dict, att: torch.Tensor, lk: dict):
        """The o-projection of the heads' outputs (..., H, hd)."""
        cfg = self.cfg
        att = att.reshape(att.shape[:-2] + (cfg.num_heads
                                            * cfg.resolved_head_dim,))
        return dense_apply(p["attn"]["o"], att, **lk,
                           use_kernel=self.use_kernels)

    def _mix_ffn(self, p: dict, x: torch.Tensor, attn_out: torch.Tensor,
                 ssm_out, lk: dict):
        """Residual of the mixers' output (a hybrid block's
        ``r * attn + (1 - r) * ssm``), then norm2 and the FFN block: (x,
        the MoE's aux loss (C,) times its coefficient, or None)."""
        cfg = self.cfg
        mixed = attn_out
        if ssm_out is not None:
            r = cfg.hybrid_attn_ratio
            mixed = r * attn_out + (1.0 - r) * ssm_out
        x = x + mixed
        h2 = rms_norm(p["norm2"], x, eps=cfg.rms_norm_eps)
        if "moe" in p:
            out, aux = self._moe(p["moe"], h2)
            return x + out, aux * cfg.moe.router_aux_loss_coef
        return x + mlp_apply(p["mlp"], h2, cfg.activation, **lk), None

    def _moe(self, p_moe: dict, h2: torch.Tensor):
        """The MoE FFN by ``moe_impl``: (out, aux (C,))."""
        cfg = self.cfg
        if self.moe_impl == "ep":
            if self.mesh is None:
                from repro_torch.launch.mesh import make_host_mesh
                self.mesh = make_host_mesh(device=self.device)
            return moe_apply_ep(p_moe, h2, cfg.moe, cfg.activation,
                                self.mesh, batch_axes=self.batch_axes,
                                capacity_factor=self.moe_capacity_factor)
        return moe_apply(p_moe, h2, cfg.moe, cfg.activation)

    def _mla_seq(self, p: dict, h: torch.Tensor, positions, lk: dict):
        """MLA over full sequences: (output, cache entry {"ckv", "krope"}
        with rows C*B)."""
        cfg = self.cfg
        rows = h.shape[0] * h.shape[1]
        out, (ckv, krope) = mla_attention(
            p["attn"], h, positions, cfg.num_heads, cfg.mla,
            rope_theta=cfg.rope_theta, causal=cfg.attn_type != ATTN_BIDIR,
            sliding_window=(cfg.sliding_window
                            if cfg.attn_type == ATTN_SLIDING else 0), **lk)
        return out, {"ckv": ckv.reshape((rows,) + ckv.shape[2:]),
                     "krope": krope.reshape((rows,) + krope.shape[2:])}

    def _block_seq(self, p: dict, x: torch.Tensor, positions, li: int,
                   lk: dict):
        """Layer ``li`` over full sequences x (C, B, T, D): (x, aux (C,) or
        None, cache entry with rows C*B: {"k", "v"}, {"ckv", "krope"},
        {"conv", "ssm"} or, hybrid, k, v, conv and ssm)."""
        cfg = self.cfg
        h = rms_norm(p["norm1"], x, eps=cfg.rms_norm_eps)
        if cfg.kind == "ssm":
            mixed, (conv_s, ssm_s) = ssd_mixer_apply(
                p["ssm"], h, cfg.d_model, cfg.ssm, **lk,
                use_kernel=self.use_kernels)
            return x + mixed, None, {"conv": conv_s, "ssm": ssm_s}
        if cfg.mla is not None:
            attn_out, entry = self._mla_seq(p, h, positions, lk)
            return self._mix_ffn(p, x, attn_out, None, lk) + (entry,)
        rows = x.shape[0] * x.shape[1]
        q, k, v = self._qkv(p["attn"], h, positions, lk)
        if cfg.attn_type == ATTN_BIDIR:
            att = bidirectional_attention(q, k, v)
        else:
            att = causal_attention(q, k, v, sliding_window=self._window(li),
                                   softcap=cfg.logit_softcap)
        entry = {"k": k.reshape((rows,) + k.shape[2:]),
                 "v": v.reshape((rows,) + v.shape[2:])}
        ssm_out = None
        if cfg.kind == "hybrid":
            ssm_out, (conv_s, ssm_s) = ssd_mixer_apply(
                p["ssm"], h, cfg.d_model, cfg.ssm, **lk,
                use_kernel=self.use_kernels)
            entry.update(conv=conv_s, ssm=ssm_s)
        return self._mix_ffn(p, x, self._attn_out(p, att, lk), ssm_out,
                             lk) + (entry,)

    def _block_decode(self, p: dict, x: torch.Tensor, cache_l: dict,
                      cache_len, positions, li: int, lk: dict
                      ) -> torch.Tensor:
        """Layer ``li``, one token per row: x (C, B, 1, D). Updates this
        layer's cache views ``cache_l`` (rows B' = C*B) in place: the
        token's k/v (or MLA latents) at the ring index ``len % S_c``,
        and/or the new conv and SSM states. A sliding window masks the
        keys only where the cache outlasts it (a pure sliding-window
        model's ring is the window itself; MLA's decode takes no window,
        as the reference's)."""
        cfg = self.cfg
        h = rms_norm(p["norm1"], x, eps=cfg.rms_norm_eps)
        ssm_out = None
        if cfg.kind in ("ssm", "hybrid"):
            ssm_out, (conv_s, ssm_s) = ssd_mixer_decode(
                p["ssm"], h, cfg.d_model, cfg.ssm, cache_l["conv"],
                cache_l["ssm"], **lk)
            cache_l["conv"].copy_(conv_s)
            cache_l["ssm"].copy_(ssm_s)
            if cfg.kind == "ssm":
                return x + ssm_out
        if cfg.mla is not None:
            attn_out = mla_decode(
                p["attn"], h, positions, cache_l["ckv"], cache_l["krope"],
                cache_len, cfg.num_heads, cfg.mla,
                rope_theta=cfg.rope_theta, **lk)
            return self._mix_ffn(p, x, attn_out, None, lk)[0]
        k_cache, v_cache = cache_l["k"], cache_l["v"]
        q, k, v = self._qkv(p["attn"], h, positions, lk)
        rows, s_cache = k_cache.shape[:2]
        ar = torch.arange(rows, device=x.device)
        write_idx = (cache_len % s_cache).expand(rows)
        k_cache[ar, write_idx] = k.reshape((rows,) + k.shape[-2:]).to(
            k_cache.dtype)
        v_cache[ar, write_idx] = v.reshape((rows,) + v.shape[-2:]).to(
            v_cache.dtype)
        total = torch.clamp(cache_len, max=s_cache - 1) + 1
        q_rows = q.reshape((rows, 1) + q.shape[-2:])
        window = self._window(li)
        if window and s_cache > cfg.sliding_window:
            att = decode_attention_windowed(q_rows, k_cache, v_cache, total,
                                            total - window,
                                            softcap=cfg.logit_softcap)
        else:
            att = decode_attention(q_rows, k_cache, v_cache, total,
                                   softcap=cfg.logit_softcap)
        return self._mix_ffn(p, x, self._attn_out(p, att.reshape(q.shape),
                                                  lk), ssm_out, lk)[0]

    def _layer(self, base: dict, lora_c: dict, li: int) -> dict:
        """Layer ``li``'s base leaves and (C, ...) adapter leaves: group
        ``li // group_size``, its sub-layer ``li % group_size``."""
        g, i = divmod(li, self.group_size)
        return _merge(
            _index(self._sub(base["layers"], i), lambda t: t[g]),
            _index(self._sub(lora_c.get("layers", {}), i),
                   lambda t: t[:, g]))

    def _embed_inputs(self, base: dict, batch: dict) -> torch.Tensor:
        """Frontend embeddings (C, B, T, E) and/or tokens (C, B, T) ->
        (C, B, T', D), frontend positions first."""
        parts = []
        if self.cfg.frontend.kind != "none" and "embeds" in batch:
            parts.append(dense_apply(base["frontend_proj"],
                                     batch["embeds"].to(self.dtype)))
        if "tokens" in batch:
            tok = self._scale_embed(take_rows(base["embed"],
                                              batch["tokens"]))
            parts.append(tok.to(self.dtype))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)

    def _scale_embed(self, tok: torch.Tensor) -> torch.Tensor:
        """Gemma multiplies its token embeddings by sqrt(d_model) cast to
        their dtype; the reference's rule: a dense model whose name starts
        with "gemma". The factor is a 0-d host tensor, which multiplies
        on the card with no copy."""
        cfg = self.cfg
        if cfg.kind != "dense" or not cfg.name.startswith("gemma"):
            return tok
        return tok * torch.tensor(cfg.d_model ** 0.5, dtype=tok.dtype)

    def _logits(self, base: dict, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(base["final_norm"], x, eps=self.cfg.rms_norm_eps)
        if self.cfg.tie_embeddings:
            return x @ base["embed"].to(x.dtype).T
        return dense_apply(base["lm_head"], x)

    # -- client-axis entry points -------------------------------------------------

    def forward_seq_clients(self, base: dict, lora_c: dict, batch: dict,
                            scales: torch.Tensor, *, mode: str = "train",
                            lora_rank: int = -1):
        """Full sequences: (logits (C, B, T, V), aux (C,), caches). aux is
        each client's MoE aux loss, summed over the layers with its
        coefficient (zeros without MoE). ``mode`` "train" returns no
        caches; "prefill" returns every layer's cache entry stacked on a
        leading group axis (per ``sub{i}`` in groups): post-RoPE k/v (G,
        C*B, T, KVH, hd) or MLA's c_kv and k_rope (G, C*B, T, *), and/or
        the final conv (G, C*B, K-1, conv_ch) and SSM (G, C*B, H, P, N)
        states. ``batch["positions"]``, if given: (C, B, T) or any shape
        broadcastable to it, for M-RoPE (3, C, B, T)."""
        if mode not in ("train", "prefill"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg = self.cfg
        x = self._embed_inputs(base, batch)
        c, b, t = x.shape[:3]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(t, dtype=torch.int32, device=x.device)
            if cfg.rope_type == "mrope":
                positions = positions.expand(3, t)
        lk = dict(lora_scale=scales, lora_rank=lora_rank)
        aux = torch.zeros(c, dtype=torch.float32, device=x.device)
        if mode == "train" and self.remat and torch.is_grad_enabled():
            for g in range(self.num_groups):
                x, aux = checkpoint(self._group_train, base, lora_c, x, aux,
                                    positions, g, lk, use_reentrant=False)
            return self._logits(base, x), aux, None
        caches = {} if mode == "prefill" else None
        for li in range(cfg.num_layers):
            x, aux_l, entry = self._block_seq(self._layer(base, lora_c, li),
                                              x, positions, li, lk)
            if aux_l is not None:
                aux = aux + aux_l
            if caches is None:
                continue
            g, i = divmod(li, self.group_size)
            sub = (caches if self.group_size == 1
                   else caches.setdefault(f"sub{i}", {}))
            for k, v in entry.items():
                if k not in sub:
                    sub[k] = v.new_empty((self.num_groups,) + v.shape)
                sub[k][g] = v
        return self._logits(base, x), aux, caches

    def _group_train(self, base: dict, lora_c: dict, x: torch.Tensor,
                     aux: torch.Tensor, positions, g: int, lk: dict):
        """Layer group ``g`` of the training forward: (x, aux). Under
        ``remat`` it runs in a checkpoint, which keeps only its inputs and
        runs it again in the backward (the reference's ``jax.checkpoint``
        with ``nothing_saveable`` around each group of its layer scan)."""
        for li in range(g * self.group_size, (g + 1) * self.group_size):
            x, aux_l, _ = self._block_seq(self._layer(base, lora_c, li), x,
                                          positions, li, lk)
            if aux_l is not None:
                aux = aux + aux_l
        return x, aux

    def forward_clients(self, base: dict, lora_c: dict, batch: dict,
                        scales: torch.Tensor, *, lora_rank: int = -1
                        ) -> torch.Tensor:
        """Logits (C, B, T, V). ``base`` holds no adapter leaves; every
        ``lora_c`` leaf carries a leading client axis C."""
        return self.forward_seq_clients(base, lora_c, batch, scales,
                                        lora_rank=lora_rank)[0]

    def prefill_clients(self, base: dict, lora_c: dict, batch: dict,
                        scales: torch.Tensor, *, lora_rank: int = -1):
        """(logits (C, B, T, V), stacked caches: {"k", "v"}, {"ckv",
        "krope"} or {"conv", "ssm"}, see ``forward_seq_clients``)."""
        logits, _, caches = self.forward_seq_clients(
            base, lora_c, batch, scales, mode="prefill", lora_rank=lora_rank)
        return logits, caches

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
        x = self._scale_embed(take_rows(base["embed"], batch["token"]).to(
            self.dtype))
        c, b = x.shape[:2]
        cache_len = torch.as_tensor(cache["len"], dtype=torch.int32,
                                    device=x.device)
        positions = cache_len.reshape(-1).expand(c * b).reshape(c, b, 1)
        if cfg.rope_type == "mrope":   # text: all three streams advance
            positions = positions.expand(3, c, b, 1)
        layers = _index(cache["layers"], torch.clone)
        lk = dict(lora_scale=scales, lora_rank=lora_rank)
        for li in range(cfg.num_layers):
            g, i = divmod(li, self.group_size)
            x = self._block_decode(self._layer(base, lora_c, li), x,
                                   _index(self._sub(layers, i),
                                          lambda t: t[g]),
                                   cache_len, positions, li, lk)
        return self._logits(base, x), {"layers": layers,
                                       "len": cache_len + 1}

    def train_loss_clients(self, base: dict, lora_c: dict, batch: dict,
                           scales: torch.Tensor, *, lora_rank: int = -1):
        """Per-client masked cross-entropy plus the client's MoE aux loss:
        (loss (C,), metrics of (C,): "loss" without the aux, "aux_loss",
        "accuracy"), as the reference's ``train_loss``."""
        logits, aux, _ = self.forward_seq_clients(base, lora_c, batch,
                                                  scales, lora_rank=lora_rank)
        logits = logits.float()
        targets = batch["targets"].long()
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=targets.device)
        mask = mask.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = gold_logits(logits, targets)
        red = tuple(range(1, targets.ndim))
        denom = torch.clamp(mask.sum(dim=red), min=1.0)
        loss = ((logz - gold) * mask).sum(dim=red) / denom
        acc = ((logits.argmax(-1) == targets).float() * mask).sum(dim=red)
        metrics = {"loss": loss, "aux_loss": aux, "accuracy": acc / denom}
        return loss + aux, metrics

    # -- single-model entry points (the reference's signatures) -------------------

    def _single(self, params: dict, batch: dict, lora_scale: float):
        base, lora = split_lora(params)
        lora_c = _index(lora, lambda t: t[None])
        batch_c = {k: torch.as_tensor(v, device=self.device)[None]
                   for k, v in batch.items()}
        if self.cfg.rope_type == "mrope" and "positions" in batch_c:
            # (3, B, L) -> (3, 1, B, L): the client axis after the streams
            batch_c["positions"] = batch_c["positions"][0][:, None]
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
        """(logits (B, T, V), aux (0-d), caches or None)."""
        base, lora_c, batch_c, scales = self._single(params, batch,
                                                     lora_scale)
        logits, aux, caches = self.forward_seq_clients(
            base, lora_c, batch_c, scales, mode=mode, lora_rank=lora_rank)
        return logits[0], aux[0], caches

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
        g = self.num_groups
        layers = {}
        if cfg.kind in ("ssm", "hybrid"):
            dims = ssd_dims(cfg.d_model, cfg.ssm)
            layers["conv"] = CacheSpec((g, batch_size, cfg.ssm.conv_dim - 1,
                                        dims["conv_ch"]), self.dtype)
            layers["ssm"] = CacheSpec((g, batch_size, dims["nheads"],
                                       dims["head_dim"], cfg.ssm.state_dim),
                                      torch.float32)
        s = (g, batch_size, self.cache_seq_len(max_len))
        if cfg.mla is not None:
            layers["ckv"] = CacheSpec(s + (cfg.mla.kv_lora_rank,),
                                      self.dtype)
            layers["krope"] = CacheSpec(s + (cfg.mla.qk_rope_head_dim,),
                                        self.dtype)
        elif cfg.kind != "ssm":
            shape = s + (cfg.num_kv_heads, cfg.resolved_head_dim)
            layers["k"] = CacheSpec(shape, self.dtype)
            layers["v"] = CacheSpec(shape, self.dtype)
        if self.group_size > 1:
            layers = {f"sub{i}": layers for i in range(self.group_size)}
        return {"layers": layers, "len": CacheSpec((), torch.int32)}

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        return _index(self.cache_shapes(batch_size, max_len),
                      lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                            device=self.device))


