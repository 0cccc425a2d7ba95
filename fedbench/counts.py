"""The yardstick's arithmetic: the H100's published peaks and the
operations and bytes of the work each cell drives, counted from its shapes.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
the full 700 W: HBM at 3.35 TB/s, IEEE float32 at 67 TFLOP/s outside the
tensor cores, the float32-accurate 3xTF32 route at a third of TF32's 495
TFLOP/s, and bf16 on the tensor cores at 989 TFLOP/s.

Every count takes each input byte read once and each output byte written
once, whatever a kernel reads again, and the operations that the inputs
need (a Gram matrix's symmetric half, a LoRA product at the client's or
tenant's own rank, the head at the positions whose logits are used), not
the most that a route computes. A multiply-add is two operations.

Configurations are the plain dicts of ``fedbench/configs/*.json``; nothing
here imports the program.
"""
from __future__ import annotations

from typing import Iterable, Sequence

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12

ITEMSIZE = {"float32": 4, "bfloat16": 2}


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    """The least time of the work: bytes at the memory's rate or the
    operations at ``peak_flops``, whichever takes longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def attn_width(cfg: dict) -> tuple:
    """(query width H*hd, key/value width KVH*hd)."""
    hd = cfg["head_dim"]
    return (cfg["num_attention_heads"] * hd,
            cfg["num_key_value_heads"] * hd)


def projections(cfg: dict) -> list:
    """(name, in, out) of every dense projection of one layer."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    q, kv = attn_width(cfg)
    out = [("q", d, q), ("k", d, kv), ("v", d, kv), ("o", q, d),
           ("up", d, ff), ("down", ff, d)]
    if cfg.get("gated_mlp"):
        out.append(("gate", d, ff))
    return out


def layer_params(cfg: dict) -> int:
    """Weights of one layer's projections (norm scales and biases apart)."""
    return sum(i * o for _, i, o in projections(cfg))


def lora_params(cfg: dict, rank: int) -> int:
    """LoRA factor entries of one layer at ``rank``: A (r, in), B (out, r)
    on every adapted projection."""
    targets = set(cfg["lora_targets"])
    return sum(rank * (i + o) for name, i, o in projections(cfg)
               if name in targets)


# -- the federated round's client training ------------------------------------

def client_step_flops(cfg: dict, batch: int, rank: int) -> float:
    """Model operations of one local step of one client: the forward, the
    backward to the activations (the base weights are frozen, so none of
    their gradients), and the LoRA products at the client's own rank
    (forward, activation and factor gradients). The patch projection's
    input needs no gradient; the head's logits are read at the class
    position alone. Nothing is counted twice: no layer is recomputed."""
    t = cfg["tokens_per_image"]
    n = batch * t
    layers = cfg["num_hidden_layers"]
    d, e, v = cfg["hidden_size"], cfg["embed_dim"], cfg["num_labels"]
    heads, hd = cfg["num_attention_heads"], cfg["head_dim"]
    body = 2.0 * n * layers * layer_params(cfg)
    attn = layers * 4.0 * batch * t * t * heads * hd   # Q K^T and P V
    head = 2.0 * batch * d * v
    forward = body + 2.0 * n * e * d + attn + head
    backward = body + 2.0 * attn + head
    lora = 6.0 * n * layers * lora_params(cfg, rank)
    return forward + backward + lora


def round_train_flops(cfg: dict, batch: int, steps: int,
                      ranks: Iterable[int]) -> float:
    """Every sampled client's local steps of one round."""
    return sum(steps * client_step_flops(cfg, batch, r) for r in ranks)


def k12_bound_s(layers: int, clients: int, d: int, n: int, r: int,
                fallback: bool) -> float:
    """The least time of K1 then K2 for one shape bucket of the kernel
    backend's aggregation, f32, each kernel at its own bound: K1 reads the
    client stacks (M, L, d, r) and (M, L, r, n), the weights (M', r) and,
    with the Eq. 8 fallback (one more client of the global factors), the
    global (L, d, r) and (L, r, n), and writes U_c (L, d, R) and V_c (L,
    R, n), R = M' r, one multiply an output; K2 reads U_c and V_c and
    writes the Gram cores (L, R, R) twice, computing their symmetric
    halves (d R (R + 1) and n R (R + 1) operations a layer). Operations
    at the f32-accurate 3xTF32 rate."""
    m = clients + (1 if fallback else 0)
    rr = m * r
    k1_in = clients * layers * r * (d + n) + m * r
    if fallback:
        k1_in += layers * r * (d + n)
    k1_out = layers * rr * (d + n)
    k2_out = 2 * layers * rr * rr
    k1 = bound_s(4.0 * (k1_in + k1_out), k1_out, PEAK_TF32X3_FLOPS)
    k2 = bound_s(4.0 * (k1_out + k2_out),
                 layers * rr * (rr + 1) * (d + n), PEAK_TF32X3_FLOPS)
    return k1 + k2


# -- serving ------------------------------------------------------------------

def k4_work(rows: int, k: int, n: int, rank: int, pages: int,
            itemsize: int) -> tuple:
    """(bytes, flops) of one K4 call: x (rows, k) and W (k, n) read, the
    ``pages`` pages' A (rank, k) and B (n, rank) read, y (rows, n)
    written; 2 rows k n for the base product and 2 rows rank (k + n) for
    the adapter terms."""
    nbytes = itemsize * (rows * k + k * n + pages * rank * (k + n)
                         + rows * n)
    flops = 2.0 * rows * k * n + 2.0 * rows * rank * (k + n)
    return nbytes, flops


def decode_step_work(cfg: dict, kv_lens: Sequence[int],
                     row_ranks: Sequence[int],
                     page_ranks: Sequence[int]) -> tuple:
    """(bytes, flops) of one decode step over the active rows: each row's
    cache length ``kv_lens`` before the step and tenant rank
    ``row_ranks``; ``page_ranks`` the ranks of the distinct tenants the
    rows use. Bytes: every weight read once but the token table (a row
    of it a row), the pages at their ranks, the KV cache up to each row's
    length, the new K and V written, the logits written. FLOPs: the
    projections and the head for every active row, the adapter terms at
    the row's rank, and attention over the row's keys (the new one
    included)."""
    it = ITEMSIZE[cfg["dtype"]]
    layers, d, v = cfg["num_hidden_layers"], cfg["hidden_size"], \
        cfg["vocab_size"]
    q, kv = attn_width(cfg)
    rows = len(kv_lens)
    weights = layers * (layer_params(cfg) + 2 * d) + d * v + d
    pages = sum(layers * lora_params(cfg, r) for r in page_ranks)
    cache = sum(layers * 2 * kv * ln for ln in kv_lens)
    nbytes = it * (weights + pages + cache + rows * d
                   + rows * layers * 2 * kv + rows * v)
    flops = 2.0 * rows * (layers * layer_params(cfg) + d * v)
    flops += sum(2.0 * layers * lora_params(cfg, r) for r in row_ranks)
    flops += sum(layers * 4.0 * q * (ln + 1) for ln in kv_lens)
    return nbytes, flops


def prefill_row_flops(cfg: dict, tokens: int, rank: int) -> float:
    """Model operations of one admitted prompt: the projections and the
    adapter terms at the tenant's rank for every token, causal attention
    (token i attends to i + 1 keys), and the head at the last position,
    whose logits give the first token."""
    layers, d, v = cfg["num_hidden_layers"], cfg["hidden_size"], \
        cfg["vocab_size"]
    q, _ = attn_width(cfg)
    flops = 2.0 * tokens * layers * (layer_params(cfg)
                                     + lora_params(cfg, rank))
    flops += layers * 4.0 * q * tokens * (tokens + 1) / 2
    return flops + 2.0 * d * v
