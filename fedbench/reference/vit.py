"""Plain PyTorch reference of a raFLoRA round of the ViT-family encoder.

Written from the paper (Algorithm 1, Eq. 8 and FlexLoRA's SVD
reallocation) and the encoder's equations as the port's configuration
states them, with none of the program's code: per layer, RMS norm with an
f32 statistic; q, k, v (with bias), o, up and down projections, each with
its LoRA term ``(x A^T) B^T`` at the client's own rank (alpha = r, so the
scale is 1); full bidirectional softmax attention; the tanh-approximated
GELU; the class logits read at position 0 after a final RMS norm; the
masked cross-entropy there. Each client trains alone, one step at a
time, with AdamW (b1 0.9, b2 0.999, eps 1e-8, no decay) on its own
factors sliced to its rank. The server computes the rank-partitioned
update dW = sum_k B_k diag(omega_k) A_k, with the current global factors
in every partition that no sampled client covers (Eq. 8), as a dense
(d, n) matrix, takes its SVD and keeps the top r_max triplets: B_g = U S,
A_g = V^T, in the paper's layout (B = lora_a^T, A = lora_b^T).

Everything runs in float32. On the card, matrix products run in IEEE f32
(TF32 off) unless ``tf32`` asks for the control.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

ADAPTERS = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
            ("mlp", "up"), ("mlp", "down"))


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in IEEE f32, or in TF32 for the control."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x * x * x)))


def dense(x, p: dict, layer: int, lora: dict = None):
    y = x @ p["w"][layer]
    if "b" in p:
        y = y + p["b"][layer]
    if lora is not None:
        y = y + (x @ lora["a"][layer].mT) @ lora["b"][layer].mT
    return y


def class_logits(cfg: dict, base: dict, lora: dict, embeds):
    """Logits (B, V) at the class position. ``lora``: {(block, proj):
    {"a": (L, r, in), "b": (L, out, r)}}."""
    heads, hd = cfg["num_attention_heads"], cfg["head_dim"]
    eps = cfg["rms_norm_eps"]
    x = embeds @ base["frontend_proj"]["w"]
    b, t, _ = x.shape
    lay = base["layers"]
    for i in range(cfg["num_hidden_layers"]):
        h = rms_norm(x, lay["norm1"]["scale"][i], eps)
        q, k, v = (dense(h, lay["attn"][n], i, lora[("attn", n)])
                   .reshape(b, t, heads, hd).transpose(1, 2)
                   for n in ("q", "k", "v"))
        p = torch.softmax((q @ k.mT) * hd ** -0.5, dim=-1)
        att = (p @ v).transpose(1, 2).reshape(b, t, heads * hd)
        x = x + dense(att, lay["attn"]["o"], i, lora[("attn", "o")])
        h = rms_norm(x, lay["norm2"]["scale"][i], eps)
        up = dense(h, lay["mlp"]["up"], i, lora[("mlp", "up")])
        x = x + dense(gelu_tanh(up), lay["mlp"]["down"], i,
                      lora[("mlp", "down")])
    x0 = rms_norm(x[:, 0], base["final_norm"]["scale"], eps)
    return x0 @ base["lm_head"]["w"]


def class_loss(logits, labels):
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).mean()


def client_train(cfg: dict, base: dict, global_lora: dict, rank: int,
                 batches: List[dict], lr: float, half_batch: bool = False):
    """One client's local steps at its rank. Returns (the factors padded
    back to r_max, each step's loss, the first step's gradient norm of
    each factor leaf {(block, proj, "a"|"b"): norm}). ``half_batch``
    plants a fault: each step sees the first half of its rows."""
    r_max = global_lora[ADAPTERS[0]]["a"].shape[-2]
    params = {}
    for key, f in global_lora.items():
        params[key + ("a",)] = f["a"][:, :rank].clone()
        params[key + ("b",)] = f["b"][:, :, :rank].clone()
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_norms = [], None
    for step, batch in enumerate(batches, start=1):
        emb, lab = batch["embeds"], batch["labels"]
        if half_batch:
            emb, lab = emb[: len(emb) // 2], lab[: len(lab) // 2]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        lora = {key: {"a": leaves[key + ("a",)], "b": leaves[key + ("b",)]}
                for key in global_lora}
        loss = class_loss(class_logits(cfg, base, lora, emb), lab)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if first_norms is None:
            first_norms = {k: float(g.norm()) for k, g in grads.items()}
        with torch.no_grad():
            for k, g in grads.items():
                m[k] = 0.9 * m[k] + 0.1 * g
                s[k] = 0.999 * s[k] + 0.001 * g * g
                mhat = m[k] / (1.0 - 0.9 ** step)
                vhat = s[k] / (1.0 - 0.999 ** step)
                params[k] = params[k] - lr * mhat / (vhat.sqrt() + 1e-8)
    padded = {}
    for key in global_lora:
        a = torch.zeros_like(global_lora[key]["a"])
        b = torch.zeros_like(global_lora[key]["b"])
        a[:, :rank] = params[key + ("a",)]
        b[:, :, :rank] = params[key + ("b",)]
        padded[key] = {"a": a, "b": b}
    return padded, losses, first_norms


def raflora_weights(ranks: Sequence[int], n_k: Sequence[float],
                    levels: Sequence[int]):
    """omega (M, r_max) and the Eq. 8 fallback (r_max,): index i (1-based)
    belongs to the partition of the smallest level h >= i; its
    contributors are the clients with rank >= h, weighted n_k / N_h."""
    levels = sorted(set(levels))
    r_max = levels[-1]
    ranks = np.asarray(ranks)
    n = np.asarray(n_k, dtype=np.float64)
    omega = np.zeros((len(ranks), r_max))
    fallback = np.zeros(r_max)
    for i in range(1, r_max + 1):
        h = min(lv for lv in levels if lv >= i)
        members = ranks >= h
        if n[members].sum() > 0:
            omega[members, i - 1] = n[members] / n[members].sum()
        else:
            fallback[i - 1] = 1.0
    return omega, fallback


def aggregate(client_loras: List[dict], ranks, n_k, levels,
              global_lora: dict) -> dict:
    """raFLoRA's global factors in the model's layout, {(block, proj):
    {"a": B_g^T (L, r, in), "b": A_g^T (L, out, r)}}, with each layer's
    spectrum under "sigma" (L, r) and the update itself under "dw" (L,
    in, out)."""
    omega, fallback = raflora_weights(ranks, n_k, levels)
    out = {}
    for key, g in global_lora.items():
        dev = g["a"].device
        om = torch.as_tensor(omega, dtype=torch.float32, device=dev)
        dw = 0.0
        for k, cl in enumerate(client_loras):
            bk, ak = cl[key]["a"].mT, cl[key]["b"].mT   # (L, d, r), (L, r, n)
            dw = dw + (bk * om[k]) @ ak
        if fallback.any():
            fb = torch.as_tensor(fallback, dtype=torch.float32, device=dev)
            dw = dw + (g["a"].mT * fb) @ g["b"].mT
        # the SVD in f64: the card's f32 SVD leaves residuals of 2e-4 of
        # the matrix's norm, f64's 3e-13
        dw = dw.double()
        u, sig, vt = torch.linalg.svd(dw, full_matrices=False)
        r = g["a"].shape[-2]
        b_g, a_g = u[..., :r] * sig[..., None, :r], vt[..., :r, :]
        out[key] = {"a": b_g.mT.float().contiguous(),
                    "b": a_g.mT.float().contiguous(),
                    "sigma": sig[..., :r], "dw": dw}
    return out


def run_rounds(cfg: dict, base: dict, starts: List[dict], plan: list,
               ranks_of, n_of, lrs, levels, make_batches, tf32=False,
               half_batch=False) -> List[Dict]:
    """The plan's rounds, round r from the global factors ``starts[r]``:
    per round {"clients", "losses" [[step losses] per client],
    "grad_norms" [per client], "client_loras" [per client], "global" (the
    aggregate)}. ``make_batches(ids)`` gives a client's batches on the
    device."""
    out = []
    with precision(tf32):
        for (clients, ids), lr, start in zip(plan, lrs, starts):
            ranks = [ranks_of[c] for c in clients]
            n_k = [n_of[c] for c in clients]
            trained, losses, norms = [], [], []
            for r, cid in zip(ranks, ids):
                lo, ls, gn = client_train(cfg, base, start, r,
                                          make_batches(cid), lr, half_batch)
                trained.append(lo)
                losses.append(ls)
                norms.append(gn)
            out.append({"clients": list(clients), "losses": losses,
                        "grad_norms": norms, "client_loras": trained,
                        "global": aggregate(trained, ranks, n_k, levels,
                                            start)})
    return out
