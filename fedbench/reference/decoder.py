"""Plain PyTorch reference of the served decoder, teacher-forced over a
request's prompt and served tokens.

Written from the configuration's equations with none of the program's
code: the token table's rows; per layer, RMS norm, q, k, v and o
projections and the MLP's up and down projections, each with the
tenant's LoRA term ``(x A^T) B^T`` (its factors zero beyond its rank,
unit scale), rotary embeddings on q and k (the head dimension's two
halves rotated by position * theta^(-2i/hd)), causal softmax attention
with query head h reading key/value head h // (H / KVH), squared ReLU;
a final RMS norm and the untied head. Everything in float32 with the
products in IEEE f32: the bf16 weights are read as the bf16 values they
are and widened a matrix at a time, so the reference fits beside them.

``fp8=True`` is the control: every weight and every activation entering
a product rounded to float8 e4m3 with a scale per output channel or per
row, the precision below the configuration's bf16.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
HEAD_BLOCK = 16384   # vocabulary columns of the head widened at a time


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its largest |value| maps to e4m3's largest)."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Decoder:
    def __init__(self, cfg: dict, base: dict, fp8: bool = False):
        self.cfg, self.base, self.fp8 = cfg, base, fp8

    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A weight (in, out) widened to f32 (fp8-rounded per output
        column for the control)."""
        t = t.float()
        return fp8_round(t, 0) if self.fp8 else t

    def x(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t, -1) if self.fp8 else t

    def rms(self, x, scale):
        eps = self.cfg["rms_norm_eps"]
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
            * scale.float()

    def rope(self, t, positions):
        hd = t.shape[-1]
        inv = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float64,
                         device=t.device) / hd))
        ang = (positions[:, None].double() * inv).float()[:, None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = t.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def lora_proj(self, h, w, lora_of, spans, ranks):
        """The projection of the concatenated rows ``h``, with each
        sequence's own tenant term on its rows ``spans[j]``."""
        y = self.x(h) @ self.w(w)
        for j, (lo, hi) in enumerate(spans):
            lora = lora_of(j)
            a = lora["lora_a"].float()[:ranks[j]]
            b = lora["lora_b"].float()[:, :ranks[j]]
            if self.fp8:
                a, b = fp8_round(a, -1), fp8_round(b, 0)
            y[lo:hi] += (self.x(h[lo:hi]) @ a.mT) @ b.mT
        return y

    @torch.no_grad()
    def logits(self, seqs, tenants, ranks, positions_out):
        """Logits (sum of len(positions_out[i]), V) at the positions
        ``positions_out[i]`` of each sequence ``seqs[i]`` (1-D int64 on
        the device), under tenant tree ``tenants[i]`` at ``ranks[i]``.
        The sequences' rows go through each projection together, each
        weight widened once a layer."""
        cfg, base = self.cfg, self.base
        heads, kvh, hd = (cfg["num_attention_heads"],
                          cfg["num_key_value_heads"], cfg["head_dim"])
        spans, lo = [], 0
        for s in seqs:
            spans.append((lo, lo + len(s)))
            lo += len(s)
        x = torch.cat([base["embed"][s].float() for s in seqs])
        lay = base["layers"]
        rep = heads // kvh
        for i in range(cfg["num_hidden_layers"]):
            def proj(h, block, name):
                return self.lora_proj(
                    h, lay[block][name]["w"][i],
                    lambda j: {k: v[i] for k, v in
                               tenants[j]["layers"][block][name].items()},
                    spans, ranks)
            h = self.rms(x, lay["norm1"]["scale"][i])
            q, k, v = (proj(h, "attn", n) for n in ("q", "k", "v"))
            att = torch.empty_like(q)
            for a, b in spans:
                t = b - a
                pos = torch.arange(t, device=x.device)
                qs = self.rope(q[a:b].reshape(t, heads, hd), pos)
                ks = self.rope(k[a:b].reshape(t, kvh, hd), pos)
                vs = v[a:b].reshape(t, kvh, hd)
                ks = ks.repeat_interleave(rep, dim=1).transpose(0, 1)
                vs = vs.repeat_interleave(rep, dim=1).transpose(0, 1)
                scores = (self.x(qs.transpose(0, 1)) @ self.x(ks).mT) \
                    * hd ** -0.5
                causal = torch.ones(t, t, dtype=torch.bool,
                                    device=x.device).tril()
                p = torch.softmax(scores.masked_fill(~causal, -1e30), -1)
                att[a:b] = (self.x(p) @ self.x(vs)).transpose(0, 1
                                                              ).reshape(t, -1)
            x = x + proj(att, "attn", "o")
            h = self.rms(x, lay["norm2"]["scale"][i])
            x = x + proj(torch.relu(proj(h, "mlp", "up")).square(), "mlp",
                         "down")
        rows = torch.cat([x[a + torch.as_tensor(p, device=x.device)]
                          for (a, _), p in zip(spans, positions_out)])
        rows = self.rms(rows, base["final_norm"]["scale"])
        head = base["lm_head"]["w"]
        out = [self.x(rows) @ self.w(head[:, c:c + HEAD_BLOCK])
               for c in range(0, head.shape[1], HEAD_BLOCK)]
        return torch.cat(out, dim=-1)
