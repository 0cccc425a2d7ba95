"""Configuration dataclasses of the PyTorch port.

A copy of the parts of ``repro.configs.base`` that the federated round
and the serving engine use, so the port imports nothing of the JAX
package: ``ModelConfig`` (with ``reduced()``), ``FrontendConfig``,
``LoRAConfig``, ``FLConfig`` and the ``ACT_*`` / ``ATTN_*`` constants. Field names, defaults and derived properties are the
reference's, so a config built on one side means the same on the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

ATTN_FULL = "full"            # causal full attention
ATTN_SLIDING = "sliding"      # sliding-window causal attention
ATTN_BIDIR = "bidirectional"  # encoder-only

ACT_GELU = "gelu"
ACT_GEGLU = "geglu"
ACT_SWIGLU = "swiglu"
ACT_RELU2 = "relu2"           # squared ReLU


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: precomputed embeddings of ``embed_dim``."""

    kind: str = "none"             # "audio" | "vision" | "none"
    embed_dim: int = 0
    tokens_per_item: int = 0


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. The MoE / MLA / SSM sub-configs are kept as
    opaque fields: the port's model refuses them (ROADMAP.md queue 1
    item 10)."""

    name: str
    kind: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    activation: str = ACT_SWIGLU
    attn_type: str = ATTN_FULL
    sliding_window: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_type: str = "default"
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    rms_norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    ssm: Optional[Any] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    hybrid_attn_ratio: float = 0.5
    global_attn_every: int = 0
    lora_targets: Tuple[str, ...] = ("q_proj", "v_proj")
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_encoder_only(self) -> bool:
        return self.attn_type == ATTN_BIDIR

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder_only

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                vocab_size: int = 512) -> "ModelConfig":
        """A smoke-test variant of the same family (<=2 layers, d<=512),
        with the reference's numbers for every field the port knows. The
        MoE / MLA / SSM sub-configs stay as they are: the port's model
        refuses them."""
        d_model = min(d_model, 512)
        scale = d_model / self.d_model
        num_heads = max(2, min(self.num_heads, 4))
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        while num_heads % num_kv:
            num_kv -= 1
        head_dim = max(16, d_model // num_heads)
        d_ff = max(32, int(self.d_ff * scale)) if self.d_ff else 0
        frontend = self.frontend
        if frontend.kind != "none":
            frontend = dataclasses.replace(
                frontend, embed_dim=d_model,
                tokens_per_item=min(frontend.tokens_per_item, 16) or 16)
        mrope_sections = self.mrope_sections
        if self.rope_type == "mrope":
            half = head_dim // 2
            s1 = max(1, half // 4)
            s2 = (half - s1) // 2
            mrope_sections = (s1, s2, half - s1 - s2)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=d_ff,
            vocab_size=vocab_size,
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
            mrope_sections=mrope_sections,
            frontend=frontend,
        )


@dataclass(frozen=True)
class LoRAConfig:
    """Heterogeneous-rank LoRA settings (paper Table 6-9 defaults)."""

    rank_levels: Tuple[int, ...] = (8, 16, 32, 48, 64)
    rank_probs: Tuple[float, ...] = (0.2, 0.2, 0.2, 0.2, 0.2)
    alpha_equals_rank: bool = True   # LoRA alpha = r_k -> unit scaling
    alpha: float = 0.0               # used when alpha_equals_rank=False
    dropout: float = 0.0
    init_b_zero: bool = True
    variant: str = "lora"            # "lora" | "dora" | "qlora"
    quant_bits: int = 4

    @property
    def r_max(self) -> int:
        return max(self.rank_levels)

    def scaling(self, rank: int) -> float:
        if self.alpha_equals_rank:
            return 1.0
        return self.alpha / rank


@dataclass(frozen=True)
class FLConfig:
    """Federated fine-tuning settings (paper Section 6.1 defaults)."""

    num_clients: int = 100
    participation: float = 0.10
    num_rounds: int = 100
    local_epochs: int = 1
    local_batch_size: int = 32
    learning_rate: float = 5e-4
    lr_schedule: str = "linear"
    weight_decay: float = 0.0
    aggregator: str = "raflora"
    seed: int = 0
    partition: str = "dirichlet"     # "iid" | "dirichlet" | "pathological"
    dirichlet_alpha: float = 1.0
    labels_per_client: int = 20

    @property
    def clients_per_round(self) -> int:
        return max(1, int(round(self.num_clients * self.participation)))


_REGISTRY: dict = {}


def register(config: ModelConfig) -> ModelConfig:
    if config.name in _REGISTRY:
        raise ValueError(f"duplicate architecture {config.name!r}")
    _REGISTRY[config.name] = config
    return config


def get_config(name: str) -> ModelConfig:
    from repro_torch.configs import paper_models, qwen2_7b  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown architecture {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
