"""The paper's own evaluation models in the port's config system: copies
of the four entries of ``repro.configs.paper_models``, field for field.

The paper fine-tunes ViT-base (vision), RoBERTa-base (text), and
LLaMA-3.2-3B / LLaMA-3.1-8B (reasoning)."""
from repro_torch.configs.base import (ACT_GELU, ACT_SWIGLU, ATTN_BIDIR,
                                      FrontendConfig, ModelConfig, register)

# ViT-base backbone (encoder; patch frontend stubbed)
VIT_BASE = register(ModelConfig(
    name="vit-base",
    kind="vlm",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=100,            # CIFAR-100-like classifier head
    activation=ACT_GELU,
    attn_type=ATTN_BIDIR,
    rope_type="none",
    qkv_bias=True,
    frontend=FrontendConfig(kind="vision", embed_dim=768, tokens_per_item=197),
    lora_targets=("q_proj", "k_proj", "v_proj", "o_proj", "up_proj", "down_proj"),
    source="ViT-B/16 [arXiv:2010.11929]; paper's vision model",
))

# RoBERTa-base (encoder-only)
ROBERTA_BASE = register(ModelConfig(
    name="roberta-base",
    kind="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50265,
    activation=ACT_GELU,
    attn_type=ATTN_BIDIR,
    rope_type="none",
    qkv_bias=True,
    lora_targets=("q_proj", "k_proj", "v_proj", "o_proj", "up_proj", "down_proj"),
    source="RoBERTa-base [arXiv:1907.11692]; paper's NLU model",
))

# LLaMA-3.2-3B
LLAMA32_3B = register(ModelConfig(
    name="llama3.2-3b",
    kind="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    activation=ACT_SWIGLU,
    rope_theta=500_000.0,
    tie_embeddings=True,
    lora_targets=("q_proj", "v_proj"),   # paper: LoRA on Q,V for reasoning
    source="LLaMA-3.2-3B [meta llama3.2]; paper's 3B reasoning model",
))

# LLaMA-3.1-8B
LLAMA31_8B = register(ModelConfig(
    name="llama3.1-8b",
    kind="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    activation=ACT_SWIGLU,
    rope_theta=500_000.0,
    lora_targets=("q_proj", "v_proj"),
    source="LLaMA-3.1-8B [arXiv:2407.21783]; paper's 8B reasoning model",
))
