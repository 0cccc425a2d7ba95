"""The paper's models in the port's config system: copies of the
``vit-base`` and ``llama3.1-8b`` entries of ``repro.configs.paper_models``
(``roberta-base`` and ``llama3.2-3b`` wait for ROADMAP.md queue 1 item
10)."""
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
