"""The paper's vision model in the port's config system (a copy of the
``vit-base`` entry of ``repro.configs.paper_models``)."""
from repro_torch.configs.base import (ACT_GELU, ATTN_BIDIR, FrontendConfig,
                                      ModelConfig, register)

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
