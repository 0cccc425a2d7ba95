"""qwen2-vl-7b -- VLM backbone, M-RoPE, GQA kv=4 [arXiv:2409.12191] (a
copy of ``repro/configs/qwen2_vl_7b.py``).

The vision encoder and projector are a stub: precomputed patch
embeddings of ``embed_dim`` enter through ``frontend_proj``. Only the
language decoder is implemented."""
from repro_torch.configs.base import (ACT_SWIGLU, FrontendConfig, ModelConfig,
                                      register)

QWEN2_VL_7B = register(ModelConfig(
    name="qwen2-vl-7b",
    kind="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,           # GQA kv=4
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    activation=ACT_SWIGLU,
    qkv_bias=True,            # qwen2 family uses QKV bias
    rope_theta=1_000_000.0,
    rope_type="mrope",        # multimodal rotary position embedding
    mrope_sections=(16, 24, 24),
    frontend=FrontendConfig(kind="vision", embed_dim=3584, tokens_per_item=256),
    lora_targets=("q_proj", "k_proj", "v_proj", "o_proj"),
    source="Qwen2-VL-7B [arXiv:2409.12191]; M-RoPE, dynamic-resolution ViT stubbed",
))
