"""qwen2-7b -- dense, GQA kv=4, QKV bias [arXiv:2407.10671] (a copy of
``repro/configs/qwen2_7b.py``)."""
from repro_torch.configs.base import ACT_SWIGLU, ModelConfig, register

QWEN2_7B = register(ModelConfig(
    name="qwen2-7b",
    kind="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,            # GQA kv=4
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    activation=ACT_SWIGLU,
    qkv_bias=True,             # QKV bias per assignment
    rope_theta=1_000_000.0,
    lora_targets=("q_proj", "k_proj", "v_proj", "o_proj"),
    source="Qwen2-7B [arXiv:2407.10671]; GQA kv=4, QKV bias",
))
