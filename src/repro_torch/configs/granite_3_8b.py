"""granite-3-8b -- dense, GQA kv=8 [hf:ibm-granite/granite-3.0-2b-base]
(a copy of ``repro/configs/granite_3_8b.py``)."""
from repro_torch.configs.base import ACT_SWIGLU, ModelConfig, register

GRANITE_3_8B = register(ModelConfig(
    name="granite-3-8b",
    kind="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,            # GQA kv=8
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    activation=ACT_SWIGLU,
    rope_theta=10_000.0,
    tie_embeddings=True,
    lora_targets=("q_proj", "k_proj", "v_proj", "o_proj"),
    source="Granite-3.0-8B [hf:ibm-granite/granite-3.0-2b-base]; GQA",
))
