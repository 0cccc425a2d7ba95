"""gemma-2b -- dense, MQA (kv=1), GeGLU, head_dim=256 [arXiv:2403.08295]
(a copy of ``repro/configs/gemma_2b.py``)."""
from repro_torch.configs.base import ACT_GEGLU, ModelConfig, register

GEMMA_2B = register(ModelConfig(
    name="gemma-2b",
    kind="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,            # MQA on the 2b variant
    head_dim=256,              # explicit (> d_model/num_heads)
    d_ff=16384,
    vocab_size=256000,
    activation=ACT_GEGLU,
    rope_theta=10_000.0,
    tie_embeddings=True,
    lora_targets=("q_proj", "k_proj", "v_proj", "o_proj"),
    source="Gemma-2B [arXiv:2403.08295]; GeGLU, head_dim=256, MQA",
))
