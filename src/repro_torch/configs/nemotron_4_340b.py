"""nemotron-4-340b -- dense, GQA kv=8, squared-ReLU FFN [arXiv:2402.16819]
(a copy of ``repro/configs/nemotron_4_340b.py``)."""
from repro_torch.configs.base import ACT_RELU2, ModelConfig, register

NEMOTRON_4_340B = register(ModelConfig(
    name="nemotron-4-340b",
    kind="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,           # GQA kv=8
    head_dim=192,             # 18432 / 96
    d_ff=73728,
    vocab_size=256000,
    activation=ACT_RELU2,     # squared ReLU, non-gated
    rope_theta=10_000.0,
    lora_targets=("q_proj", "k_proj", "v_proj", "o_proj", "up_proj", "down_proj"),
    source="Nemotron-4 340B [arXiv:2402.16819]; GQA kv=8, squared-ReLU",
))
