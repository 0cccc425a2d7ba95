"""deepseek-v2-236b -- MoE 160e top-6 with 2 shared experts, MLA
kv_lora=512 [arXiv:2405.04434] (a copy of
``repro/configs/deepseek_v2_236b.py``)."""
from repro_torch.configs.base import (ACT_SWIGLU, MLAConfig, MoEConfig,
                                      ModelConfig, register)

DEEPSEEK_V2_236B = register(ModelConfig(
    name="deepseek-v2-236b",
    kind="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA: kv heads == q heads (latent-compressed)
    head_dim=128,
    d_ff=1536,                 # routed-expert intermediate size
    vocab_size=102400,
    activation=ACT_SWIGLU,
    rope_theta=10_000.0,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        num_shared_experts=2,
        expert_d_ff=1536,
        shared_d_ff=1536,
        router_aux_loss_coef=0.001,
    ),
    lora_targets=("q_a_proj", "kv_a_proj", "o_proj"),
    source="DeepSeek-V2 [arXiv:2405.04434]; MLA kv_lora=512, 2 shared + 160 routed top-6",
))
