"""llama4-maverick-400b-a17b -- MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E] (a copy of
``repro/configs/llama4_maverick_400b_a17b.py``).

Dense and MoE FFN layers alternate (period 2, the odd layers MoE), so the
model stacks its layers in groups of two (``sub0`` dense, ``sub1`` MoE).
Image patches enter the token stream through the vision frontend stub."""
from repro_torch.configs.base import (ACT_SWIGLU, FrontendConfig, MoEConfig,
                                      ModelConfig, register)

LLAMA4_MAVERICK = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    kind="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,            # GQA kv=8
    head_dim=128,
    d_ff=8192,                 # expert intermediate size
    vocab_size=202048,
    activation=ACT_SWIGLU,
    rope_theta=500_000.0,
    moe=MoEConfig(
        num_experts=128,
        top_k=1,               # top-1 routing
        num_shared_experts=1,  # llama4 keeps one shared expert
        expert_d_ff=8192,
        shared_d_ff=8192,
        moe_layer_period=2,    # interleaved dense/MoE layers
        moe_layer_offset=1,
    ),
    # early fusion: image patches enter the token stream directly
    frontend=FrontendConfig(kind="vision", embed_dim=5120, tokens_per_item=144),
    lora_targets=("q_proj", "k_proj", "v_proj", "o_proj"),
    source="Llama-4 Maverick [hf:meta-llama/Llama-4-Scout-17B-16E]; MoE top-1, early fusion",
))
