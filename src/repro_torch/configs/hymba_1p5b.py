"""hymba-1.5b -- hybrid: parallel attention + mamba heads per layer
[arXiv:2411.13676] (a copy of ``repro/configs/hymba_1p5b.py``).

Each block runs attention heads and SSM heads in parallel on the same
normed input and mixes their outputs. Most layers use sliding-window
attention, with a global layer every ``global_attn_every`` layers."""
from repro_torch.configs.base import (ACT_SWIGLU, ATTN_SLIDING, ModelConfig,
                                      SSMConfig, register)

HYMBA_1P5B = register(ModelConfig(
    name="hymba-1.5b",
    kind="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,           # GQA kv=5
    head_dim=64,              # 1600 / 25
    d_ff=5504,
    vocab_size=32001,
    activation=ACT_SWIGLU,
    attn_type=ATTN_SLIDING,
    sliding_window=1024,      # hymba uses SWA in most layers
    global_attn_every=16,     # a few global-attention layers
    ssm=SSMConfig(
        state_dim=16,         # ssm_state=16 per assignment
        head_dim=50,          # d_inner=3200 -> 64 heads of 50
        expand=2,
        conv_dim=4,
        chunk_size=128,
        ngroups=1,
    ),
    hybrid_attn_ratio=0.5,
    lora_targets=("q_proj", "k_proj", "v_proj", "o_proj",
                  "ssm_in_proj", "ssm_out_proj"),
    source="Hymba-1.5B [arXiv:2411.13676]; parallel attn+mamba heads, SWA+global",
))
