"""mamba2-1.3b -- SSD (state-space duality), attention-free
[arXiv:2405.21060] (a copy of ``repro/configs/mamba2_1p3b.py``)."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

MAMBA2_1P3B = register(ModelConfig(
    name="mamba2-1.3b",
    kind="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,            # attention-free
    num_kv_heads=0,
    d_ff=0,                 # no separate FFN in mamba2 blocks
    vocab_size=50280,
    rope_type="none",
    attn_type="full",       # unused
    tie_embeddings=True,
    ssm=SSMConfig(
        state_dim=128,      # ssm_state=128 per assignment
        head_dim=64,
        expand=2,           # d_inner = 4096 -> 64 SSD heads
        conv_dim=4,
        chunk_size=256,
        ngroups=1,
    ),
    lora_targets=("ssm_in_proj", "ssm_out_proj"),
    source="SSD / Mamba-2 [arXiv:2405.21060]; state=128, d_model=2048, 48 layers",
))
