"""hubert-xlarge -- audio encoder-only transformer (w2v2 arch)
[arXiv:2106.07447] (a copy of ``repro/configs/hubert_xlarge.py``).

Encoder-only: no decode step exists. The mel-spectrogram + conv feature
extractor is a stub: the model takes precomputed frame embeddings.
"""
from repro_torch.configs.base import (ACT_GELU, ATTN_BIDIR, FrontendConfig,
                                      ModelConfig, register)

HUBERT_XLARGE = register(ModelConfig(
    name="hubert-xlarge",
    kind="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,           # full MHA
    head_dim=80,
    d_ff=5120,
    vocab_size=504,            # k-means target codebook
    activation=ACT_GELU,
    attn_type=ATTN_BIDIR,      # encoder-only
    rope_type="none",          # learned/conv positions in the stubbed frontend
    qkv_bias=True,
    frontend=FrontendConfig(kind="audio", embed_dim=1280, tokens_per_item=0),
    lora_targets=("q_proj", "k_proj", "v_proj", "o_proj"),
    source="HuBERT X-Large [arXiv:2106.07447]; encoder-only, conv codec stubbed",
))
