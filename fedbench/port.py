"""The benchmark's one bridge to the system under test: the port's model
configuration for a configuration file, held to the file's published
widths. The drivers import the port's entry points themselves, inside
their set-up, so that nothing of it loads before the harness has checked
for the card."""
from __future__ import annotations

import dataclasses

# a configuration file's key -> how the port's ModelConfig holds it
WIDTHS = {
    "num_hidden_layers": lambda m: m.num_layers,
    "hidden_size": lambda m: m.d_model,
    "num_attention_heads": lambda m: m.num_heads,
    "num_key_value_heads": lambda m: m.num_kv_heads,
    "head_dim": lambda m: m.resolved_head_dim,
    "intermediate_size": lambda m: m.d_ff,
    "vocab_size": lambda m: m.vocab_size,
    "num_labels": lambda m: m.vocab_size,
    "tokens_per_image": lambda m: m.frontend.tokens_per_item,
    "embed_dim": lambda m: m.frontend.embed_dim,
    "hidden_act": lambda m: m.activation,
    "qkv_bias": lambda m: m.qkv_bias,
    "rope_theta": lambda m: m.rope_theta,
    "rms_norm_eps": lambda m: m.rms_norm_eps,
    "tie_word_embeddings": lambda m: m.tie_embeddings,
}


def model_config(cfg: dict):
    """The port's registered configuration ``cfg["port"]["config"]`` with
    ``cfg["port"]["replace"]`` applied (a dict replaces fields of a nested
    configuration); raises where it differs from a
    width the file states."""
    from repro_torch.configs import get_config
    port = cfg["port"]
    mc = get_config(port["config"])
    mc = dataclasses.replace(mc, **{
        k: (dataclasses.replace(getattr(mc, k), **v) if isinstance(v, dict)
            else v) for k, v in port.get("replace", {}).items()})
    wrong = {k: (cfg[k], get(mc)) for k, get in WIDTHS.items()
             if k in cfg and cfg[k] != get(mc)}
    if wrong:
        raise ValueError(f"the port's {port['config']} differs from the "
                         f"configuration file: {wrong}")
    return mc
