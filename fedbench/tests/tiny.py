"""Small versions of the cells' configurations and mixes, for runs of the
whole harness on the CPU."""
import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
FEDBENCH = os.path.dirname(HERE)


def _load(*parts):
    with open(os.path.join(FEDBENCH, *parts)) as f:
        return json.load(f)


def vit_config() -> dict:
    cfg = _load("configs", "vit_base.json")
    small = {"num_hidden_layers": 2, "hidden_size": 32,
             "num_attention_heads": 4, "num_key_value_heads": 4,
             "head_dim": 8, "intermediate_size": 64, "tokens_per_image": 9,
             "embed_dim": 24, "num_labels": 10}
    cfg.update(small)
    cfg["port"] = {"config": "vit-base", "replace": {
        "num_layers": 2, "d_model": 32, "num_heads": 4, "num_kv_heads": 4,
        "head_dim": 8, "d_ff": 64, "vocab_size": 10,
        "frontend": {"embed_dim": 24, "tokens_per_item": 9}}}
    cfg["federation"] = dict(cfg["federation"], num_clients=12,
                             local_batch_size=4, samples_per_class=30,
                             pool_images_per_class=4)
    return cfg


def round_traffic(name: str) -> dict:
    tr = _load("traffic", name + ".json")
    return dict(tr, participation=0.25, rank_levels=[2, 4, 8],
                rank_probs=[0.4, 0.3, 0.3],
                local_steps=min(tr["local_steps"], 3))


def decoder_config() -> dict:
    cfg = _load("configs", "nemotron_4_340b.json")
    small = {"num_hidden_layers": 2, "hidden_size": 48,
             "num_attention_heads": 6, "num_key_value_heads": 2,
             "head_dim": 8, "intermediate_size": 96, "vocab_size": 128}
    cfg.update(small)
    cfg["dtype"] = "float32"
    cfg["port"] = {"config": "nemotron-4-340b", "replace": {
        "num_layers": 2, "d_model": 48, "num_heads": 6, "num_kv_heads": 2,
        "head_dim": 8, "d_ff": 96, "vocab_size": 128}}
    cfg["serving"] = {"rank_levels": [2, 4, 8]}
    return cfg


def serve_traffic(name: str) -> dict:
    tr = _load("traffic", name + ".json")
    return dict(tr, slots=min(tr["slots"], 4), prompt_len=12,
                out_min=min(tr["out_min"], 6), out_max=min(tr["out_max"], 6),
                tenants=5, checked_requests=3)


def copy_of(d: dict) -> dict:
    return copy.deepcopy(d)
