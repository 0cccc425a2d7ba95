"""The check's control on the card: the reference computed in the precision
below the configuration's, in the program's place, must come out not
correct under the cells' limits. At the configurations' published widths
with fewer layers, clients and rows, so that a test run holds it; the
limits were set from the same readings at the cells' own sizes
(``fedbench/calibrate.py``)."""
import copy

import numpy as np
import pytest
import torch

from fedbench import harness, workload
from fedbench.reference.decoder import Decoder

SEEDS = (11, 12, 13)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_round_control_is_not_correct(seed):
    _card()
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell_name = "vit_base.local_epoch"
    spec = harness.cell_spec(bench, cell_name)
    cfg = harness.load_json(harness.HERE, "configs", spec["config"] + ".json")
    cfg = copy.deepcopy(cfg)
    cfg["num_hidden_layers"] = 2
    cfg["port"]["replace"] = {"num_layers": 2}
    traffic = harness.load_json(harness.HERE, "traffic",
                                spec["traffic"] + ".json")
    traffic = dict(traffic, local_steps=2, checked_rounds=2)
    cell = harness.make_cell(bench, cell_name, seed, "cuda", cfg=cfg,
                             traffic=traffic)
    cell.setup()
    cell.release()
    refr = cell.reference()
    control = cell.numbers(cell.reference(tf32=True), refr)
    limits = harness.limits_of(cell_name)
    assert any(v > limits[k] for k, v in control.items()), (control, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_is_not_correct(seed):
    """fp8 e4m3 weights and activations at Nemotron's head and attention
    widths (2 layers, a 32000-id slice of the vocabulary): at each position
    of the sequences, the token the control puts first lies farther below
    the f32 reference's best than the cells' limit allows."""
    _card()
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cfg = copy.deepcopy(harness.load_json(harness.HERE, "configs",
                                          "nemotron_4_340b.json"))
    cfg.update(num_hidden_layers=2, intermediate_size=18432,
               vocab_size=32000)
    dev = "cuda"
    base_shapes = {("embed",): (32000, 18432), ("final_norm", "scale"):
                   (18432,), ("lm_head", "w"): (18432, 32000)}
    for name, i, o in (("q", 18432, 18432), ("k", 18432, 1536),
                       ("v", 18432, 1536), ("o", 18432, 18432)):
        base_shapes[("layers", "attn", name, "w")] = (2, i, o)
    base_shapes[("layers", "mlp", "up", "w")] = (2, 18432, 18432)
    base_shapes[("layers", "mlp", "down", "w")] = (2, 18432, 18432)
    for n in ("norm1", "norm2"):
        base_shapes[("layers", n, "scale")] = (2, 18432)
    base = workload.build(workload.draw_tree(
        base_shapes, workload.generator(seed, 0, dev), torch.bfloat16, dev))
    tshapes = {}
    for block, name, i, o in (("attn", "q", 18432, 18432),
                              ("attn", "k", 18432, 1536),
                              ("attn", "v", 18432, 1536),
                              ("attn", "o", 18432, 18432),
                              ("mlp", "up", 18432, 18432),
                              ("mlp", "down", 18432, 18432)):
        tshapes[("layers", block, name, "lora_a")] = (2, 64, i)
        tshapes[("layers", block, name, "lora_b")] = (2, o, 64)
    tenant = workload.build(workload.draw_tree(
        tshapes, workload.generator(seed, 5, dev), torch.bfloat16, dev,
        rule=workload.tenant_rule))
    rng = np.random.default_rng(seed)
    seqs = [torch.as_tensor(rng.integers(0, 32000, 160), device=dev)
            for _ in range(2)]
    pos = [list(range(63, 159))] * 2
    with torch.no_grad():
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = Decoder(cfg, base).logits(seqs, [tenant] * 2, [48, 48], pos)
        ctl = Decoder(cfg, base, fp8=True).logits(seqs, [tenant] * 2,
                                                  [48, 48], pos)
    pick = ctl.argmax(-1)
    gap = float((ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]
                 ).max())
    limit = min(harness.limits_of(w["name"])["gap"]
                for w in bench["workloads"]
                if w["config"] == "nemotron_4_340b")
    assert gap > limit, (gap, limit)
