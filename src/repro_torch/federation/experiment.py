"""End-to-end FedLoRA experiment setup (paper Section 6 proxy), ported
from ``repro/federation/experiment.py`` with the same signature and
defaults plus ``device=`` (None means the card) and ``base_params=``.

Builds the synthetic classification task: a reduced ViT-style encoder
(patch-embedding frontend, class logit read at position 0), non-IID
client shards, heterogeneous ranks, and a ``FederatedLoRA`` server.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import (ACT_GELU, ATTN_BIDIR, FLConfig,
                                      FrontendConfig, LoRAConfig, ModelConfig)
from repro_torch.data import ClusterClassification, batches, make_partition
from repro_torch.federation.server import FederatedLoRA
from repro_torch.federation.topology import ClientRegistry
from repro_torch.models.transformer import Model


def fedvit_config(d_model: int = 128, num_layers: int = 2,
                  num_classes: int = 20, patches: int = 8) -> ModelConfig:
    """Tiny ViT-family encoder for the CPU-scale paper experiments."""
    return ModelConfig(
        name="fedvit-tiny",
        kind="vlm",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=4,
        num_kv_heads=4,
        head_dim=d_model // 4,
        d_ff=d_model * 4,
        vocab_size=num_classes,
        activation=ACT_GELU,
        attn_type=ATTN_BIDIR,
        rope_type="none",
        qkv_bias=True,
        frontend=FrontendConfig(kind="vision", embed_dim=d_model,
                                tokens_per_item=patches),
        lora_targets=("q_proj", "k_proj", "v_proj", "o_proj",
                      "up_proj", "down_proj"),
        source="paper-proxy: ViT-base downscaled for CPU federated runs",
    )


def to_batch(x: np.ndarray, y: np.ndarray, num_positions: int) -> dict:
    """Classification batch (numpy): the label is read at position 0."""
    b = x.shape[0]
    targets = np.zeros((b, num_positions), np.int32)
    targets[:, 0] = y
    mask = np.zeros((b, num_positions), np.float32)
    mask[:, 0] = 1.0
    return {"embeds": np.asarray(x, np.float32), "targets": targets,
            "loss_mask": mask}


def make_batch_fn(registry: ClientRegistry, x: np.ndarray, y: np.ndarray,
                  fl: FLConfig, batches_per_round: int, positions: int):
    """batch_fn(client_id, rng): the client's shuffled minibatches, at most
    ``batches_per_round`` of them (the reference's rng consumption)."""
    def batch_fn(client_id: int, rng: np.random.Generator) -> list:
        idx = registry.shards[client_id]
        out = []
        for bx, by in batches(x[idx], y[idx], fl.local_batch_size, rng,
                              epochs=fl.local_epochs):
            out.append(to_batch(bx, by, positions))
            if len(out) >= batches_per_round:
                break
        return out
    return batch_fn


@dataclass
class FLExperiment:
    server: FederatedLoRA
    model: Model
    test_batch: dict
    registry: ClientRegistry

    def eval_accuracy(self) -> float:
        return self.server.evaluate(self.test_batch)["accuracy"]


def _not_ported(name: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{name} is not ported yet (ROADMAP.md queue 1 item {item})")


def build_experiment(method: str = "raflora", *,
                     fl_overrides: Optional[dict] = None,
                     lora_overrides: Optional[dict] = None,
                     num_classes: int = 20,
                     d_model: int = 128,
                     modes_per_class: int = 4,
                     noise: float = 0.6,
                     samples_per_class: int = 100,
                     batches_per_round: int = 2,
                     backend: str = "factored",
                     partial_up_to: Optional[int] = None,
                     noisy_low_rank_std: float = 0.0,
                     server_momentum_beta: float = 0.0,
                     round_engine: str = "batched",
                     mesh=None,
                     pipeline_depth: int = 1,
                     staleness_gamma: float = 1.0,
                     event_scheduler=None,
                     transport=None,
                     data_seed: int = 0,
                     device=None,
                     base_params: Optional[dict] = None) -> FLExperiment:
    if noisy_low_rank_std > 0:
        raise _not_ported("noisy low-rank client data (noisy_low_rank_std=)",
                          6)
    if server_momentum_beta > 0:
        raise _not_ported("server momentum", 7)
    if mesh is not None:
        raise _not_ported("the sharded engine (mesh=)", 9)
    if pipeline_depth != 1 or staleness_gamma != 1.0 or event_scheduler:
        raise _not_ported("the async and event engines", 8)
    if transport is not None:
        raise _not_ported("the compressed transport", 8)
    fl = FLConfig(aggregator=method, num_clients=20, participation=0.25,
                  num_rounds=40, local_batch_size=32, learning_rate=2e-3,
                  partition="pathological", dirichlet_alpha=1.0,
                  labels_per_client=max(num_classes // 4, 2))
    if fl_overrides:
        fl = dataclasses.replace(fl, **fl_overrides)
    lora = LoRAConfig(rank_levels=(4, 8, 16, 24, 32),
                      rank_probs=(0.2, 0.2, 0.2, 0.2, 0.2))
    if lora_overrides:
        lora = dataclasses.replace(lora, **lora_overrides)

    data = ClusterClassification(
        num_classes=num_classes, dim=d_model, patches=8,
        modes_per_class=modes_per_class, noise=noise,
        samples_per_class=samples_per_class, seed=data_seed)
    (x_tr, y_tr), (x_te, y_te) = data.train_test_split()
    shards = make_partition(fl.partition, y_tr, fl.num_clients,
                            alpha=fl.dirichlet_alpha,
                            labels_per_client=fl.labels_per_client,
                            seed=fl.seed)
    cfg = fedvit_config(d_model=d_model, num_classes=num_classes,
                        patches=data.patches)
    model = Model(cfg, lora, dtype=torch.float32, device=device)
    registry = ClientRegistry.create(fl, lora, shards)
    batch_fn = make_batch_fn(registry, x_tr, y_tr, fl, batches_per_round,
                             data.patches)
    server = FederatedLoRA(model, fl, lora, registry, batch_fn,
                           base_params=base_params, backend=backend,
                           partial_up_to=partial_up_to,
                           round_engine=round_engine)
    test_batch = to_batch(x_te[:512], y_te[:512], data.patches)
    return FLExperiment(server=server, model=model, test_batch=test_batch,
                        registry=registry)
