"""Multi-tenant adapter serving (DESIGN.md §11), ported from
``repro/serving``: the paged adapter cache with atomic hot-swap
(``AdapterStore``) and the batched multi-adapter engine over the paged
LoRA kernel K4 (``ServingEngine``). The continuous batcher is not ported
yet (ROADMAP.md queue 1 item 11)."""
from repro_torch.serving.adapter_store import AdapterStore, PublishedAdapters
from repro_torch.serving.engine import ServingEngine, seed_cache

__all__ = ["AdapterStore", "PublishedAdapters", "ServingEngine",
           "seed_cache"]
