"""Multi-tenant adapter serving (DESIGN.md §11), ported from
``repro/serving``: the paged adapter cache with atomic hot-swap
(``AdapterStore``), the batched multi-adapter engine over the paged LoRA
kernel K4 (``ServingEngine``) and the continuous batcher on the virtual
clock (``ContinuousBatcher``, ``ServeRequest``)."""
from repro_torch.serving.adapter_store import AdapterStore, PublishedAdapters
from repro_torch.serving.engine import ServingEngine, seed_cache
from repro_torch.serving.scheduler import ContinuousBatcher, ServeRequest

__all__ = ["AdapterStore", "ContinuousBatcher", "PublishedAdapters",
           "ServeRequest", "ServingEngine", "seed_cache"]
