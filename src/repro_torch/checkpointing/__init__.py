from repro_torch.checkpointing.checkpoint import (load_flat, load_metadata,
                                                  load_pytree, save_flat,
                                                  save_pytree)

__all__ = ["load_flat", "load_metadata", "load_pytree", "save_flat",
           "save_pytree"]
