from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.schedules import constant, get_schedule, linear_decay

__all__ = ["AdamW", "AdamWState", "constant", "get_schedule", "linear_decay"]
