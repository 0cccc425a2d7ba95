"""Aggregation math of the port. Submodules are imported by name
(``repro_torch.core.aggregation``), so the numpy-only ones load without
torch-heavy dependencies."""
