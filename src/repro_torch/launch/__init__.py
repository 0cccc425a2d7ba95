"""The port's launchers (``python -m repro_torch.launch.train``), the
train, prefill and serve step functions (``launch/steps.py``) and the
sharded round engine's process mesh (``launch/mesh.py``). The
reference's TPU dry runs and serve launcher have no counterpart here yet
(ROADMAP.md queue 1 items 11 and 13)."""
