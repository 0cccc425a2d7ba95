"""The port's launchers (``python -m repro_torch.launch.train``). The
reference's TPU mesh builders, dry runs and serve launcher have no
counterpart here yet (ROADMAP.md queue 1 items 11 and 13)."""
