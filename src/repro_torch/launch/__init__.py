"""The port's launchers (``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``), the train, prefill and serve
step functions (``launch/steps.py``) and the process meshes
(``launch/mesh.py``). The reference's TPU dry runs read TPU dry-run
artifacts; no counterpart on one card, ROADMAP.md."""
