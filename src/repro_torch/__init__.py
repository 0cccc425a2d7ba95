"""PyTorch / CUDA port of the raFLoRA reproduction.

A second package beside the JAX reference ``repro``, with the same module
layout. It imports ``torch`` and nothing of JAX or of ``repro``. Entry
points (``Model``, ``FederatedLoRA``, ``build_experiment``) run on the GPU
unless given ``device="cpu"``; on the card the kernel backend's
aggregation and the serving engine's adapted projections
(``Model(use_kernels=True)``) run the hand-written kernels in
``repro_torch/kernels``.
"""
