"""The reference's examples on the port (``python -m
repro_torch.examples.quickstart [--device cpu]``, ``federated_finetune``,
``rank_collapse_demo``, ``serve_finetuned``)."""
