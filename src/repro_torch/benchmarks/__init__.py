"""The paper's benchmarks on the port: one module per table or figure,
copies of ``benchmarks/`` with the same rows (``name,us_per_call,derived``
CSV). ``python -m repro_torch.benchmarks.run [--quick] [--device cpu]``."""
