"""The port's audit and verify layer (DESIGN.md §8-§10), rebuilt for
PyTorch. Every pass feeds one rule-engine core (``rules``, ``report``):

  op_lint         rules over the op trace of one call (what a
                  ``TorchDispatchMode`` records as it runs): (d, n)-scale
                  materialization, collective count/byte budgets, host
                  syncs inside a traced program, f64 upcasts
  dispatch_audit  per-round aten op multisets, host syncs and kernel
                  library builds/loads across a multi-round run; steady
                  rounds must run the same ops and build nothing
  cuda_lint       the ptxas resource report of every hand-written CUDA
                  kernel (registers, spills, static shared memory) plus
                  the pad-to-tile probes through ``kernels.ops``
  liveness        peak live bytes of one call (profiler memory events on
                  the CPU, the allocator's peak on the card)
  complexity      scaling-law contracts over cost vectors fitted along
                  size ladders (device costs from the op trace and
                  liveness, host costs from ``host_cost``)
  host_cost       loop and numpy-allocation counters on the round path
  protocol        exhaustive bounded-interleaving model checking of the
                  event round path against the REAL scheduler
  rng_lint        host-determinism AST rules over round-path and serving
                  sources, and the explicit-generator rule for torch
                  sampling calls

``python -m repro_torch.tools.<lint_programs|certify_scaling|
verify_protocol|bench_trend|ci>`` drive them and write
``build/audit_torch/AUDIT_<name>.json``.
"""
from repro_torch.analysis.rules import (Finding, ProgramContext, Rule,
                                        RuleSet, SEV_ERROR, SEV_WARNING)
from repro_torch.analysis.report import AuditReport, ProgramAudit

__all__ = [
    "Finding", "ProgramContext", "Rule", "RuleSet", "SEV_ERROR",
    "SEV_WARNING", "AuditReport", "ProgramAudit",
]
