"""Audit report assembly and the ``AUDIT_*.json`` schema (a copy of
``repro/analysis/report.py``; the port's tools write their reports under
``build/audit_torch/``).

Artifact schema (``schema`` bumps on breaking change)::

    {
      "schema": 1,
      "matrix": {...sweep parameters...},
      "summary": {"programs": N, "errors": E, "warnings": W,
                  "controls": C, "controls_failed": [names], "ok": bool},
      "controls": {name: {"tripped": bool, "rule": id, "detail": str}},
      "programs": [
        {"program": name, "kind": "op|cuda|dispatch|...",
         "status": "ok|fail",
         "stats": {...pass-specific numbers...},
         "findings": [{"rule", "severity", "message", "location"}]}
      ]
    }

Programs are sorted by name and the writer is deterministic (no
timestamps), so two reports diff cleanly.

*Positive controls* are deliberately-broken programs each rule must flag:
a control that does NOT trip marks the whole report failed -- a lint gate
whose tripwires are dead is worse than none.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.analysis.rules import Finding, SEV_ERROR

SCHEMA_VERSION = 1


@dataclass
class ProgramAudit:
    """Lint outcome for one program of the sweep matrix."""
    program: str
    kind: str
    findings: List[Finding] = field(default_factory=list)
    stats: Dict = field(default_factory=dict)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_ERROR]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_json(self) -> dict:
        return {
            "program": self.program,
            "kind": self.kind,
            "status": "ok" if self.ok else "fail",
            "stats": self.stats,
            "findings": [f.to_json() for f in self.findings],
        }


@dataclass
class Control:
    """A positive control: ``rule`` must have tripped on the broken
    program for the report to pass. A control whose pass RAISED is
    recorded with ``error`` set and counts as failed the same as one
    that silently did not trip (a tripwire that crashes is just as dead
    as one that never fires)."""
    name: str
    rule: str
    tripped: bool
    detail: str = ""
    error: str = ""

    def to_json(self) -> dict:
        out = {"tripped": self.tripped, "rule": self.rule,
               "detail": self.detail}
        if self.error:
            out["error"] = self.error
        return out


class AuditReport:
    def __init__(self, matrix: Optional[dict] = None):
        self.matrix = matrix or {}
        self.programs: List[ProgramAudit] = []
        self.controls: Dict[str, Control] = {}

    def add(self, audit: ProgramAudit) -> ProgramAudit:
        self.programs.append(audit)
        return audit

    def add_control(self, name: str, rule: str, findings: List[Finding],
                    detail: str = "") -> Control:
        """Record a positive control: pass iff ``rule`` appears in the
        findings produced on the deliberately-broken program."""
        tripped = any(f.rule == rule for f in findings)
        ctl = Control(name, rule, tripped,
                      detail or "; ".join(f.message for f in findings[:2]))
        self.controls[name] = ctl
        return ctl

    def add_control_error(self, name: str, rule: str,
                          exc: BaseException) -> Control:
        """Record a control whose pass raised: never tripped, and the
        exception is preserved in the artifact for diagnosis."""
        ctl = Control(name, rule, tripped=False,
                      detail=f"control pass raised {type(exc).__name__}",
                      error=repr(exc))
        self.controls[name] = ctl
        return ctl

    def run_control(self, name: str, rule: str, fn,
                    detail: str = "") -> Control:
        """Run the control pass ``fn() -> findings`` and record it;
        an exception inside the pass fails the control (and thus the
        report) instead of aborting the whole sweep."""
        try:
            findings = fn()
        except Exception as exc:     # noqa: BLE001 -- any crash = dead
            return self.add_control_error(name, rule, exc)
        return self.add_control(name, rule, findings, detail)

    @property
    def failed_programs(self) -> List[ProgramAudit]:
        return [p for p in self.programs if not p.ok]

    @property
    def failed_controls(self) -> List[str]:
        return sorted(n for n, c in self.controls.items() if not c.tripped)

    @property
    def ok(self) -> bool:
        return not self.failed_programs and not self.failed_controls

    def summary(self) -> dict:
        return {
            "programs": len(self.programs),
            "errors": sum(len(p.errors) for p in self.programs),
            "warnings": sum(len(p.findings) - len(p.errors)
                            for p in self.programs),
            "controls": len(self.controls),
            "controls_failed": self.failed_controls,
            "ok": self.ok,
        }

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "matrix": self.matrix,
            "summary": self.summary(),
            "controls": {n: self.controls[n].to_json()
                         for n in sorted(self.controls)},
            "programs": [p.to_json() for p in
                         sorted(self.programs, key=lambda p: p.program)],
        }

    def write(self, path: str) -> None:
        """Atomic write (tmp + rename) so a crashed sweep never leaves a
        truncated report; creates the report's directory."""
        payload = json.dumps(self.to_json(), indent=1, sort_keys=False)
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload + "\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
