"""Rule-engine core of the port's audit layer (a copy of
``repro/analysis/rules.py``; DESIGN.md §8).

A *rule* is a named, documented predicate over one analyzed program; a
*pass* (op_lint / dispatch_audit / cuda_lint / rng_lint / protocol /
complexity) is a ``RuleSet`` of rules sharing one payload type. Rules are
declarative: each one receives a ``ProgramContext`` -- the analyzed
program plus per-program ``meta`` thresholds -- and yields
``(message, location)`` pairs for every violation; the engine wraps them
into ``Finding`` records tagged with the rule id, severity and program
name. A rule that needs a threshold the caller did not provide in
``meta`` must yield nothing (rules are opt-in-by-configuration, so one
RuleSet serves every program in the engine x backend x METHODS matrix
without per-program rule lists).

Adding a rule::

    @MY_RULES.rule("pass-short-name", "one-line description")
    def _check_short_name(ctx):
        limit = ctx.meta.get("my_limit")
        if limit is None:
            return
        for thing in ctx.payload.things:
            if thing.size > limit:
                yield f"{thing.size} > {limit}", thing.name
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclass(frozen=True)
class Finding:
    """One rule violation in one program."""
    rule: str
    severity: str
    program: str
    message: str
    location: str = ""

    def to_json(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "location": self.location}

    def __str__(self) -> str:
        loc = f" @ {self.location}" if self.location else ""
        return f"[{self.severity}] {self.program}: {self.rule}{loc}: " \
               f"{self.message}"


@dataclass(frozen=True)
class Rule:
    id: str
    description: str
    check: Callable[["ProgramContext"], Optional[Iterable]]
    severity: str = SEV_ERROR


@dataclass
class ProgramContext:
    """One analyzed program handed to every rule of a RuleSet.

    ``payload`` is pass-specific (an op trace, ptxas records, dispatch
    counters, a parsed source file, a protocol run); ``meta`` carries the
    per-program thresholds that arm the opt-in rules.
    """
    program: str                      # e.g. "batched/raflora/kernel"
    kind: str                         # "op" | "cuda" | "dispatch" | ...
    payload: object
    meta: Dict = field(default_factory=dict)


class RuleSet:
    """An ordered, id-unique collection of rules for one program kind."""

    def __init__(self, kind: str):
        self.kind = kind
        self._rules: Dict[str, Rule] = {}

    def rule(self, rule_id: str, description: str,
             severity: str = SEV_ERROR):
        """Decorator registering ``fn(ctx) -> iterable of (msg, loc)|msg``."""
        def deco(fn):
            self.register(Rule(rule_id, description, fn, severity))
            return fn
        return deco

    def register(self, rule: Rule) -> None:
        if rule.id in self._rules:
            raise ValueError(f"duplicate rule id {rule.id!r}")
        self._rules[rule.id] = rule

    @property
    def rules(self) -> Tuple[Rule, ...]:
        return tuple(self._rules.values())

    def run(self, ctx: ProgramContext,
            only: Optional[Iterable[str]] = None) -> List[Finding]:
        """All findings of (optionally a subset of) this set's rules."""
        wanted = set(only) if only is not None else None
        findings: List[Finding] = []
        for rule in self._rules.values():
            if wanted is not None and rule.id not in wanted:
                continue
            for hit in rule.check(ctx) or ():
                if isinstance(hit, Finding):
                    findings.append(hit)
                    continue
                if isinstance(hit, str):
                    msg, loc = hit, ""
                else:
                    msg, loc = hit
                findings.append(Finding(rule.id, rule.severity, ctx.program,
                                        msg, loc))
        return findings

