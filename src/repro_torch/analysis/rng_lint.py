"""RNG/determinism lint for the port's round and serving paths (the host
half of ``repro/analysis/rng_lint.py``, plus a rule of its own;
DESIGN.md §10).

Host determinism (kind "rng-host") -- AST rules over round-path and
serving-path source files:

* unseeded ``np.random.default_rng()`` (an irreproducible stream);
* host-clock reads (``time.time()`` & friends) on the virtual-clock
  round path;
* two call sites constructing ``np.random.SeedSequence`` entropy with the
  same shape (per-client stream collision);
* one ``PRNGKey`` variable feeding two consuming calls;
* aggregation inputs iterated from a set (hash-order-sensitive client
  iteration);
* ``rng-torch-global-generator``: a torch sampling call without an
  explicit ``generator=`` (``torch.rand*``, ``randn*``, ``randint*``,
  ``randperm``, ``normal``, ``bernoulli``, ``multinomial``, the
  ``*_like`` forms, the in-place ``.normal_`` / ``.uniform_`` /
  ``.bernoulli_`` / ``.random_`` / ``.exponential_``), or any call of
  ``torch.manual_seed`` / ``torch.cuda.manual_seed*``. The port draws
  every random tensor from a ``torch.Generator`` it was handed; a draw
  from the process-global generator makes a run depend on whatever else
  drew before it. This rule stands in for the reference's jaxpr
  key-provenance pass, which has no torch form.

Intentional uses carry a same-line waiver comment:
``# host-clock: ok (<why>)`` / ``# rng: ok (<why>)``.
``python -m repro_torch.tools.verify_protocol`` sweeps the rules (with
positive controls) into ``build/audit_torch/AUDIT_protocol.json``.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.rules import Finding, ProgramContext, RuleSet

# ---------------------------------------------------------------------------
# host determinism rules (AST over round-path source)
# ---------------------------------------------------------------------------

_CLOCK_CALLS = {("time", "time"), ("time", "monotonic"),
                ("time", "perf_counter"), ("datetime", "now"),
                ("datetime", "utcnow")}


@dataclass
class HostSource:
    """Payload of the rng-host pass: one parsed round-path source file."""
    name: str
    tree: ast.AST
    lines: List[str]

    def waived(self, lineno: int, tag: str) -> bool:
        line = self.lines[lineno - 1] if lineno - 1 < len(self.lines) else ""
        return f"# {tag}: ok" in line


def parse_host_source(name: str, source: str) -> HostSource:
    return HostSource(name=name, tree=ast.parse(source),
                      lines=source.splitlines())


def _dotted(node: ast.AST) -> Tuple[str, ...]:
    """('np', 'random', 'default_rng')-style path of a call target."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


RNG_HOST_RULES = RuleSet("rng-host")


@RNG_HOST_RULES.rule(
    "rng-unseeded-default-rng",
    "np.random.default_rng() with no seed: the stream is irreproducible "
    "-- derive it from a seeded SeedSequence (waiver: '# rng: ok')")
def _check_unseeded(ctx: ProgramContext):
    src: HostSource = ctx.payload
    for node in ast.walk(src.tree):
        if (isinstance(node, ast.Call) and not node.args and not node.keywords
                and _dotted(node.func)[-2:] == ("random", "default_rng")
                and not src.waived(node.lineno, "rng")):
            yield ("unseeded np.random.default_rng()",
                   f"{src.name}:{node.lineno}")


@RNG_HOST_RULES.rule(
    "rng-host-clock",
    "host-clock read on the virtual-clock round path: times must come "
    "from the event scheduler's clock (waiver: '# host-clock: ok')")
def _check_host_clock(ctx: ProgramContext):
    src: HostSource = ctx.payload
    for node in ast.walk(src.tree):
        if (isinstance(node, ast.Call)
                and _dotted(node.func)[-2:] in _CLOCK_CALLS
                and not src.waived(node.lineno, "host-clock")):
            yield (f"host clock read {'.'.join(_dotted(node.func))}()",
                   f"{src.name}:{node.lineno}")


@RNG_HOST_RULES.rule(
    "rng-seed-collision",
    "two call sites build np.random.SeedSequence entropy of the same "
    "shape: per-client streams from the two sites collide draw-for-draw "
    "-- disambiguate with a distinct literal tag (waiver: '# rng: ok')")
def _check_seed_collision(ctx: ProgramContext):
    src: HostSource = ctx.payload
    sites: Dict[Tuple, List[int]] = {}
    for node in ast.walk(src.tree):
        if not (isinstance(node, ast.Call)
                and _dotted(node.func)[-1:] == ("SeedSequence",)
                and node.args):
            continue
        ent = node.args[0]
        if not isinstance(ent, (ast.List, ast.Tuple)):
            continue
        sig = tuple(("const", e.value) if isinstance(e, ast.Constant)
                    else ("expr",) for e in ent.elts)
        if not src.waived(node.lineno, "rng"):
            sites.setdefault(sig, []).append(node.lineno)
    for sig, linenos in sorted(sites.items()):
        if len(linenos) > 1:
            yield (f"SeedSequence entropy shape {sig} built at lines "
                   f"{linenos}: same-client streams collide",
                   f"{src.name}:{linenos[1]}")


# call targets that take a key WITHOUT consuming its entropy
_KEY_NONCONSUMING = {"split", "fold_in", "PRNGKey", "key_data",
                     "wrap_key_data", "clone"}


@RNG_HOST_RULES.rule(
    "rng-host-key-reuse",
    "one PRNGKey variable feeds two or more consuming calls in the same "
    "function: the draws share a stream and correlate (the init-then-"
    "sample serving bug) -- jax.random.split first (waiver: '# rng: ok')")
def _check_host_key_reuse(ctx: ProgramContext):
    src: HostSource = ctx.payload
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        key_names = set()
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and _dotted(node.value.func)[-1:] == ("PRNGKey",)):
                key_names.update(t.id for t in node.targets
                                 if isinstance(t, ast.Name))
        if not key_names:
            continue
        uses: Dict[str, List[int]] = {}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _dotted(node.func)[-1:] and \
                    _dotted(node.func)[-1] in _KEY_NONCONSUMING:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id in key_names:
                    uses.setdefault(arg.id, []).append(node.lineno)
        for name, linenos in sorted(uses.items()):
            live = [ln for ln in sorted(linenos)
                    if not src.waived(ln, "rng")]
            if len(live) >= 2:
                yield (f"PRNGKey variable '{name}' consumed at lines "
                       f"{live}: the draws share one stream",
                       f"{src.name}:{live[1]}")


@RNG_HOST_RULES.rule(
    "rng-order-sensitive-iteration",
    "iteration directly over a set feeds hash-membership-history order "
    "into round-path state -- iterate sorted(...) (waiver: '# rng: ok')")
def _check_set_iteration(ctx: ProgramContext):
    src: HostSource = ctx.payload

    def is_set_expr(e):
        return (isinstance(e, (ast.Set, ast.SetComp))
                or (isinstance(e, ast.Call)
                    and _dotted(e.func)[-1:] == ("set",))
                or (isinstance(e, ast.BinOp)
                    and isinstance(e.op, (ast.BitAnd, ast.BitOr, ast.Sub))
                    and (is_set_expr(e.left) or is_set_expr(e.right))))

    def hit(iter_expr, lineno):
        if is_set_expr(iter_expr) and not src.waived(lineno, "rng"):
            yield (f"iterating a set directly", f"{src.name}:{lineno}")

    for node in ast.walk(src.tree):
        if isinstance(node, ast.For):
            yield from hit(node.iter, node.lineno)
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                               ast.DictComp, ast.SetComp)):
            for gen in node.generators:
                yield from hit(gen.iter, node.lineno)


# torch samplers that draw from the global generator unless handed one
_TORCH_SAMPLERS = {"rand", "rand_like", "randn", "randn_like", "randint",
                   "randint_like", "randperm", "normal", "bernoulli",
                   "multinomial"}
_TORCH_INPLACE_SAMPLERS = {"normal_", "uniform_", "bernoulli_", "random_",
                           "exponential_"}
_TORCH_SEEDERS = {("torch", "manual_seed"), ("torch", "cuda", "manual_seed"),
                  ("torch", "cuda", "manual_seed_all")}


@RNG_HOST_RULES.rule(
    "rng-torch-global-generator",
    "a torch sampling call without generator= (or a torch.manual_seed / "
    "torch.cuda.manual_seed* call) draws from or reseeds the process-"
    "global generator: pass an explicit torch.Generator (waiver: "
    "'# rng: ok')")
def _check_torch_global_generator(ctx: ProgramContext):
    src: HostSource = ctx.payload
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        path = _dotted(node.func)
        if not path or src.waived(node.lineno, "rng"):
            continue
        if path in _TORCH_SEEDERS:
            yield (f"{'.'.join(path)}() reseeds the global generator",
                   f"{src.name}:{node.lineno}")
            continue
        sampler = ((path[0] == "torch" and path[-1] in _TORCH_SAMPLERS)
                   or (isinstance(node.func, ast.Attribute)
                       and path[-1] in _TORCH_INPLACE_SAMPLERS))
        if sampler and not any(kw.arg == "generator"
                               for kw in node.keywords):
            yield (f"{'.'.join(path)}() without generator= draws from "
                   f"the global generator", f"{src.name}:{node.lineno}")


def lint_host_source(program: str, source: str,
                     meta: Optional[dict] = None
                     ) -> Tuple[List[Finding], dict]:
    src = parse_host_source(program, source)
    ctx = ProgramContext(program=program, kind="rng-host", payload=src,
                         meta=meta or {})
    n_nodes = sum(1 for _ in ast.walk(src.tree))
    return RNG_HOST_RULES.run(ctx), {"ast_nodes": n_nodes,
                                     "lines": len(src.lines)}


# ---------------------------------------------------------------------------
# deliberately-broken programs (positive controls for the sweep)
# ---------------------------------------------------------------------------

BROKEN_HOST_CLOCK = (
    "import time\n"
    "def round_stats():\n"
    "    t0 = time.time()\n"
    "    return {'wall': time.time() - t0}\n"
)

BROKEN_UNSEEDED = (
    "import numpy as np\n"
    "def jitter():\n"
    "    return np.random.default_rng().random()\n"
)

BROKEN_SEED_COLLISION = (
    "import numpy as np\n"
    "def latency_rng(seed, client):\n"
    "    return np.random.default_rng(np.random.SeedSequence([seed, client]))\n"
    "def batch_rng(seed, client):\n"
    "    return np.random.default_rng(np.random.SeedSequence([seed, client]))\n"
)

BROKEN_HOST_KEY_REUSE = (
    "import jax\n"
    "def setup(model, seed):\n"
    "    key = jax.random.PRNGKey(seed)\n"
    "    params = model.init(key)\n"
    "    prompts = jax.random.randint(key, (4, 32), 0, 100)\n"
    "    return params, prompts\n"
)

BROKEN_SET_ITERATION = (
    "import numpy as np\n"
    "def aggregate(updates, clients):\n"
    "    return np.mean([updates[c] for c in set(clients)], axis=0)\n"
)

BROKEN_TORCH_GLOBAL_RNG = (
    "import torch\n"
    "def jitter(x):\n"
    "    return x + torch.randn(3)\n"
)

BROKEN_TORCH_MANUAL_SEED = (
    "import torch\n"
    "def setup(model):\n"
    "    torch.manual_seed(0)\n"
    "    return model.init()\n"
)
