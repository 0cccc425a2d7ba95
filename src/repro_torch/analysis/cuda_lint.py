"""cuda_lint: static resource lint of every hand-written CUDA kernel (the
port's counterpart of ``repro/analysis/pallas_lint.py``).

``kernels/build.py`` compiles each ``csrc/*.cu`` with ``-Xptxas -v`` and
keeps ptxas's report per library (``build.ptxas_log``). ``parse_ptxas``
turns a report into one ``EntryRecord`` per entry function: registers,
spill stores and loads, stack frame and static shared memory, under a
readable name (``lora_tc_kernel<true>``, demangled from the Itanium name
ptxas prints). Rules:

  cuda-spill-budget   each entry's spill stores and loads stay within its
                      row of ``SPILL_WAIVERS`` (zero for an entry not in
                      the table): a new spilling entry, or a larger spill,
                      trips. The table records what the sources spilled
                      when the lint was written; a kernel's redesign
                      shrinks its row, never the sources silencing the
                      lint
  cuda-static-smem    at most meta['max_static_smem'] (default 48 KiB, the
                      static limit of a block) of static shared memory
  cuda-report-coverage  every library of meta['libraries'] has a report
                      with at least one entry (a lint over a missing
                      report would pass on nothing)
  cuda-pad-coverage   each registry probe -- every public
                      ``kernels/ops.py`` wrapper at non-tile-divisible
                      extents (d 300, n 520 for the aggregation entries)
                      -- returned its contract shapes and dtypes with
                      finite values: on the CPU through the plain
                      versions, on the card through the kernels

``oversized_control`` fabricates a report that trips the first two rules
(the positive control).
"""
from __future__ import annotations

import functools
import os
import re
import subprocess
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.rules import Finding, ProgramContext, RuleSet

MAX_STATIC_SMEM = 48 * 1024

# (spill store bytes, spill load bytes) per entry, as ptxas reported them
# for sm_90a when this lint was written; every other entry spills nothing
SPILL_WAIVERS: Dict[str, Tuple[int, int]] = {
    "lora_tc_kernel<true>": (4, 4),
    "rank_partition_agg_kernel<false>": (16, 32),
    "rank_partition_agg_kernel<true>": (12, 20),
}


@dataclass
class EntryRecord:
    """ptxas's resource report of one entry function."""
    library: str
    name: str                       # demangled, without namespaces
    mangled: str
    registers: int = 0
    spill_stores: int = 0
    spill_loads: int = 0
    stack_frame: int = 0
    smem: int = 0

    def to_json(self) -> dict:
        return {"library": self.library, "name": self.name,
                "registers": self.registers,
                "spill_stores": self.spill_stores,
                "spill_loads": self.spill_loads,
                "stack_frame": self.stack_frame, "smem": self.smem}


@dataclass
class ProbeResult:
    """Outcome of one registry pad-coverage probe."""
    name: str
    ok: bool
    detail: str = ""


@dataclass
class CudaPrograms:
    """Payload of the cuda rules."""
    entries: List[EntryRecord] = field(default_factory=list)
    probes: List[ProbeResult] = field(default_factory=list)


# -- the ptxas report ---------------------------------------------------------

_BUILTIN = {"f": "float", "d": "double", "i": "int", "j": "unsigned",
            "b": "bool", "c": "char", "l": "long", "x": "long long"}


def _template_args(s: str, i: int) -> Tuple[List[str], int]:
    """Parse ``I ... E`` at ``s[i] == 'I'``: literal and builtin args."""
    args = []
    i += 1
    while i < len(s) and s[i] != "E":
        if s[i] == "L":
            j = s.index("E", i)
            kind, val = s[i + 1], s[i + 2:j]
            val = val.replace("n", "-", 1) if val.startswith("n") else val
            args.append({"0": "false", "1": "true"}[val] if kind == "b"
                        else val)
            i = j + 1
        else:
            args.append(_BUILTIN.get(s[i], "?"))
            i += 1
    return args, i + 1


def demangle(mangled: str) -> str:
    """Readable name of a kernel's Itanium-mangled name: the last nested
    name with its template arguments (``lora_tc_kernel<true>``); a name
    the parser does not know comes back as it is."""
    m = re.match(r"_ZN?(.*)", mangled)
    if not m or not mangled.startswith("_Z"):
        return mangled
    s, i, name, args = m.group(1), 0, None, []
    try:
        while i < len(s) and s[i].isdigit():
            j = i
            while s[j].isdigit():
                j += 1
            n = int(s[i:j])
            name, i, args = s[j:j + n], j + n, []
            if i < len(s) and s[i] == "I":
                args, i = _template_args(s, i)
            if not mangled.startswith("_ZN"):
                break
    except (ValueError, IndexError, KeyError):
        return mangled
    if name is None:
        return mangled
    return f"{name}<{', '.join(args)}>" if args else name


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(library: str, log: str) -> List[EntryRecord]:
    """One record per entry function of one library's ``ptxas -v``
    report. A ``Function properties`` line names whose frame line follows
    (a non-entry device function's is skipped); without one, the frame
    line belongs to the entry being compiled."""
    records: Dict[str, EntryRecord] = {}
    current: Optional[EntryRecord] = None
    target: Optional[str] = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            mangled = m.group(1)
            current = records.setdefault(mangled, EntryRecord(
                library, demangle(mangled), mangled))
            target = None
            continue
        m = _PROPS.search(line)
        if m:
            target = m.group(1)
            continue
        m = _FRAME.search(line)
        if m:
            rec = records.get(target) if target else current
            if rec is not None:
                rec.stack_frame, rec.spill_stores, rec.spill_loads = (
                    int(g) for g in m.groups())
            target = None
            continue
        m = _USED.search(line)
        if m and current is not None:
            current.registers = int(m.group(1))
            s = _SMEM.search(line)
            current.smem = int(s.group(1)) if s else 0
    return list(records.values())


def ptxas_reports() -> Dict[str, str]:
    """ptxas's report of every library: those this process compiled from
    ``build.ptxas_log``, the others compiled again, with the same flags,
    into a temporary directory for their report alone (a library already
    on disk is loaded without a build, and so without a report)."""
    from repro_torch.kernels import build
    logs = dict(build.ptxas_log)
    missing = [s for s in build.SIGNATURES if s not in logs]
    if not missing:
        return logs
    nvcc = build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {s: subprocess.Popen(
            [nvcc, *build.nvcc_flags(s), "-o", os.path.join(tmp, f"{s}.so"),
             str(build.CSRC / f"{s}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for s in missing}
        for stem, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {stem}.cu:\n{log}")
            logs[stem] = log
    return logs


def collect_build(logs: Optional[Dict[str, str]] = None
                  ) -> List[EntryRecord]:
    """Records of every library's report (``build.ptxas_log`` by
    default: the libraries this process compiled)."""
    if logs is None:
        from repro_torch.kernels import build
        logs = build.ptxas_log
    out: List[EntryRecord] = []
    for lib in sorted(logs):
        out.extend(parse_ptxas(lib, logs[lib]))
    return out


# -- the registry: every ops wrapper at non-divisible extents -----------------

def _entries(device, gen):
    import torch
    from repro_torch.kernels import ops

    def f32(*shape):
        return torch.randn(shape, generator=gen).to(device)

    def unif(*shape):
        return torch.rand(shape, generator=gen).to(device)

    m, d, r, n, lyr = 3, 300, 5, 520, 2
    width = (m + 1) * 8              # fallback rides as client m+1, r -> 8
    fb = torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0]).to(device)
    b_, l, h, p, g, ns = 2, 32, 8, 16, 2, 16
    yield ("lora_apply", functools.partial(ops.lora_apply, scale=2.0),
           (f32(4, 24, 40), f32(40, 56), f32(6, 40), f32(56, 6)),
           [(4, 24, 56)])
    yield ("batched_lora_apply", ops.batched_lora_apply,
           (f32(5, 40), f32(40, 56), f32(3, 6, 40), f32(3, 56, 6),
            unif(3), torch.tensor([0, 2, 1, 2, 0], dtype=torch.int32)
            .to(device)), [(5, 56)])
    agg = (f32(m, d, r), f32(m, r, n), unif(m, r), f32(d, r), f32(r, n),
           fb)
    agg_l = (f32(lyr, m, d, r), f32(lyr, m, r, n), unif(m, r),
             f32(lyr, d, r), f32(lyr, r, n), fb)
    yield "rank_partition_agg", ops.rank_partition_agg, agg, [(d, n)]
    yield ("rank_partition_agg_layered", ops.rank_partition_agg_layered,
           agg_l, [(lyr, d, n)])
    yield ("factored_stack_gram", ops.factored_stack_gram, agg,
           [(d, width), (width, n), (width, width), (width, width)])
    yield ("factored_stack_gram_layered", ops.factored_stack_gram_layered,
           agg_l, [(lyr, d, width), (lyr, width, n), (lyr, width, width),
                   (lyr, width, width)])
    yield ("ssd_scan", functools.partial(ops.ssd_scan, chunk=16),
           (f32(b_, l, h, p), unif(b_, l, h) * 0.1, f32(h), f32(b_, l, g, ns),
            f32(b_, l, g, ns), f32(h)), [(b_, l, h, p), (b_, h, p, ns)])
    yield ("flash_attention",
           functools.partial(ops.flash_attention, causal=False),
           (f32(1, 40, 2, 32), f32(1, 50, 2, 32), f32(1, 50, 2, 32)),
           [(1, 40, 2, 32)])


REGISTRY = ("lora_apply", "batched_lora_apply", "rank_partition_agg",
            "rank_partition_agg_layered", "factored_stack_gram",
            "factored_stack_gram_layered", "ssd_scan", "flash_attention")


def probe_registry(device="cpu", names: Optional[Sequence[str]] = None,
                   seed: int = 0) -> List[ProbeResult]:
    """Run every registry entry on ``device`` at its odd extents and check
    the contract shapes, f32 outputs and finite values."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    probes: List[ProbeResult] = []
    with torch.no_grad():
        for name, fn, args, expected in _entries(device, gen):
            if names is not None and name not in names:
                continue
            try:
                out = fn(*args)
            except Exception as e:                # noqa: BLE001
                probes.append(ProbeResult(name, False, f"raised {e!r}"))
                continue
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            got = [tuple(t.shape) for t in outs]
            want = [tuple(s) for s in expected]
            bad = [str(t.dtype) for t in outs if t.dtype != torch.float32]
            finite = all(bool(torch.isfinite(t).all()) for t in outs)
            ok = got == want and not bad and finite
            detail = "" if ok else (f"shapes {got} (want {want}), "
                                    f"non-f32 {bad}, finite {finite}")
            probes.append(ProbeResult(name, ok, detail))
    return probes


# -- rules -------------------------------------------------------------------

CUDA_RULES = RuleSet("cuda")


@CUDA_RULES.rule(
    "cuda-spill-budget",
    "each entry's ptxas spill stores / loads within its SPILL_WAIVERS row "
    "(zero for an entry not in it): a new spilling entry or a larger "
    "spill trips")
def _check_spills(ctx: ProgramContext):
    for rec in ctx.payload.entries:
        stores, loads = SPILL_WAIVERS.get(rec.name, (0, 0))
        if rec.spill_stores > stores or rec.spill_loads > loads:
            yield (f"{rec.name} spills {rec.spill_stores} B stores / "
                   f"{rec.spill_loads} B loads (waived {stores} / {loads})",
                   f"{rec.library}:{rec.name}")


@CUDA_RULES.rule(
    "cuda-static-smem",
    "static shared memory of each entry <= meta['max_static_smem'] "
    "(default 48 KiB, a block's static limit)")
def _check_smem(ctx: ProgramContext):
    limit = ctx.meta.get("max_static_smem", MAX_STATIC_SMEM)
    for rec in ctx.payload.entries:
        if rec.smem > limit:
            yield (f"{rec.name} uses {rec.smem} B static smem > {limit}",
                   f"{rec.library}:{rec.name}")


@CUDA_RULES.rule(
    "cuda-pad-coverage",
    "each registry probe at non-tile-divisible extents returned its "
    "contract shapes, f32 and finite values")
def _check_probes(ctx: ProgramContext):
    for p in ctx.payload.probes:
        if not p.ok:
            yield f"probe failed: {p.detail}", p.name


@CUDA_RULES.rule(
    "cuda-report-coverage",
    "every library named in meta['libraries'] has a ptxas report with at "
    "least one entry function")
def _check_coverage(ctx: ProgramContext):
    have = {rec.library for rec in ctx.payload.entries}
    for lib in sorted(set(ctx.meta.get("libraries", ())) - have):
        yield f"no ptxas entry recorded for library {lib}", lib


def lint_cuda(progs: CudaPrograms, program: str,
              meta: Optional[dict] = None) -> List[Finding]:
    ctx = ProgramContext(program=program, kind="cuda", payload=progs,
                         meta=dict(meta or {}))
    return CUDA_RULES.run(ctx)


def oversized_control() -> CudaPrograms:
    """A fabricated report that must trip the spill and smem rules: a new
    entry spilling 64 B, a waived entry spilling past its row, and 96 KiB
    of static shared memory."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN13_GLOBAL__N__x14oversized_tileILi256EEEvPKf' for 'sm_90a'",
        "    64 bytes stack frame, 64 bytes spill stores, "
        "64 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, "
        "98304 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN13_GLOBAL__N__x14lora_tc_kernelILb1EEEvPKf' for 'sm_90a'",
        "    16 bytes stack frame, 16 bytes spill stores, "
        "16 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers",
    ])
    return CudaPrograms(entries=parse_ptxas("control", log))
