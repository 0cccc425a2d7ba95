"""op_lint: rules over the op trace of one call -- the port's counterpart
of both ``repro/analysis/hlo_lint.py`` and ``repro/analysis/jaxpr_lint.py``.

A PyTorch program has no HLO to walk: what it runs is the sequence of
aten ops its Python issues. ``trace_ops(fn)`` runs ``fn`` once under an
``OpTraceMode`` (a ``TorchDispatchMode``) and records every op it
dispatches -- its name, output shapes and dtypes, and the bytes it reads
and writes -- plus every host read of tensor values (``.item()``,
``bool()``, ``torch.equal``, a device-to-host copy, and ``.tolist()`` /
``.numpy()``, which dispatch no op and are wrapped while a trace runs),
the counted collectives of ``core/collective.py`` and the launches of
every hand-written kernel wrapper. FLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` around the same run. Rules:

  op-materialization    NO op output at forbidden scale: >=
                        meta['forbid_elems'] elements, or trailing dims
                        equal to meta['forbid_dims'] in either order -- the
                        "dW never materialized" guarantee of the factored
                        and kernel backends
  op-collective-budget  counted all-reduces and their bytes within
                        meta['max_collective_count'] /
                        meta['max_collective_bytes'] (the sharded engine's
                        one all-reduce per reduced tensor of a bucket)
  op-host-transfer      no host read of tensor values inside a traced
                        round program (each one syncs the host with the
                        card)
  op-dtype-upcast       no f64 op output (meta['allow_f64'] waives it, with
                        meta['f64_reason']); with meta['bf16_min_elems']
                        set, no f32 output of that many elements in a
                        program meant to run bf16

All thresholds arrive via ``ProgramContext.meta`` (rules without their
threshold yield nothing). The records are the same on the CPU and on the
card, apart from the kernel backend: on the CPU its wrappers run their
plain versions (aten ops, traced), on the card their CUDA kernels
(launches, counted; ctypes calls dispatch no op).

``ProgramPoint`` / ``program_fn`` build the engine x method x backend
aggregation programs the lint and the complexity certifier trace (the
counterpart of ``repro/analysis/lowering.py``), with inputs drawn from a
seeded generator.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.rules import Finding, ProgramContext, RuleSet

# ops that read a tensor's values on the host, whatever its device
_HOST_READ_OPS = {"aten._local_scalar_dense": "item",
                  "aten.is_nonzero": "is_nonzero",
                  "aten.equal": "equal"}
_COPY_OPS = ("aten._to_copy", "aten.copy_")
_WRAPPED_READS = ("tolist", "numpy")


def _op_name(func) -> str:
    """``aten.mm`` for the overload ``aten.mm.default``."""
    return str(func.overloadpacket)


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass(frozen=True)
class OpRecord:
    """One dispatched op of a traced call."""
    name: str
    out_shapes: Tuple[Tuple[int, ...], ...]
    out_dtypes: Tuple[str, ...]
    in_bytes: int
    out_bytes: int


@dataclass
class OpTrace:
    """Payload of the op rules: everything one traced call ran."""
    ops: List[OpRecord] = field(default_factory=list)
    host_reads: List[str] = field(default_factory=list)
    flops: int = 0
    collective_count: int = 0
    collective_bytes: int = 0
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def hbm_bytes(self) -> int:
        """Bytes every op reads and writes (each input read once, each
        output written once, views included): the walker's HBM model."""
        return sum(r.in_bytes + r.out_bytes for r in self.ops)

    def stats(self) -> dict:
        return {"ops": len(self.ops),
                "distinct_ops": len({r.name for r in self.ops}),
                "flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_count": self.collective_count,
                "collective_bytes": self.collective_bytes,
                "host_reads": dict(sorted(Counter(self.host_reads).items())),
                "launches": dict(sorted(self.launches.items()))}


# -- host reads that dispatch no op (.tolist(), .numpy()) --------------------

_READERS: List["_Recorder"] = []
_SAVED: Dict[str, object] = {}


def _patch_reads() -> None:
    for name in _WRAPPED_READS:
        orig = getattr(torch.Tensor, name)
        _SAVED[name] = (orig, name in torch.Tensor.__dict__)

        def wrapped(self, *a, __orig=orig, __name=name, **k):
            for rec in _READERS:
                rec._value_read(__name, self)
            return __orig(self, *a, **k)

        setattr(torch.Tensor, name, wrapped)


def _unpatch_reads() -> None:
    for name, (orig, own) in _SAVED.items():
        if own:
            setattr(torch.Tensor, name, orig)
        else:
            delattr(torch.Tensor, name)
    _SAVED.clear()


class _Recorder(TorchDispatchMode):
    """Base mode: classifies host reads; subclasses record the ops. A
    device-to-host copy counts once: ``.numpy()`` / ``.tolist()`` of its
    result is not counted again."""

    def __init__(self):
        super().__init__()
        # id -> weakref of each device-to-host copy's result (a WeakSet
        # would compare tensors with ``==``)
        self._copied: Dict[int, weakref.ref] = {}

    def __enter__(self):
        if not _READERS:
            _patch_reads()
        _READERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _READERS.remove(self)
            if not _READERS:
                _unpatch_reads()

    def _value_read(self, kind: str, t: torch.Tensor) -> None:
        ref = self._copied.get(id(t))
        if ref is None or ref() is not t:
            self.host_read(kind)

    def host_read(self, kind: str) -> None:
        raise NotImplementedError

    def op(self, name: str, args, out) -> None:
        raise NotImplementedError

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = _op_name(func)
        if name in _HOST_READ_OPS:
            self.host_read(_HOST_READ_OPS[name])
        elif name in _COPY_OPS:
            ins = _tensors(args[1:] if name == "aten.copy_" else args)
            outs = _tensors(out)
            if (any(t.device.type != "cpu" for t in ins)
                    and any(t.device.type == "cpu" for t in outs)):
                self.host_read("d2h_copy")
                for t in outs:
                    self._copied[id(t)] = weakref.ref(t)
        self.op(name, (args, kwargs), out)
        return out


class OpTraceMode(_Recorder):
    """Records every dispatched op of the calls run under it."""

    def __init__(self, trace: OpTrace):
        super().__init__()
        self.trace = trace

    def host_read(self, kind: str) -> None:
        self.trace.host_reads.append(kind)

    def op(self, name: str, args, out) -> None:
        outs = _tensors(out)
        self.trace.ops.append(OpRecord(
            name=name,
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_dtypes=tuple(str(t.dtype).replace("torch.", "")
                             for t in outs),
            in_bytes=sum(_nbytes(t) for t in _tensors(args)),
            out_bytes=sum(_nbytes(t) for t in outs)))


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import ops
    return {k.__name__: k.launches for k in ops.KERNELS}


def _collective_counts() -> Tuple[int, int]:
    from repro_torch.core import collective
    return collective.all_reduce.calls, collective.all_reduce.bytes


def trace_ops(fn: Callable, *args, **kwargs) -> Tuple[OpTrace, object]:
    """Run ``fn(*args, **kwargs)`` once under an op trace and a FLOP
    counter; return (trace, fn's result)."""
    from torch.utils.flop_counter import FlopCounterMode
    trace = OpTrace()
    launches0, (calls0, bytes0) = _launch_counts(), _collective_counts()
    flops = FlopCounterMode(display=False)
    with flops, OpTraceMode(trace):
        out = fn(*args, **kwargs)
    trace.flops = int(flops.get_total_flops())
    calls1, bytes1 = _collective_counts()
    trace.collective_count = calls1 - calls0
    trace.collective_bytes = bytes1 - bytes0
    trace.launches = {k: n - launches0.get(k, 0)
                      for k, n in _launch_counts().items()
                      if n != launches0.get(k, 0)}
    return trace, out


# -- rules -------------------------------------------------------------------

def _elems(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def iter_outputs(trace: OpTrace):
    """(op index/name, dtype, shape) for every output of every op."""
    for i, rec in enumerate(trace.ops):
        for shape, dt in zip(rec.out_shapes, rec.out_dtypes):
            yield f"{i}:{rec.name}", dt, shape


OP_RULES = RuleSet("op")


@OP_RULES.rule(
    "op-materialization",
    "no op output reaches the forbidden (d, n) scale: >= "
    "meta['forbid_elems'] elements, or trailing dims equal to "
    "meta['forbid_dims'] in either order (the dense-dW tripwire)")
def _check_materialization(ctx: ProgramContext):
    forbid_elems = ctx.meta.get("forbid_elems")
    forbid_dims = ctx.meta.get("forbid_dims")
    if forbid_elems is None and forbid_dims is None:
        return
    dim_set = set(forbid_dims) if forbid_dims else None
    for where, dt, shape in iter_outputs(ctx.payload):
        n = _elems(shape)
        if forbid_elems is not None and n >= forbid_elems:
            yield (f"{dt}{list(shape)} holds {n} >= {forbid_elems} "
                   f"elements", where)
        elif dim_set and len(shape) >= 2 and set(shape[-2:]) == dim_set:
            yield (f"{dt}{list(shape)} has forbidden trailing dims "
                   f"{tuple(sorted(dim_set))}", where)


@OP_RULES.rule(
    "op-collective-budget",
    "counted all-reduces <= meta['max_collective_count'] and their bytes "
    "<= meta['max_collective_bytes'] (per rank; the sharded bucket's one "
    "all-reduce per reduced tensor)")
def _check_collective_budget(ctx: ProgramContext):
    trace: OpTrace = ctx.payload
    max_count = ctx.meta.get("max_collective_count")
    max_bytes = ctx.meta.get("max_collective_bytes")
    if max_count is not None and trace.collective_count > max_count:
        yield (f"{trace.collective_count} all-reduces > budget "
               f"{max_count}", "")
    if max_bytes is not None and trace.collective_bytes > max_bytes:
        yield (f"{trace.collective_bytes} all-reduce bytes > budget "
               f"{max_bytes}", "")


@OP_RULES.rule(
    "op-host-transfer",
    "no host read of tensor values (.item(), bool(), torch.equal, a "
    "device-to-host copy, .tolist(), .numpy()) inside a traced round "
    "program: each one stalls the host on the card")
def _check_host_transfer(ctx: ProgramContext):
    for kind, n in sorted(Counter(ctx.payload.host_reads).items()):
        yield f"{n} host read(s) of kind '{kind}'", kind


@OP_RULES.rule(
    "op-dtype-upcast",
    "no f64 op output (meta['allow_f64'] to waive, with "
    "meta['f64_reason']); with meta['bf16_min_elems'] set, no f32 output "
    "of that many elements in a program meant to run bf16")
def _check_dtype_upcast(ctx: ProgramContext):
    allow_f64 = ctx.meta.get("allow_f64", False)
    bf16_min = ctx.meta.get("bf16_min_elems")
    for where, dt, shape in iter_outputs(ctx.payload):
        if dt == "float64" and not allow_f64:
            yield f"float64{list(shape)} in a float32 program", where
        elif (dt == "float32" and bf16_min is not None
              and _elems(shape) >= bf16_min):
            yield (f"float32{list(shape)} upcast in a bf16 program "
                   f"(>= {bf16_min} elements)", where)


def lint_ops(trace: OpTrace, program: str, meta: Optional[dict] = None,
             only: Optional[Iterable[str]] = None) -> List[Finding]:
    ctx = ProgramContext(program=program, kind="op", payload=trace,
                         meta=dict(meta or {}))
    return OP_RULES.run(ctx, only=only)


# -- the aggregation program matrix ------------------------------------------

AVG_METHODS = ("fedavg", "hetlora", "ffa", "flora")
SVD_METHODS = ("flexlora", "raflora")
BACKENDS = ("dense", "factored", "kernel")
ENGINES = ("sequential", "batched", "async", "event", "sharded")


@dataclass(frozen=True)
class ProgramPoint:
    """One fully parameterized aggregation program of the matrix (the
    reference's ``lowering.ProgramPoint``)."""

    engine: str
    method: str
    backend: str
    d: int = 160
    n: int = 192
    rank_levels: Tuple[int, ...] = (4, 8)
    m_per_group: int = 2            # clients per rank group
    p_bucket: int = 2               # adapters per bucket (grouped rows)
    depth: int = 1                  # pipeline depth (async rows use 2)

    @property
    def r_max(self) -> int:
        return max(self.rank_levels)

    def scaled(self, **kw) -> "ProgramPoint":
        return replace(self, **kw)


def _weights(pt: ProgramPoint, m: int, gen: torch.Generator,
             device) -> torch.Tensor:
    """Client weights (M,) for the averaging family, omega (M, r_max) for
    the SVD family, each summing to one over the clients."""
    shape = (m,) if pt.method in AVG_METHODS else (m, pt.r_max)
    w = torch.rand(shape, generator=gen) + 0.1
    return (w / w.sum(dim=0)).to(device)


def program_fn(pt: ProgramPoint, device="cpu", mesh=None,
               seed: int = 0) -> Callable[[], tuple]:
    """A zero-argument call of the engine's per-bucket aggregation program
    at ``pt``, on inputs drawn from a seeded generator (made before the
    call, so a trace sees the program alone). The sequential engine runs
    ``_dispatch_stacked`` on one adapter's (M, d, r_max) stack; the
    batched, async and event engines run ``_grouped_core`` on per-rank
    group tuples of ``p_bucket`` adapters (async at ``depth`` x M clients;
    the event fire path dispatches the same program, its present mask
    being weight data); the sharded engine runs ``sharded_grouped_fn`` on
    ``mesh`` (one block per rank)."""
    from repro_torch.core import aggregation as agg
    gen = torch.Generator().manual_seed(seed)

    def f32(*shape):
        return torch.randn(shape, generator=gen).to(device)

    fallback = (torch.tensor([0.0] * (pt.r_max - 1) + [1.0]).to(device)
                if pt.method == "raflora" else None)
    if pt.engine == "sequential":
        m = pt.m_per_group * len(pt.rank_levels)
        bs, as_ = f32(m, pt.d, pt.r_max), f32(m, pt.r_max, pt.n)
        gb, ga = f32(pt.d, pt.r_max), f32(pt.r_max, pt.n)
        warg = _weights(pt, m, gen, device)
        return lambda: agg._dispatch_stacked(
            bs, as_, warg, gb, ga, fallback, pt.r_max, pt.backend,
            pt.method)
    shards = 1 if mesh is None else mesh.size(0)
    g = (pt.m_per_group * pt.depth if pt.engine != "sharded"
         else pt.m_per_group * shards)
    local = g if pt.engine != "sharded" else g // shards
    group_bs = tuple(tuple(f32(local, pt.d, r) for _ in range(pt.p_bucket))
                     for r in pt.rank_levels)
    group_as = tuple(tuple(f32(local, r, pt.n) for _ in range(pt.p_bucket))
                     for r in pt.rank_levels)
    gbs = tuple(f32(pt.d, pt.r_max) for _ in range(pt.p_bucket))
    gas = tuple(f32(pt.r_max, pt.n) for _ in range(pt.p_bucket))
    w = _weights(pt, g * len(pt.rank_levels), gen, device)
    if pt.engine == "sharded":
        from repro_torch.core import collective
        blk = collective.block(g, mesh)
        group_w = [w[i * g:(i + 1) * g][blk]
                   for i in range(len(pt.rank_levels))]
        fn = agg.sharded_grouped_fn(mesh, pt.r_max, pt.backend, pt.method)
        return lambda: fn(group_bs, group_as, group_w, gbs, gas, fallback)
    return lambda: agg._grouped_core(
        group_bs, group_as, w, gbs, gas, fallback, r_max=pt.r_max,
        backend=pt.backend, method=pt.method)


@contextlib.contextmanager
def one_rank_mesh(device="cpu"):
    """A one-rank ``("data",)`` mesh in this process for the sharded rows
    (``launch.mesh.make_fl_mesh``), its group destroyed after; an
    existing group is used as it is."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_fl_mesh
    own = not dist.is_initialized()
    try:
        yield make_fl_mesh(device=device)
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
