"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. Builds happen at first use (never at import: the CPU test
machines have no ``nvcc``), all sources at once in parallel, into
``build/kernels/`` at the repository root, a directory git ignores. A
library's file name carries a hash of its source and of the shared
headers (``csrc/*.cuh``), so an edited kernel is always rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signature of every exported kernel entry: (pointers..., ints..., stream)
SIGNATURES = {
    "weighted_stack": {
        "weighted_stack_b_f32": [_P] * 3 + [_I] * 5 + [_P],
        "weighted_stack_a_f32": [_P] * 3 + [_I] * 5 + [_P],
    },
    "gram": {
        "gram_left_f32": [_P] * 4 + [_I] * 5 + [_P],
        "gram_right_f32": [_P] * 4 + [_I] * 5 + [_P],
    },
    "lora_apply": {
        "batched_lora_apply_f32": [_P] * 9 + [_I] * 5 + [_L, _L]
        + [_I] * 4 + [_P],
        "lora_apply_f32": [_P] * 7 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
    },
    "rank_partition_agg": {
        "rank_partition_agg_f32": [_P] * 6 + [_I] * 7 + [_P],
    },
    "flash_attention": {
        "flash_attention_f32": [_P] * 4 + [_I] * 8 + [_F] + [_I] * 2
        + [_P],
    },
    "ssd_scan": {
        "ssd_scan_f32": [_P] * 10 + [_L] + [_I] * 8 + [_P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
build_seconds = 0.0       # wall time of the last build_all() that compiled
ptxas_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return str(path)


def _lib_path(stem: str) -> Path:
    """The library's path, named by a hash of its source and of every
    header in ``csrc/`` (a source may include any of them)."""
    digest = hashlib.sha1((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel (one nvcc per source),
    then load them all. Raises with nvcc's output if a build fails."""
    global build_seconds
    todo = {stem: _lib_path(stem) for stem in SIGNATURES
            if stem not in _LIBS}
    missing = {s: p for s, p in todo.items() if not p.exists()}
    if missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for stem, out in missing.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for stem, (tmp, out, proc) in procs.items():
            log, _ = proc.communicate()
            ptxas_log[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for stem, path in todo.items():
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[stem].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[stem] = lib
    return _LIBS


def library(stem: str) -> ctypes.CDLL:
    if stem not in _LIBS:
        build_all()
    return _LIBS[stem]


def check(rc: int, fn: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {fn} failed: cudaError {rc}")
