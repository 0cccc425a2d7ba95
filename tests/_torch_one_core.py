"""One core for a port test module under the tier-1 run's xdist workers.

Each worker process holds XLA's thread pools, one thread a core, and the
port's tests call the JAX reference at small sizes, so under six workers
every process's threads contend for every core. On an 8-core CPU host,
six ``repro.launch.train --rounds 2`` processes side by side took 196 s
against 16 s for one alone, and 28 s with each held to a core of its
own. The torch side is held to one thread already
(``torch.set_num_threads(1)`` in each module).

``one_core`` (autouse, module scope) holds every thread of the worker
process, and so every thread they start, to one core chosen by the
worker's number, and gives each thread the process's mask back after the
module, before the worker's next file. Outside xdist (a serial run) it
holds nothing. Results do not change: XLA splits its work by the size of
its pools, not by the cores they may run on.

Import it into a test module with ``from _torch_one_core import one_core
# noqa: F401  (autouse fixture)``. A module that starts processes of its
own (gloo ranks, a JAX subprocess: ``test_torch_sharded.py``,
``test_torch_bench_latency.py``) leaves it out, since they would inherit
the one core, and so do the modules whose reference runs long compute
rather than many small programs (``test_torch_bf16.py``,
``test_torch_buffered.py``, ``test_torch_model_families.py``), which took
1.3-1.8x their unpinned time on one core in a six-worker run."""
import os

import pytest


def _hold(mask) -> None:
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), mask)
        except OSError:        # the thread ended meanwhile
            pass


@pytest.fixture(scope="module", autouse=True)
def one_core():
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    if not worker.startswith("gw") or not hasattr(os, "sched_setaffinity"):
        yield
        return
    before = os.sched_getaffinity(0)
    cores = sorted(before)
    _hold({cores[int(worker[2:]) % len(cores)]})
    try:
        yield
    finally:
        _hold(before)
