"""admit_ms.ttft: host milliseconds around a ``ServingEngine.admit`` call
and the read of its first tokens, the mean over the window."""
import statistics


def read(run):
    s = run["window"].get("admit_s")
    return statistics.fmean(s) * 1e3 if s else None
