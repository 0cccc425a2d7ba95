"""decode_step_ms.serve: host milliseconds around a ``ServingEngine.decode``
call and the read of its tokens, the mean over the window."""
import statistics


def read(run):
    s = run["window"].get("decode_s")
    return statistics.fmean(s) * 1e3 if s else None
