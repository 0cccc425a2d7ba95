"""aggregate_ms.round: CUDA-event milliseconds of the server's aggregate
stage (``_aggregate_grouped``), the mean over the traced run's rounds."""
import statistics


def read(run):
    ms = run["window"].get("aggregate_ms")
    return statistics.fmean(ms) if ms else None
