"""train_ms.round: CUDA-event milliseconds of the server's train stage
(``_train_grouped``), the mean over the traced run's rounds."""
import statistics


def read(run):
    ms = run["window"].get("train_ms")
    return statistics.fmean(ms) if ms else None
