"""svd_ms.round: device milliseconds of every operation launched inside
``svd_realloc_gram`` (the Gram cores' eigensolves and the core SVD), a
profiled round's mean."""


def read(run):
    trace, rec = run["trace"], run["window"]
    if trace is None or not rec.get("traced_rounds"):
        return None
    t = trace.device_s("svd")
    return t * 1e3 / rec["traced_rounds"] if t > 0 else None
