"""k4_roofline.decode: the least time of the decode steps' K4 calls in the
profiled seconds (``counts.k4_work`` at bf16's 989 TFLOP/s or 3.35
TB/s, whichever binds) over the device time of every operation launched
inside those calls, in percent."""


def read(run):
    trace, rec = run["trace"], run["window"]
    if trace is None:
        return None
    t = trace.device_s("k4.decode")
    if t <= 0 or not rec.get("k4_bound_s"):
        return None
    return rec["k4_bound_s"] / t * 100.0
