"""decode_mfu: the whole decode step's share of its roofline over the
window: the sum of each step's least time (``counts.decode_step_work``
over its active rows, at 989 TFLOP/s or 3.35 TB/s, whichever binds) over
the sum of the steps' host times, in percent."""


def read(run):
    rec = run["window"]
    if not rec.get("decode_s"):
        return None
    return sum(rec["decode_bound_s"]) / sum(rec["decode_s"]) * 100.0
