"""k12_roofline: the least time of the K1 and K2 work of the profiled
rounds (``counts.k12_bound_s`` from each call's shapes) over the device
time of every operation launched inside the kernel API's
``factored_stack_gram_layered``, in percent."""


def read(run):
    trace, rec = run["trace"], run["window"]
    if trace is None:
        return None
    t = trace.device_s("k12")
    if t <= 0 or not rec.get("k12_bound_s"):
        return None
    return rec["k12_bound_s"] / t * 100.0
