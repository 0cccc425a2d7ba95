"""device_idle.serve: the share of the profiled opening seconds of the
serving window in which no operation ran on the card, in percent."""


def read(run):
    trace = run["trace"]
    if trace is None or trace.busy_s() <= 0:
        return None
    return (1.0 - trace.busy_s() / trace.window_s) * 100.0
