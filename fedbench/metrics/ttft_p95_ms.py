"""ttft_p95_ms: the 95th percentile, over every request that got its
first token in the window, of the time from when it was due (its
client's previous request completed) to its first token on the host."""
import numpy as np


def read(run):
    ttft = run["window"].get("ttft_s")
    if not ttft:
        return None
    return float(np.percentile(np.asarray(ttft) * 1e3, 95))
