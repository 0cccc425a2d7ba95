"""prefill_mfu: the admitted rows' model operations
(``counts.prefill_row_flops``; the rows a full-width prefill computes for
slots it does not admit are not counted) over the admits' host time at
bf16's 989 TFLOP/s, in percent."""
from fedbench.counts import PEAK_BF16_FLOPS


def read(run):
    rec = run["window"]
    if not rec.get("admit_s"):
        return None
    return sum(rec["admit_flops"]) / (sum(rec["admit_s"])
                                      * PEAK_BF16_FLOPS) * 100.0
