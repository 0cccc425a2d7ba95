"""round_mfu: the client training's model operations of the traced run's
rounds (``counts.round_train_flops``) over their wall time at the
f32-accurate 3xTF32 peak, in percent."""
from fedbench.counts import PEAK_TF32X3_FLOPS


def read(run):
    rec = run["window"]
    skip = rec.get("traced_rounds", 0)
    secs, flops = rec["round_s"][skip:], rec["train_flops"][skip:]
    if not secs:
        secs, flops = rec["round_s"], rec["train_flops"]
    if not secs:
        return None
    return sum(flops) / (sum(secs) * PEAK_TF32X3_FLOPS) * 100.0
