"""round_ms: the window's wall time over the raFLoRA rounds completed in
it; the window closes at the end of the first round that ends past
``--seconds``, each round ending with its global adapters on the card."""


def read(run):
    rec = run["window"]
    if not rec.get("rounds"):
        return None
    return rec["elapsed_s"] * 1e3 / rec["rounds"]
