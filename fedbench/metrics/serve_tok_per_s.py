"""serve_tok_per_s: every token generated in the window (first tokens
included, each read back to the host) over the window's seconds; the
window closes at the end of the first engine call that ends past
``--seconds``."""


def read(run):
    rec = run["window"]
    if "tokens" not in rec or not rec["elapsed_s"]:
        return None
    return rec["tokens"] / rec["elapsed_s"]
