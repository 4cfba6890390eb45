"""Training tokens a second: the tokens of the steps done in the window
over its seconds.  The step under way when the window closes counts for
the share of its time that lies inside the window."""

UNIT = "tokens/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(ctx):
    r = ctx.records
    if "steps_done" not in r:
        return None
    return r["steps_done"] * r["tokens_per_step"] / r["window_s"]
