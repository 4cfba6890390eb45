"""The card's idle share in the traced training steps: 1 minus the union
of the device operations' intervals (kernels, copies, fills) over the
traced window, from the profiler's trace."""

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "train_tok_s"


def read(ctx):
    t = ctx.traced
    if t is None or not t.window_s or "steps_done" not in ctx.records:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
