"""Remat's share of the device time of a traced training step: the
kernels launched inside the program's ``remat.recompute`` range (the
recompute context of ``train/remat.py::maybe_remat``, around the re-run
of a checkpointed layer body in backward), over all device operations
of the traced steps."""

SPAN = "remat.recompute"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "remat"
MOVES = "train_tok_s"


def read(ctx):
    t = ctx.traced
    if t is None or not t.span_count.get(SPAN) or not t.kernel_s:
        return None
    return 100.0 * t.span_device_s[SPAN] / t.kernel_s
