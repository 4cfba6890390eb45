"""The Zamba2 shared blocks' share of the device time of a traced
training step: the kernels launched inside the program's
``zamba.shared`` range (``models/zamba2.py::shared_block``: a site's
shared block with its adapter and linear, in forward, in the recompute
under remat and in backward), over all device operations of the traced
steps."""

SPAN = "zamba.shared"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "model: Zamba2 shared block"
MOVES = "train_tok_s"


def read(ctx):
    t = ctx.traced
    if t is None or not t.span_count.get(SPAN) or not t.kernel_s:
        return None
    return 100.0 * t.span_device_s[SPAN] / t.kernel_s
