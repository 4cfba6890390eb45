"""The Mamba2 mixer's depthwise causal conv's share of the device time of
a traced training step: the kernels launched inside the program's
``mamba.conv`` range (``models/ssm.py::_conv``, which opens it around
its forward, its recompute under remat and its backward), over all
device operations of the traced steps."""

SPAN = "mamba.conv"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "model: Mamba2 causal conv"
MOVES = "train_tok_s"


def read(ctx):
    t = ctx.traced
    if t is None or not t.span_count.get(SPAN) or not t.kernel_s:
        return None
    return 100.0 * t.span_device_s[SPAN] / t.kernel_s
