"""The optimizer's share of the device time of a traced training step:
the kernels launched inside the program's ``apply_updates``, as the
train step calls it (wrapped in a ``perfbench.optim`` range while the
benchmark traces), over all device operations of the traced steps."""

SPAN = "perfbench.optim"
WRAP = "repro_torch.train.step:apply_updates"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "optimizer"
MOVES = "train_tok_s"


def read(ctx):
    t = ctx.traced
    if t is None or not t.span_count.get(SPAN) or not t.kernel_s:
        return None
    return 100.0 * t.span_device_s[SPAN] / t.kernel_s
