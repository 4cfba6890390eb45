"""Set-up time: process start to the first timed step (imports, the
card's start, the weights drawn from the seed, and the checked first
steps, which warm every shape of the window)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
