"""The Mamba2 mixers' share of the card's bf16 peak while they run in the
traced training steps: their model FLOPs (forward and backward, three
times ``perfbench.flops.mixer_flops_per_token`` a token and layer; remat's
recomputation is not model work) over the device time of the kernels
launched inside the program's ``mamba.mixer`` range
(``models/ssm.py::mamba_sequence``: forward, recompute and backward)
and 989.4 TFLOP/s (H100 SXM, dense bf16, 700 W)."""

from perfbench.flops import PEAKS, mixer_flops_per_token

SPAN = "mamba.mixer"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "model: Mamba2 mixer"
MOVES = "train_tok_s"


def step_flops(config, seq_len: int, tokens_per_step: int) -> float:
    """Model FLOPs of every mixer in one training step."""
    return (3 * mixer_flops_per_token(config, seq_len)
            * int(config["n_layers"]) * tokens_per_step)


def read(ctx):
    t, r = ctx.traced, ctx.records
    if (t is None or not t.span_count.get(SPAN)
            or not t.span_device_s[SPAN] or "seq_len" not in r):
        return None
    fl = step_flops(ctx.config, r["seq_len"], r["tokens_per_step"]) \
        * int(ctx.mix["trace_steps"])
    return 100.0 * fl / t.span_device_s[SPAN] / PEAKS["bf16_flops"]
