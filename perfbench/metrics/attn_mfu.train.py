"""The shared attention core's share of the card's bf16 peak while it
runs in the traced training steps (the fused kernel's share of its
roofline): three times its causal forward FLOPs
(``perfbench.flops_zamba2.attn_flops_per_token`` a token and site; the
recompute under remat is not model work) over the device time of the
kernels launched inside the program's ``zamba.attn`` range
(``models/zamba2.py``'s call of ``attention_core``: forward, recompute
and backward) and 989.4 TFLOP/s (H100 SXM, dense bf16, 700 W)."""

from perfbench.flops_zamba2 import PEAKS, attn_flops_per_token

SPAN = "zamba.attn"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "model: shared attention core"
MOVES = "train_tok_s"


def step_flops(config, seq_len: int, tokens_per_step: int) -> float:
    """Model FLOPs of the attention core at every site in one step."""
    return (3 * attn_flops_per_token(config, seq_len)
            * len(config["hybrid_layer_ids"]) * tokens_per_step)


def read(ctx):
    t, r = ctx.traced, ctx.records
    if (t is None or not t.span_count.get(SPAN)
            or not t.span_device_s[SPAN] or "seq_len" not in r):
        return None
    fl = step_flops(ctx.config, r["seq_len"], r["tokens_per_step"]) \
        * int(ctx.mix["trace_steps"])
    return 100.0 * fl / t.span_device_s[SPAN] / PEAKS["bf16_flops"]
