"""The Zamba2 training step's share of the card's bf16 peak: the model
FLOPs of the steps done in the window
(``perfbench.flops_zamba2.train_step_flops``: forward and backward of
every product, the Mamba2 mixers, the shared blocks with their adapters
and site linears, the causal attention core, logits at every position;
remat's recomputation is not counted) over the window's seconds and
989.4 TFLOP/s (H100 SXM, dense bf16, 700 W)."""

from perfbench.flops_zamba2 import PEAKS, train_step_flops

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "train_tok_s"


def read(ctx):
    r = ctx.records
    if "steps_done" not in r:
        return None
    fl = train_step_flops(ctx.config, r["batch"], r["seq_len"]) * r["steps_done"]
    return 100.0 * fl / r["window_s"] / PEAKS["bf16_flops"]
