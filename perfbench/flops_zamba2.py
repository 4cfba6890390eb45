"""Operation counts of a training step of Zamba2 in its published form,
from the configuration file's numbers alone (never the program's
objects), on ``perfbench/flops.py``'s conventions: a multiply-add counts
2 operations, only products count (norms, gates, the optimizer do not),
and a step is three times its forward (remat's re-run is not model
work).
"""

from __future__ import annotations

from typing import Dict

from perfbench.flops import PEAKS, mixer_flops_per_token

__all__ = ["PEAKS", "shared_flops_per_token", "attn_flops_per_token",
           "forward_flops", "train_step_flops"]


def attn_flops_per_token(m: Dict, seq: int) -> float:
    """One site's causal attention core: each of its two products (Q K^T
    and P V) takes a token H hd (seq + 1) operations (2 a multiply-add
    over the (seq + 1) / 2 keys it sees on average)."""
    return 2 * int(m["n_heads"]) * int(m["head_dim"]) * (seq + 1)


def shared_flops_per_token(m: Dict, seq: int) -> float:
    """One site: the shared block's products on the 2 d wide input (Q, K,
    V), its attention core and output, the GeGLU with the site's LoRA
    adapter, and the site's linear."""
    d, f, r = int(m["d_model"]), int(m["d_ff"]), int(m["adapter_rank"])
    width = int(m["n_heads"]) * int(m["head_dim"])
    kv = int(m["n_kv_heads"]) * int(m["head_dim"])
    qkv = 2 * 2 * d * (width + 2 * kv)
    out = 2 * width * d
    mlp = 2 * d * 2 * f + 2 * f * d
    adapter = 2 * d * r + 2 * r * 2 * f
    linear = 2 * d * d
    return qkv + out + mlp + adapter + linear + attn_flops_per_token(m, seq)


def forward_flops(m: Dict, seq: int) -> float:
    """Forward operations of one row of ``seq`` tokens: every Mamba2
    mixer, every site, logits at every position."""
    sites = len(m["hybrid_layer_ids"])
    per_token = (int(m["n_layers"]) * mixer_flops_per_token(m, seq)
                 + sites * shared_flops_per_token(m, seq)
                 + 2 * int(m["d_model"]) * int(m["vocab"]))
    return per_token * seq


def train_step_flops(m: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: forward and backward."""
    if m["family"] != "zamba2":
        raise ValueError(f"no count for family {m['family']!r}")
    return 3 * batch * forward_flops(m, seq)
