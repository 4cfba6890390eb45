"""Operation counts of the benchmark's work, from the shapes of a
configuration alone (the configuration file's numbers, never the
program's objects), and the card's published peak.

A multiply-add counts 2 operations.  Elementwise work (norms, gates,
the optimizer) is not counted: model FLOPs are those of the products,
as utilisation is usually stated.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM5 80 GB data sheet, dense bf16, at the 700 W limit.
PEAKS = {"bf16_flops": 989.4e12}


def dims(m: Dict) -> Dict[str, int]:
    d = int(m["d_model"])
    di = int(m["ssm_expand"]) * d
    return {"d": d, "di": di, "N": int(m["ssm_state"]),
            "H": di // int(m["ssm_head_dim"]), "P": int(m["ssm_head_dim"]),
            "K": int(m["conv_kernel"]), "Q": int(m["ssm_chunk"]),
            "V": int(m["vocab"]), "L": int(m["n_layers"])}


def mixer_flops_per_token(m: Dict, seq: int) -> float:
    """One Mamba2 mixer: in-projection, conv, the chunked SSD (causal
    terms within a chunk of ``min(chunk, seq)``, the state each token
    adds and the state each token reads) and out-projection."""
    x = dims(m)
    Q = min(x["Q"], seq)
    proj = 2 * x["d"] * (2 * x["di"] + 2 * x["N"] + x["H"]) + 2 * x["di"] * x["d"]
    conv = 2 * x["K"] * (x["di"] + 2 * x["N"])
    intra = 2 * (Q + 1) / 2 * (x["N"] + x["H"] * x["P"])
    state = 2 * 2 * x["H"] * x["P"] * x["N"]
    return proj + conv + intra + state


def forward_flops(m: Dict, seq: int) -> float:
    """Forward operations of one row of ``seq`` tokens through every
    layer, with logits at every position."""
    x = dims(m)
    return x["L"] * mixer_flops_per_token(m, seq) * seq \
        + 2 * x["d"] * x["V"] * seq


def train_step_flops(m: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: forward and backward (three
    times the forward); the recomputation that remat adds is not model
    work."""
    if m["family"] != "ssm":
        raise ValueError(f"no count for family {m['family']!r}")
    return 3 * batch * forward_flops(m, seq)
