"""Plain version of the flash-attention kernel: the full (Sq, Skv) score
matrix, ``-inf`` masking and ``softmax`` (the JAX package's
``attention_ref``, operation for operation).

O(S^2) memory; the ground truth the kernel is held against.  A row that
every position masks gives NaN here and 0 in the kernel (the JAX pair
differs the same way), so comparisons keep off such rows.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, d); k, v: (B, K, Skv, d) with H % K == 0.

    ``q_offset``: absolute position of q[0] (decode: Skv - Sq).
    """
    B, H, Sq, d = q.shape
    K = k.shape[1]
    G = H // K
    qf = q.float() / math.sqrt(d)
    kf = k.float()
    vf = v.float()
    qf = qf.reshape(B, K, G, Sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf)
    if softcap and softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    kv_pos = torch.arange(k.shape[2], device=q.device)
    dist = q_pos[:, None] - kv_pos[None, :]
    ok = torch.ones_like(dist, dtype=torch.bool)
    if causal:
        ok &= dist >= 0
    if window and window > 0:
        ok &= dist < window
    s = torch.where(ok, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
    return o.reshape(B, H, Sq, d).to(q.dtype)
