"""Plain version of the flash-attention kernel: the full (Sq, Skv) score
matrix, ``-inf`` masking and ``softmax`` (the JAX package's
``attention_ref``, operation for operation).

O(S^2) memory; the ground truth the kernel is held against.  A row that
every position masks gives NaN here and 0 in the kernel (the JAX pair
differs the same way), so comparisons keep off such rows.

:func:`flash_tiled_ref` follows the CUDA kernel's tiles and numerics in
plain PyTorch (tests only; nothing on the main path calls it), so the
tests can check the kernel's arithmetic on the CPU.
"""

from __future__ import annotations

import math

import torch

from .kernel import HEAD_DIMS, WIDE_CHUNK, flash_plan

__all__ = ["attention_ref", "flash_tiled_ref"]

_NEG_INF = -1e30          # the TPU kernel's masked score


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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 with its low 13 mantissa bits cleared: what the tensor
    core reads of a float32 register as TF32."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three TF32 products of the big/small split:
    a_small b_big + a_big b_small + a_big b_big."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def flash_tiled_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """q: (B, Sq, H, d); k, v: (B, Skv, K, d), the model layout ->
    (B, Sq, H, d) in q's type, walking the tiles the kernel walks (those
    of ``flash_plan`` for these blocks on an H100; a last tile past Sq or
    Skv is cut short, as the kernel masks its padded rows): the online
    softmax in float32 with scores masked to -1e30, the soft-cap before
    the mask, p zeroed where masked, l the sum of the float32 p, and
    acc / max(l, 1e-30).  Blocks are clipped to the sequences and must
    divide them.

    float32: q is scaled before the dot, and both products are the three
    TF32 products of the big/small split.  bfloat16: S is formed from
    the bf16 inputs in float32 and scaled after, and P is rounded to
    bf16 before P . V.  Above d 256 (the wide body, either type): one
    walk per slice of at most 256 of V's columns, each forming the whole
    S over all d columns as a sum of 3xTF32 products of
    ``WIDE_CHUNK``-column chunks, with the float32 numerics."""
    B, Sq, H, d = q.shape
    Skv, K = k.shape[1], k.shape[2]
    bq, bkv = min(block_q, Sq), min(block_kv, Skv)
    if Sq % bq or Skv % bkv:
        raise ValueError(f"blocks ({bq}, {bkv}) do not divide ({Sq}, "
                         f"{Skv})")
    plan = flash_plan(d, Sq, Skv, bq, bkv, q.dtype)
    tq, tkv = plan.tile_q, plan.tile_kv
    wide = plan.slices > 1
    bf16 = q.dtype == torch.bfloat16 and not wide
    scale = 1.0 / math.sqrt(d)
    # (B, H, S, d) float32, k and v repeated onto their query heads
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
    if not bf16:
        qf = qf * scale

    def scores(qb, kt):
        if bf16:
            return (qb @ kt.transpose(-1, -2)) * scale
        if wide:
            return sum(_mm_3xtf32(qb[..., c:c + WIDE_CHUNK],
                                  kt[..., c:c + WIDE_CHUNK].transpose(-1, -2))
                       for c in range(0, d, WIDE_CHUNK))
        return _mm_3xtf32(qb, kt.transpose(-1, -2))

    def walk(vs):
        """O's columns of the V columns ``vs`` (one launch's slice)."""
        out = torch.empty(qf.shape[:-1] + vs.shape[-1:], device=q.device)
        for q0 in range(0, Sq, tq):
            q1 = min(q0 + tq, Sq)
            pos = torch.arange(q0, q1, device=q.device) + q_offset
            lo, hi = 0, plan.n_kv       # the KV tiles with a live pair
            if causal:
                hi = min(hi, max(0, (q1 - 1 + q_offset) // tkv + 1))
            if window > 0:
                lo = max(0, (q0 + q_offset - window + 1) // tkv)
            qb = qf[:, :, q0:q1]
            m = torch.full(qb.shape[:-1], _NEG_INF, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros(qb.shape[:-1] + vs.shape[-1:],
                              device=q.device)
            for kb in range(lo, hi):
                k0, k1 = kb * tkv, min(kb * tkv + tkv, Skv)
                kt, vt = kf[:, :, k0:k1], vs[:, :, k0:k1]
                s = scores(qb, kt)
                if softcap and softcap > 0:
                    s = torch.tanh(s / softcap) * softcap
                dist = pos[:, None] - torch.arange(k0, k1,
                                                   device=q.device)[None, :]
                ok = torch.ones_like(dist, dtype=torch.bool)
                if causal:
                    ok &= dist >= 0
                if window > 0:
                    ok &= dist < window
                s = torch.where(ok, s, torch.full_like(s, _NEG_INF))
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.where(ok, torch.exp(s - m_new[..., None]),
                                torch.zeros_like(s))
                l = l * corr + p.sum(-1)
                pv = (p.to(torch.bfloat16).float() @ vt if bf16
                      else _mm_3xtf32(p, vt))
                acc = acc * corr[..., None] + pv
                m = m_new
            out[:, :, q0:q1] = acc / torch.clamp(l, min=1e-30)[..., None]
        return out

    step = HEAD_DIMS[-1] if wide else d
    out = torch.cat([walk(vf[..., c0:c0 + step])
                     for c0 in range(0, d, step)], dim=-1)
    return out.transpose(1, 2).contiguous().to(q.dtype)
