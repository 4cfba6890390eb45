"""ctypes binding of ``csrc/flash_attention.cu``: one launch per call,
on the model layout (B, S, heads, d), float32 or bfloat16.

The kernel has two bodies behind one entry point: bfloat16 runs
``wgmma`` on K/V tiles brought by TMA into a two-stage ring; float32
runs 3xTF32 ``mma.sync`` on cp.async double buffers.  Each body is built
for a few native head dims and tiles; :func:`flash_plan` maps any head
dim up to 256 and any blocks that divide their sequences onto them (the
mapping is exact: see its docstring), and :func:`flash_smem_bytes` is
the C source's staging formula.  A head dim above 256 runs the wide
body in slices of V's columns (:func:`flash_wide_smem_bytes`).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..build import (CudaKernel, current_stream, require_cuda_tensor,
                     smem_optin)

__all__ = ["flash_attention_kernel", "flash_attention_cuda",
           "flash_smem_bytes", "flash_wide_smem_bytes", "flash_plan",
           "FlashPlan", "HEAD_DIMS", "BLOCK_KVS", "MAX_BLOCK_Q",
           "WIDE_CHUNK", "H100_SMEM_OPTIN"]

HEAD_DIMS = (32, 64, 128, 256)      # the native head dims of both bodies
BLOCK_KVS = (16, 32, 64, 128)       # the native KV tiles
MAX_BLOCK_Q = 128                   # query rows per CTA, a multiple of 16
H100_SMEM_OPTIN = 232448            # an H100's opt-in shared memory a block
_DTYPES = (torch.float32, torch.bfloat16)
_PAD = 4                            # floats of padding per staged f32 row
_STAGES = 2                         # the bf16 path's ring of K/V tiles
WIDE_CHUNK = 64                     # q/k columns the wide body stages

# q, k, v, o; B, Sq, Skv, H, K, d, D, bf16, tile_q, tile_kv, general,
# tma, causal, window; softcap; q_offset; scale; stream
flash_attention_kernel = CudaKernel(
    "flash_attention", "flash_attention_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def flash_smem_bytes(d: int, block_q: int, block_kv: int,
                     dtype: torch.dtype = torch.float32) -> int:
    """Shared memory one CTA stages at native head dim ``d`` and tiles
    (``block_q``, ``block_kv``).  float32: the Q tile and two cp.async
    stages of K and V tiles, rows of d + 4 floats.  bfloat16: the Q tile
    padded to 64 rows per warpgroup, a TMA ring of two stages of K and V
    tiles, 1,024 bytes of slack to align the swizzled tiles and 64 of
    mbarriers."""
    if dtype == torch.bfloat16:
        return (1024 + 2 * 64 * -(-block_q // 64) * d
                + 2 * _STAGES * block_kv * d * 2 + 64)
    return 4 * (block_q + 2 * 2 * block_kv) * (d + _PAD)


def flash_wide_smem_bytes(D: int, block_q: int) -> int:
    """Shared memory one CTA of the wide body (d > 256) stages for a
    slice of V of native width ``D``, in either type: :data:`WIDE_CHUNK`
    columns of the Q tile and of a 16-row K tile, and the slice's 16-row
    V tile, as float32 rows padded by 4 floats."""
    return 4 * ((block_q + BLOCK_KVS[0]) * (WIDE_CHUNK + _PAD)
                + BLOCK_KVS[0] * (D + _PAD))


def _tile_q(block_q: int, max_q: int) -> int:
    """The largest multiple of 16 up to ``max_q`` that divides
    ``block_q``, else the multiple of 16 it rounds up to (at most
    ``max_q``)."""
    return next((n for n in range(max_q, 0, -16) if block_q % n == 0),
                min(-(-block_q // 16) * 16, max_q))


class FlashPlan(NamedTuple):
    """How one call runs: the body, its native head dim ``D`` (columns
    d..D zero-filled as they load, never stored), ``tile_q`` query rows
    per CTA, ``tile_kv`` KV rows per step of the online softmax over
    ``n_kv`` steps, the CTA's staged bytes, whether K/V come by TMA (bf16
    with d % 8 == 0 on aligned tensors), whether the general body runs
    (``general``: a last tile past Sq or Skv, d below D, or tensors off
    the 16-byte grid), and in how many ``slices`` of V's columns, one
    launch each: 1 up to d 256; above it ceil(d / 256), each slice at
    most D = 256 wide and run by the wide body.  The C entry point runs
    this choice and refuses one its bodies cannot take."""
    body: str
    D: int
    tile_q: int
    tile_kv: int
    n_kv: int
    smem: int
    tma: bool
    general: bool
    slices: int


def flash_plan(d: int, Sq: int, Skv: int, block_q: int, block_kv: int,
               dtype: torch.dtype = torch.float32,
               smem_cap: int = H100_SMEM_OPTIN,
               aligned: bool = True) -> FlashPlan:
    """The launch of a call with head dim ``d`` at the (clipped, dividing)
    blocks ``(block_q, block_kv)``, with tensors on the 16-byte grid
    (``aligned``) or not.

    The native head dim is the least of :data:`HEAD_DIMS` >= d.  The
    tiles are the largest native ones that divide the blocks (a multiple
    of 16 up to 128 query rows, 64 in bf16 at D 256; one of
    :data:`BLOCK_KVS` KV rows, halved while the staging exceeds
    ``smem_cap``), so a block the body takes is the tile and the launch
    is the caller's, and a larger block runs as sub-tiles: more CTAs for
    its queries, more steps of the KV walk.  A block with no dividing
    tile (off the 16-row grid: decode's 1, divisors of 1,500) takes the
    tile it rounds up to, and the sequence is walked in whole tiles whose
    rows past Sq or Skv are zero-filled and masked: no score of theirs
    enters a softmax, no row of theirs is stored.  That, d below D and
    unaligned tensors run the general body, built at tile_kv 16 (and, in
    bf16, tile_q <= 64) only.
    Rows are independent and the online softmax is exact, so the tiles
    move only the float rounding (the reference's blockings agree within
    1e-5).

    A head dim above 256 runs as ceil(d / 256) launches of the wide
    body, each over a slice of at most 256 of V's and O's columns: each
    computes the whole S = (q * scale) . k^T over all d columns, in
    chunks of :data:`WIDE_CHUNK` staged through shared memory, and its
    slice of O at the slice's native width, so O stays within a thread's
    registers.  The softmax is the same in every slice, so the slices
    are exact.  Inputs of either type are staged as float32 and both
    products are 3xTF32; the tiles are those of the general body (16 KV
    rows; tile_q as above, up to 128 in both types).  Raises
    ``ValueError`` for d or blocks below 1."""
    if d < 1:
        raise ValueError(f"head dim {d} must be >= 1")
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"blocks ({block_q}, {block_kv}) must be >= 1")
    bf16 = dtype == torch.bfloat16
    body = "bf16" if bf16 else "f32"
    if d > HEAD_DIMS[-1]:
        tile_q = _tile_q(block_q, MAX_BLOCK_Q)
        smem = flash_wide_smem_bytes(HEAD_DIMS[-1], tile_q)
        if smem > smem_cap:
            raise ValueError(f"head dim {d} stages {smem} B; the card "
                             f"allows {smem_cap} B per block")
        return FlashPlan(body, HEAD_DIMS[-1], tile_q, BLOCK_KVS[0],
                         -(-Skv // BLOCK_KVS[0]), smem, False, True,
                         -(-d // HEAD_DIMS[-1]))
    D = next(n for n in HEAD_DIMS if n >= d)
    # d 256 in bf16: one consumer warpgroup (O is 128 registers a thread)
    tile_q = _tile_q(block_q, 64 if bf16 and D == 256 else MAX_BLOCK_Q)
    tile_kv = next((n for n in BLOCK_KVS[::-1] if block_kv % n == 0),
                   BLOCK_KVS[0])
    while (flash_smem_bytes(D, tile_q, tile_kv, dtype) > smem_cap
           and tile_kv > BLOCK_KVS[0]):
        tile_kv //= 2

    general = bool(d != D or Sq % tile_q or Skv % tile_kv or not aligned)
    if general:
        tile_kv = BLOCK_KVS[0]
        tile_q = min(tile_q, 64) if bf16 else tile_q
    smem = flash_smem_bytes(D, tile_q, tile_kv, dtype)
    if smem > smem_cap:
        raise ValueError(f"head dim {d} stages {smem} B at the least tiles; "
                         f"the card allows {smem_cap} B per block")
    return FlashPlan(body, D, tile_q, tile_kv, -(-Skv // tile_kv), smem,
                     bf16 and d % 8 == 0 and aligned, general, 1)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, softcap: float,
                         q_offset: int, block_q: int,
                         block_kv: int) -> torch.Tensor:
    """q: (B, Sq, H, d); k, v: (B, Skv, K, d) on the card, contiguous,
    all float32 or all bfloat16 -> o: (B, Sq, H, d) in q's type.
    ``block_q``/``block_kv`` must divide Sq/Skv (see ``flash_blocks``);
    :func:`flash_plan` gives the launch (one entry-point call; above d
    256 it launches once per slice)."""
    B, Sq, H, d = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if K < 1 or H % K:
        raise ValueError(f"GQA needs H % K == 0 (H={H}, K={K})")
    require_cuda_tensor("q", q, (B, Sq, H, d), _DTYPES)
    for name, t in (("k", k), ("v", v)):
        require_cuda_tensor(name, t, (B, Skv, K, d), (q.dtype,), q.device)
    if block_q < 1 or block_kv < 1 or Sq % block_q or Skv % block_kv:
        raise ValueError(f"blocks ({block_q}, {block_kv}) do not divide "
                         f"({Sq}, {Skv})")
    o = torch.empty_like(q)
    plan = flash_plan(d, Sq, Skv, block_q, block_kv, q.dtype,
                      smem_optin(q.device),
                      all(t.data_ptr() % 16 == 0 for t in (q, k, v, o)))
    with torch.cuda.device(q.device):
        flash_attention_kernel.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
            Skv, H, K, d, plan.D, int(plan.body == "bf16"), plan.tile_q,
            plan.tile_kv, int(plan.general), int(plan.tma),
            int(bool(causal)), int(window), float(softcap),
            int(q_offset), 1.0 / math.sqrt(d), current_stream(q.device))
    return o
