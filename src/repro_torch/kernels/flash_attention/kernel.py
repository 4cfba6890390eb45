"""ctypes binding of ``csrc/flash_attention.cu``: one launch per call,
on the model layout (B, S, heads, d), float32 or bfloat16.

The kernel has two bodies behind one entry point: bfloat16 runs
``wgmma`` on K/V tiles brought by TMA into a two-stage ring; float32
runs 3xTF32 ``mma.sync`` on cp.async double buffers.  A block whose
staging exceeds the card's opt-in shared memory is refused here, before
the launch (:func:`flash_smem_bytes` is the C source's formula).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..build import (CudaKernel, current_stream, require_cuda_tensor,
                     smem_optin)

__all__ = ["flash_attention_kernel", "flash_attention_cuda",
           "flash_smem_bytes", "HEAD_DIMS", "BLOCK_KVS", "MAX_BLOCK_Q"]

HEAD_DIMS = (32, 64, 256)           # the head dims the kernel is built for
BLOCK_KVS = (16, 32, 64, 128)       # the KV blocks it is built for
MAX_BLOCK_Q = 128                   # query rows per CTA, a multiple of 16
_DTYPES = (torch.float32, torch.bfloat16)
_PAD = 4                            # floats of padding per staged f32 row
_STAGES = 2                         # the bf16 path's ring of K/V tiles

# q, k, v, o; B, Sq, Skv, H, K, D, bf16, block_q, block_kv, causal,
# window; softcap; q_offset; scale; stream
flash_attention_kernel = CudaKernel(
    "flash_attention", "flash_attention_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def flash_smem_bytes(d: int, block_q: int, block_kv: int,
                     dtype: torch.dtype = torch.float32) -> int:
    """Shared memory one CTA stages.  float32: the Q tile and two
    cp.async stages of K and V tiles, rows of d + 4 floats.  bfloat16:
    the Q tile padded to 64 rows per warpgroup, a TMA ring of two stages
    of K and V tiles, 1,024 bytes of slack to align the swizzled tiles
    and 64 of mbarriers."""
    if dtype == torch.bfloat16:
        return (1024 + 2 * 64 * -(-block_q // 64) * d
                + 2 * _STAGES * block_kv * d * 2 + 64)
    return 4 * (block_q + 2 * 2 * block_kv) * (d + _PAD)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, softcap: float,
                         q_offset: int, block_q: int,
                         block_kv: int) -> torch.Tensor:
    """q: (B, Sq, H, d); k, v: (B, Skv, K, d) on the card, contiguous,
    all float32 or all bfloat16 -> o: (B, Sq, H, d) in q's type.
    ``block_q``/``block_kv`` must divide Sq/Skv (see ``flash_blocks``)."""
    B, Sq, H, d = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for "
                         f"{HEAD_DIMS}")
    if K < 1 or H % K:
        raise ValueError(f"GQA needs H % K == 0 (H={H}, K={K})")
    require_cuda_tensor("q", q, (B, Sq, H, d), _DTYPES)
    for name, t in (("k", k), ("v", v)):
        require_cuda_tensor(name, t, (B, Skv, K, d), (q.dtype,), q.device)
    if (block_q % 16 or not 16 <= block_q <= MAX_BLOCK_Q
            or block_kv not in BLOCK_KVS or Sq % block_q or Skv % block_kv):
        raise ValueError(f"blocks ({block_q}, {block_kv}): block_q must "
                         f"be a multiple of 16 up to {MAX_BLOCK_Q} and "
                         f"block_kv one of {BLOCK_KVS}, dividing "
                         f"({Sq}, {Skv})")
    if q.dtype == torch.bfloat16 and d == 256 and block_q > 64:
        raise ValueError(f"block_q {block_q} at head dim 256 in bfloat16: "
                         f"the kernel takes at most 64 (one warpgroup)")
    smem = flash_smem_bytes(d, block_q, block_kv, q.dtype)
    cap = smem_optin(q.device)
    if smem > cap:
        raise ValueError(f"blocks ({block_q}, {block_kv}) at head dim {d} "
                         f"stage {smem} B of shared memory; the card "
                         f"allows {cap} B per block")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        flash_attention_kernel.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
            Skv, H, K, d, int(q.dtype == torch.bfloat16), block_q, block_kv,
            int(bool(causal)), int(window), float(softcap), int(q_offset),
            1.0 / math.sqrt(d), current_stream(q.device))
    return o
