"""ctypes binding of ``csrc/flash_attention.cu``: one launch per call,
on the model layout (B, S, heads, d), float32 or bfloat16.

The kernel stages the pre-scaled Q tile, the K and V tiles, the score
tile and the accumulator in shared memory as float32; a block whose
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
           "flash_smem_bytes", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 256)           # the head dims the kernel is built for
_DTYPES = (torch.float32, torch.bfloat16)
_PAD = 4                            # floats of padding per staged row

# q, k, v, o; B, Sq, Skv, H, K, D, bf16, block_q, block_kv, causal,
# window; softcap; q_offset; scale; stream
flash_attention_kernel = CudaKernel(
    "flash_attention", "flash_attention_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def flash_smem_bytes(d: int, block_q: int, block_kv: int) -> int:
    """Shared memory one CTA stages: Q, K, V and accumulator tiles of
    (rows, d + 4) float32, the (block_q, block_kv + 1) score tile and
    three floats per query row (m, l, corr)."""
    return 4 * ((2 * block_q + 2 * block_kv) * (d + _PAD)
                + block_q * (block_kv + 1) + 3 * block_q)


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
    if block_q % 4 or block_kv % 4 or Sq % block_q or Skv % block_kv:
        raise ValueError(f"blocks ({block_q}, {block_kv}) must be "
                         f"multiples of 4 dividing ({Sq}, {Skv})")
    smem, cap = flash_smem_bytes(d, block_q, block_kv), smem_optin(q.device)
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
