"""Attention on the model layout (B, S, heads, d): the CUDA kernel for
tensors on the card, the plain version for tensors on the CPU."""

from __future__ import annotations

from typing import Tuple

import torch

from .kernel import flash_attention_cuda
from .ref import attention_ref

__all__ = ["mha", "mha_ref", "flash_blocks"]


def flash_blocks(Sq: int, Skv: int, block_q: int,
                 block_kv: int) -> Tuple[int, int]:
    """The blocks a call runs at: each clipped to its sequence, as the
    JAX kernel clips them.  Raises ``ValueError`` unless they divide."""
    bq, bkv = min(block_q, Sq), min(block_kv, Skv)
    if bq < 1 or bkv < 1 or Sq % bq or Skv % bkv:
        raise ValueError(f"blocks ({block_q}, {block_kv}) do not divide "
                         f"the sequences ({Sq}, {Skv})")
    return bq, bkv


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, softcap: float = 0.0,
        q_offset: int = 0, block_q: int = 128,
        block_kv: int = 128) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) -> (B, Sq, H, hd)."""
    bq, bkv = flash_blocks(q.shape[1], k.shape[1], block_q, block_kv)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset,
                                    block_q=bq, block_kv=bkv)
    return mha_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                   q_offset=q_offset)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            **kw) -> torch.Tensor:
    """The plain version on the model layout; block sizes are ignored."""
    kw.pop("block_q", None)
    kw.pop("block_kv", None)
    o = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), **kw)
    return o.transpose(1, 2).contiguous()
