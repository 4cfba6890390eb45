"""Blockwise int8 quantization + error-feedback gradient compression.

The JAX package's ``dist/compression.py``.  Quantization is
absmax-per-block (|x - dequant(quant(x))| <= absmax/127 per block),
computed in the input's dtype.  Error feedback keeps the quantization
residue and folds it into the next step's gradient, so the long-run
gradient sum is preserved (EF-SGD argument); the train step applies it
to the gradient tree right before the (simulated) all-reduce.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from ..utils import tree_leaves, unflatten_like

__all__ = ["quantize_blockwise", "dequantize_blockwise", "ef_compress",
           "ef_compress_tree"]


def quantize_blockwise(x: torch.Tensor, block: int = 256, *,
                       bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize to int8 with one absmax scale per ``block`` elements.

    Returns ``(q, scales)`` with ``q`` shaped (n_blocks, block) — padded
    with zeros past the original size — and ``scales`` shaped (n_blocks,).
    """
    qmax = (1 << (bits - 1)) - 1
    flat = x.reshape(-1)
    n = flat.numel()
    n_blocks = max(1, -(-n // block))
    pad = n_blocks * block - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(n_blocks, block)
    absmax = torch.amax(torch.abs(blocks), dim=1)
    scales = absmax / qmax
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(blocks / safe[:, None]), -qmax, qmax)
    return q.to(torch.int8), scales.to(torch.float32)


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor,
                         shape: Tuple[int, ...]) -> torch.Tensor:
    y = (q.float() * scales[:, None]).reshape(-1)
    return y[: math.prod(shape) if shape else 1].reshape(shape)


def ef_compress(g: torch.Tensor, err: Optional[torch.Tensor] = None, *,
                bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress ``g`` (+ carried-in error) and return (g_hat, new error).

    Invariant: g_hat + new_error == g + carried_error (up to float eps),
    which is what makes the long-run gradient sum exact.
    """
    target = g if err is None else g + err
    q, s = quantize_blockwise(target, bits=bits)
    g_hat = dequantize_blockwise(q, s, tuple(target.shape)).to(g.dtype)
    return g_hat, (target - g_hat).to(g.dtype)


def ef_compress_tree(tree: Any, err_tree: Optional[Any] = None, *,
                     bits: int = 8) -> Tuple[Any, Any]:
    """``ef_compress`` over a gradient tree; returns (g_hat, errors)."""
    leaves = tree_leaves(tree)
    errs = (tree_leaves(err_tree) if err_tree is not None
            else [None] * len(leaves))
    pairs = [ef_compress(g, e, bits=bits) for g, e in zip(leaves, errs)]
    return (unflatten_like(tree, iter([p[0] for p in pairs])),
            unflatten_like(tree, iter([p[1] for p in pairs])))
