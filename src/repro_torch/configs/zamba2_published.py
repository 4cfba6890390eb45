"""Zamba2-2.7B in its published form [arXiv:2411.15242;
hf:Zyphra/Zamba2-2.7B] — 54 Mamba2 layers, and at nine of them (the
hybrid layers) one of two shared attention + GeGLU blocks, alternating,
over the concatenation [residual, embeddings], with a LoRA adapter on
the shared MLP's gate/up product and an output linear of its own at
each site (transformers' ``models/zamba2/modeling_zamba2.py``).

A port-only configuration beside the JAX package's ten: the port's
``zamba2-2.7b`` keeps the JAX package's form (one shared block on the
residual alone) for parity with it.  The 2.7B's own ``config.json`` is
not in the repository; ``hybrid_layer_ids`` (the 7B's rule cut to 54
layers), the rotary embedding in the shared attention and one B/C
group are assumed from the family's Zamba2-7B row.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

from .base import ModelConfig

__all__ = ["Zamba2Config", "CONFIG"]


@dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """A :class:`ModelConfig` of family ``zamba2``: the shared blocks'
    attention takes ``2 * d_model`` inputs into ``n_heads`` of
    ``head_dim``, scaled by ``1 / sqrt(head_dim / 2)``; ``d_ff`` is the
    GeGLU's width (``mlp_kind`` ``gelu_gated``: the exact GELU of the
    gate times the up product)."""
    num_mem_blocks: int = 2
    adapter_rank: int = 128
    hybrid_layer_ids: Tuple[int, ...] = ()
    norm_eps: float = 1e-5

    def n_sites(self) -> int:
        return len(self.hybrid_layer_ids)

    def param_count(self) -> int:
        """Every parameter of the published form (tied embeddings)."""
        d, di, N = self.d_model, self.d_inner(), self.ssm_state
        H, K, f, r = self.ssm_heads(), self.conv_kernel, self.d_ff, \
            self.adapter_rank
        conv_ch = di + 2 * N
        mamba = (d * (2 * di + 2 * N + H) + (K + 1) * conv_ch + 3 * H
                 + di + di * d + d)
        width, kv = self.n_heads * self.hd(), self.n_kv_heads * self.hd()
        block = (2 * d + 2 * d * (width + 2 * kv) + width * d
                 + d + d * 2 * f + f * d)
        site = d * r + r * 2 * f + d * d
        return int(self.n_layers * mamba + self.num_mem_blocks * block
                   + self.n_sites() * site + self.vocab * d + d)

    def reduced(self) -> "Zamba2Config":
        """The published depth and pattern (54 layers, nine sites, two
        blocks, rank 128) at the smoke widths, full multi-head
        attention."""
        small = super().reduced()
        return replace(small, n_layers=self.n_layers,
                       n_kv_heads=small.n_heads)


CONFIG = Zamba2Config(
    name="zamba2-2.7b-published", family="zamba2",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=160,
    d_ff=10240, vocab=32000, rope_theta=1e4,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    conv_kernel=4, mlp_kind="gelu_gated", norm_kind="rmsnorm",
    tie_embeddings=True,
    num_mem_blocks=2, adapter_rank=128,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53), norm_eps=1e-5,
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B",
)
