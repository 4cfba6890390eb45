"""Model configuration schema (a copy of the JAX package's
``configs/base.py``).

One :class:`ModelConfig` describes any member of the zoo: dense decoder
LMs, MoE LMs, SSM (Mamba2), hybrid (Zamba2), encoder-decoder (Whisper)
and VLM backbones.  Family-specific fields are simply unused by other
families.  ``reduced()`` derives the CPU-smoke-test variant of a config.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES"]


@dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec
    # transformer core ---------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 0
    # attention flavour --------------------------------------------------
    rope_theta: float = 1e6
    qkv_bias: bool = False          # qwen2
    attn_softcap: float = 0.0       # gemma2: 50.0
    logit_softcap: float = 0.0      # gemma2: 30.0
    sliding_window: int = 0         # gemma2 local layers: 4096
    local_global_alternate: bool = False   # gemma2: even layers local
    post_norms: bool = False        # gemma2 sandwich norms
    mrope: bool = False             # qwen2-vl M-RoPE (3D positions)
    # MLP flavour ---------------------------------------------------------
    mlp_kind: str = "silu_gated"    # silu_gated | gelu | sq_relu
    norm_kind: str = "rmsnorm"      # rmsnorm | layernorm
    tie_embeddings: bool = False
    # MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0       # kimi-k2: 1 shared expert
    moe_d_ff: int = 0               # per-expert FF width (0 -> d_ff)
    first_dense_layers: int = 0     # kimi-k2: first layer dense
    # SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # hybrid (zamba2) ------------------------------------------------------
    shared_attn_every: int = 0      # one shared attention block every N
    # encoder-decoder (whisper) --------------------------------------------
    n_encoder_layers: int = 0
    encoder_frames: int = 1500      # stub conv frontend output length
    # numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # notes ------------------------------------------------------------------
    source: str = ""

    # ---------------------------------------------------------------
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def ssm_heads(self) -> int:
        return self.d_inner() // self.ssm_head_dim

    def sub_quadratic(self) -> bool:
        """True when 500k-token decode is admissible (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    def has_decoder(self) -> bool:
        return True   # all assigned archs decode (whisper via its decoder)

    # ---------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameters (for MODEL_FLOPS and the docs)."""
        d, hd = self.d_model, self.hd()
        if self.family in ("dense", "moe", "encdec"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        else:
            attn = 0
        per_layer = 0
        if self.family in ("dense", "encdec"):
            mlp = d * self.d_ff * (3 if self.mlp_kind == "silu_gated" else 2)
            per_layer = attn + mlp + 2 * d
        elif self.family == "moe":
            moe = (d * self.n_experts * 1                       # router
                   + self.n_experts * d * self.expert_ff() * 3
                   + self.n_shared_experts * d * self.expert_ff() * 3)
            per_layer = attn + moe + 2 * d
        elif self.family in ("ssm", "hybrid"):
            di, N, H = self.d_inner(), self.ssm_state, self.ssm_heads()
            groups = 1
            ssm = (d * (2 * di + 2 * groups * N + H)            # in_proj
                   + self.conv_kernel * (di + 2 * groups * N)   # conv
                   + di * d + 2 * H + di)                       # out_proj, A/D, norm
            per_layer = ssm + 2 * d
        total = self.n_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            shared_attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                           + self.n_heads * hd * d
                           + d * self.d_ff * 3 + 4 * d)
            total += shared_attn
        if self.family == "encdec":
            # decoder self+cross attention + mlp
            dec = self.n_layers * (2 * attn + d * self.d_ff * 2 + 3 * d)
            enc = self.n_encoder_layers * (attn + d * self.d_ff * 2 + 2 * d)
            total = enc + dec
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        cfg_dense = replace(self, n_experts=0, family="dense",
                            d_ff=self.expert_ff())
        attn_part = cfg_dense.param_count() - self.vocab * d * (1 if self.tie_embeddings else 2) \
            - self.n_layers * cfg_dense.d_ff * d * 3
        active_moe = self.n_layers * (
            d * self.n_experts
            + (self.top_k + self.n_shared_experts) * d * self.expert_ff() * 3)
        return int(attn_part + active_moe
                   + self.vocab * d * (1 if self.tie_embeddings else 2))

    # ---------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """A smoke-test-sized config of the same family (small layers,
        few experts, tiny vocab), runnable on CPU in seconds."""
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4) or 2,
            d_model=64,
            n_heads=min(self.n_heads, 4) or 4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16 if self.head_dim else 0,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=32,
            shared_attn_every=min(self.shared_attn_every, 2),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_frames=32 if self.n_encoder_layers else 1500,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            dtype="float32", param_dtype="float32",
        )


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    def applicable(self, cfg: ModelConfig) -> Tuple[bool, str]:
        if self.name == "long_500k" and not cfg.sub_quadratic():
            return False, ("full-attention architecture: 524288-token decode "
                           "requires sub-quadratic attention (DESIGN.md §4)")
        return True, ""


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", seq_len=4096, global_batch=256, kind="train"),
    ShapeSpec("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    ShapeSpec("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    ShapeSpec("long_500k", seq_len=524288, global_batch=1, kind="decode"),
)
