"""The analytic HBM-footprint model of one train step (a copy of the
JAX package's ``core/autotune.py`` pricing half).

``price_train_step`` prices a (config, shape, mesh, microbatches,
remat) point in device-memory bytes per chip, without compiling; the
analytical fleet backend (:class:`~.xlatool.XLATool`) builds on it.  The
budget a plan must fit is the chip table's device memory
(:data:`HBM_BYTES_PER_CHIP`, an H100 SXM's 80 GB).  The JAX package's
``XLAOracle`` and ``choose_train_knobs`` (which confirm a point by
compiling it) come with the LM substrate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from ..configs.base import ModelConfig, ShapeSpec
from .chips import H100_SXM

__all__ = ["MemoryPlan", "price_train_step", "HBM_BYTES_PER_CHIP"]

HBM_BYTES_PER_CHIP = H100_SXM.hbm_bytes


@dataclass(frozen=True)
class MemoryPlan:
    microbatches: int
    remat: str
    accum_dtype: str
    est_bytes: int
    breakdown: Dict[str, float]

    @property
    def fits(self) -> bool:
        return self.est_bytes <= HBM_BYTES_PER_CHIP


def _mesh_sizes(mesh_shape: Dict[str, int]) -> Tuple[int, int]:
    data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    model = mesh_shape.get("model", 1)
    return data, model


def price_train_step(cfg: ModelConfig, shape: ShapeSpec,
                     mesh_shape: Dict[str, int], *, microbatches: int,
                     remat: str, accum_dtype: str = "float32"
                     ) -> MemoryPlan:
    """Analytic HBM footprint of one train step (per device, bytes).

    The napkin model behind the analytical fleet backend; the JAX
    package calibrated it against XLA's ``memory_analysis()``.
    """
    dp, tp = _mesh_sizes(mesh_shape)
    B, S = shape.global_batch, shape.seq_len
    b_loc = max(1, B // dp) / max(1, microbatches)   # tokens rows per mb
    d, L = cfg.d_model, cfg.n_layers
    N = cfg.param_count()
    N_shardable = max(N - cfg.vocab * d, 1)

    # ---- static state ---------------------------------------------------
    params = 2.0 * N / tp                            # bf16, TP-sharded
    grads = (4.0 if accum_dtype == "float32" else 2.0) * N / tp
    opt = 8.0 * N / (tp * dp)                        # fp32 mu+nu, ZeRO-1
    if cfg.family == "moe":
        # experts can shard 2D (model x data)
        params = 2.0 * N / (tp * dp) + 2.0 * cfg.vocab * d / tp
        grads = grads / dp
        opt = 8.0 * N / (tp * dp)

    # ---- residuals (layer boundaries saved by remat='full') ------------
    resid = L * b_loc * S * d * 2.0
    if remat == "none":
        # everything live: roughly x(10-20 tensors)/layer
        resid *= 12.0
    elif remat == "dots":
        resid *= 4.0

    # ---- peak transient inside one layer (recompute included) ----------
    H = max(cfg.n_heads, 1)
    heads_tp = H / tp if H % tp == 0 else 1.0
    if cfg.family in ("ssm", "hybrid"):
        Q = cfg.ssm_chunk
        n_ch = max(1, S // Q)
        hd_heads = cfg.ssm_heads()
        trans = (b_loc * Q * Q * hd_heads * 4.0      # decay matrices
                 + 4 * b_loc * S * cfg.d_inner() * 4.0 / tp) * 1.5
        trans += n_ch * b_loc * Q * Q * hd_heads * 4.0 / 4  # scan residuals
    else:
        kvc = 1024 if S >= 16384 else S
        trans = b_loc * (H / max(heads_tp, 1)) ** 0 * heads_tp * S * kvc * 4.0
        trans += 3 * b_loc * S * max(cfg.d_ff, cfg.expert_ff()) * 2.0 / tp
    if cfg.family == "moe":
        cap = b_loc * S * cfg.top_k * cfg.capacity_factor
        trans += 3 * cap * d * 2.0 / tp + cap * cfg.expert_ff() * 2.0 / tp

    # ---- loss chunk ------------------------------------------------------
    chunk = 512 if cfg.vocab >= 65536 else S
    loss = 2 * b_loc * chunk * cfg.vocab * 4.0 / tp

    # the JAX package's fit against XLA's compiled memory_analysis() on
    # gemma2-9b / qwen2-vl-72b train cells (XLA kept ~2.2x the naive
    # live-set in the layer backward); kept as it is, not refitted for
    # PyTorch on the card
    xla_fudge = 2.2
    total = params + grads + opt + xla_fudge * (resid + trans + loss)
    return MemoryPlan(
        microbatches=microbatches, remat=remat, accum_dtype=accum_dtype,
        est_bytes=int(total),
        breakdown={"params": params, "grads": grads, "opt": opt,
                   "residuals": resid, "transient": trans, "loss": loss})
