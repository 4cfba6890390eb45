"""Train-step factory: microbatched, remat-policied, mixed-precision.

``make_train_step`` builds the JAX package's step, eager:

    step(params, opt_state, batch) -> (params, opt_state, metrics)

``params`` is the model's own parameter tree (``model.params()``): the
model holds its parameters, the step takes their gradients with
``torch.autograd.grad`` and the optimizer updates them in place.
Knobs:
  * microbatch gradient accumulation (``microbatches``);
  * remat policy for the layer loop (none/full/dots);
  * fp32 grad accumulation over bf16 compute, optional bf16 accumulation;
  * optional int8 gradient compression (``repro_torch.dist``); as in the
    reference, the compression's error is dropped, not carried to the
    next step.

Metrics stay device tensors: the step never waits for the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from ..dist.compression import ef_compress_tree
from ..dist.sharding import like_placements
from ..optim import (AdamWConfig, apply_updates, apply_updates_q8,
                     warmup_cosine)
from ..utils import tree_leaves, unflatten_like
from .remat import remat_context

__all__ = ["TrainStepConfig", "make_train_step", "make_loss_fn"]


@dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: Optional[str] = "full"          # none | full | dots | dots_no_batch
    accum_dtype: str = "float32"           # float32 | bfloat16
    compress_grads_bits: int = 0           # 0 = off; 8 = int8 error feedback
    quantized_moments: bool = False        # 8-bit AdamW states (1T-scale)
    warmup_steps: int = 100
    total_steps: int = 10000


def _model_leaves(model, params: Any) -> List[torch.Tensor]:
    """The leaves of ``params``, which must be ``model``'s own parameters
    (the tree ``model.params()`` returns)."""
    leaves = tree_leaves(params)
    own = tree_leaves(model.params())
    if len(leaves) != len(own) or any(a is not b
                                      for a, b in zip(leaves, own)):
        raise ValueError("params must be the model's own parameter tree "
                         "(model.params())")
    return leaves


def make_loss_fn(model, remat: Optional[str]):
    """``loss_fn(params, batch) -> (loss, metrics)``: the model's loss
    under the remat policy; ``params`` is ``model.params()``."""
    def loss_fn(params, batch):
        _model_leaves(model, params)
        with remat_context(remat):
            loss, metrics = model.loss(batch)
        return loss, metrics
    return loss_fn


def _split_microbatches(batch: Dict[str, Any], n: int
                        ) -> List[Dict[str, Any]]:
    """``n`` consecutive slices of the batch dim (dim 1 of
    ``mrope_positions``, which is (3, B, S))."""
    out: List[Dict[str, Any]] = [{} for _ in range(n)]
    for k, v in batch.items():
        dim = 1 if k == "mrope_positions" else 0
        B = v.shape[dim]
        if B % n:
            raise ValueError(f"batch {B} not divisible by {n} microbatches")
        for i, part in enumerate(torch.split(v, B // n, dim=dim)):
            out[i][k] = part
    return out


def make_train_step(model, opt_cfg: AdamWConfig,
                    cfg: TrainStepConfig = TrainStepConfig()
                    ) -> Callable:
    """Build the train step for ``model``."""
    loss_fn = make_loss_fn(model, cfg.remat)
    acc_dt = {"float32": torch.float32,
              "bfloat16": torch.bfloat16}[cfg.accum_dtype]

    def grad_fn(leaves, params, batch):
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        # a sharded gradient takes its parameter's placements (the
        # data-parallel all-reduce); the identity on one device
        return (loss.detach(), metrics), [like_placements(g, p)
                                          for g, p in zip(grads, leaves)]

    def step(params, opt_state, batch):
        leaves = _model_leaves(model, params)
        if cfg.microbatches > 1:
            n = cfg.microbatches
            grads = [torch.zeros_like(p, dtype=acc_dt) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for mb in _split_microbatches(batch, n):
                (mb_loss, _), g = grad_fn(leaves, params, mb)
                for a, b in zip(grads, g):
                    a.add_(b.to(acc_dt))
                loss = loss + mb_loss
                del g
            for g in grads:
                g.div_(n)
            loss = loss / n
            metrics: Dict[str, torch.Tensor] = {}
        else:
            (loss, metrics), grads = grad_fn(leaves, params, batch)

        if cfg.compress_grads_bits:
            grads, _ = ef_compress_tree(grads, bits=cfg.compress_grads_bits)

        lr_scale = warmup_cosine(opt_state.step, warmup=cfg.warmup_steps,
                                 total=cfg.total_steps)
        update = apply_updates_q8 if cfg.quantized_moments else apply_updates
        params, opt_state, opt_metrics = update(
            opt_cfg, params, unflatten_like(params, iter(grads)), opt_state,
            lr_scale=lr_scale)
        out = {"loss": loss, **opt_metrics}
        if isinstance(metrics, dict):
            out.update({k: v.detach() for k, v in metrics.items()
                        if torch.is_tensor(v) and v.ndim == 0})
        return params, opt_state, out

    return step
