"""AdamW with decoupled weight decay, fp32 moments, global-norm clipping.

The JAX package's ``optim/adamw.py`` on trees of tensors (nested dicts,
a model's ``params()``).  Moments are kept in float32 regardless of
parameter dtype (mixed-precision training).  ``torch.optim.AdamW`` is
not this optimizer: it keeps its moments in the parameter's dtype and
neither clips by the global norm nor masks the decay by path.

The arithmetic is the reference's, element by element.  Parameters and
moments are updated in place (the tree is returned, so a call reads
like the reference's).  The global-norm clip scale is folded into each
leaf's update and a leaf is updated a block of rows at a time
(``BLOCK_ELEMS``), so no float32 transient is larger than one block: the
clipped float32 gradient tree is never built.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from ..dist.sharding import is_dtensor
from ..utils import leaves_with_paths, tree_leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "init_opt", "apply_updates",
           "global_norm", "clip_by_global_norm", "default_decay_mask"]

# the most elements of a leaf updated at once (rows of its last dim)
BLOCK_ELEMS = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # parameters whose path matches this regex get no weight decay
    no_decay_pattern: str = r"(bias|scale|norm|A_log|D$|dt_bias)"


class OptState(NamedTuple):
    step: torch.Tensor         # () int32
    mu: Any                    # first moments  (fp32 tree)
    nu: Any                    # second moments (fp32 tree)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def step0(params: Any) -> torch.Tensor:
    """A 0-d int32 zero on the parameters' device."""
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)


def init_opt(params: Any) -> OptState:
    """Zero moments of the parameters' shapes (float32, on their
    devices) and step 0."""
    return OptState(step=step0(params), mu=tree_map(_zeros_f32, params),
                    nu=tree_map(_zeros_f32, params))


def rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as (rows, last dim) (a view where ``t`` is contiguous); a
    0-d tensor as (1, 1).  A DTensor stays as it is: reshaping a sharded
    dim would gather it."""
    if is_dtensor(t):
        return t
    return t.reshape(-1, t.shape[-1] if t.ndim else 1)


def row_blocks(t: torch.Tensor) -> Iterator[Any]:
    """Slices of ``rows(t)``'s rows, each at most ``BLOCK_ELEMS``
    elements (one row at least); a DTensor is one block (``...``), each
    rank updating its own shard."""
    if is_dtensor(t):
        return iter((Ellipsis,))
    n_rows, n = rows(t).shape
    per = max(1, BLOCK_ELEMS // max(n, 1))
    return (slice(i, min(i + per, n_rows)) for i in range(0, n_rows, per))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's sum of
    squares in float32."""
    sq = 0
    for x in tree_leaves(tree):
        x2 = rows(x)
        sq = sq + sum(torch.sum(torch.square(x2[b].float()))
                      for b in row_blocks(x))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm ``norm`` to at most
    ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """(grads as float32, scaled to at most ``max_norm`` globally; the
    norm before clipping)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def default_decay_mask(cfg: AdamWConfig, params: Any) -> Any:
    """1.0 for each leaf whose ``'a/b/0'`` path escapes
    ``cfg.no_decay_pattern``, else 0.0, in ``params``' structure."""
    pat = re.compile(cfg.no_decay_pattern)
    masks = [0.0 if pat.search(path) else 1.0
             for path, _ in leaves_with_paths(params)]
    return tree_map(lambda _, w: w, params, masks)


def bias_corrections(cfg: AdamWConfig, step: torch.Tensor):
    """``(1 - b1**step, 1 - b2**step)`` in float32 on the step's
    device."""
    s = step.float()
    return 1.0 - torch.pow(cfg.b1, s), 1.0 - torch.pow(cfg.b2, s)


def _leaves(*trees: Any) -> List[List[Any]]:
    return [tree_leaves(t) for t in trees]


def _require_contiguous(*tensors: torch.Tensor) -> None:
    """The tensors an update writes through ``rows`` views."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"a parameter or optimizer state of shape "
                             f"{tuple(t.shape)} is not contiguous")


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any, state: OptState,
                  lr_scale: torch.Tensor | float = 1.0,
                  decay_mask: Optional[Any] = None
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``grads`` may be any dtype; math runs in fp32 and
    parameters are cast back to their storage dtype.  Updates
    ``params`` and ``state``'s moments in place; returns ``(params, new
    state, {"grad_norm": norm before clipping})``."""
    if decay_mask is None:
        decay_mask = default_decay_mask(cfg, params)
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
    b1c, b2c = bias_corrections(cfg, step)
    lr = cfg.lr * lr_scale

    for p, g, m, v, wd in zip(*_leaves(params, grads, state.mu, state.nu,
                                       decay_mask)):
        _require_contiguous(p, m, v)
        p2, g2, m2, v2 = rows(p), rows(g), rows(m), rows(v)
        for b in row_blocks(p):
            gb = g2[b].float() * scale
            mb = cfg.b1 * m2[b] + (1.0 - cfg.b1) * gb
            vb = cfg.b2 * v2[b] + (1.0 - cfg.b2) * torch.square(gb)
            delta = (mb / b1c) / (torch.sqrt(vb / b2c) + cfg.eps)
            pf = p2[b].float()
            p2[b].copy_(pf - lr * (delta + cfg.weight_decay * wd * pf))
            m2[b].copy_(mb)
            v2[b].copy_(vb)
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm}
