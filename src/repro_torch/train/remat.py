"""Activation-checkpoint (remat) policies, applied at the layer body.

Models wrap their per-layer block with :func:`maybe_remat`; which policy
is active is a context installed by the train step — the models stay
policy-agnostic.  Policies:

  * ``none``  — save everything (prefill/decode, small models);
  * ``full``  — save only layer boundaries (``torch.utils.checkpoint``:
    recompute the whole block in backward);
  * ``dots``  — save matmul outputs, recompute the cheap elementwise
    chain (a selective-checkpoint policy, the counterpart of JAX's
    ``checkpoint_dots``); ``dots_no_batch`` saves only the products
    without a batch dimension (``mm``/``addmm``, not ``bmm``).

Under every policy but ``none``, the re-run of a layer body in backward
runs inside the profiler range ``remat.recompute`` while a
``torch.profiler`` records.  The range wraps the body, not the
checkpoint's recompute context: under a tracing compiler ``checkpoint``
takes only dispatch modes there, and ``full`` keeps its default.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.obs.ranges import device_range

__all__ = ["remat_context", "maybe_remat", "current_policy"]

_ctx = threading.local()

_aten = torch.ops.aten
_SAVED_OPS = {
    "dots": frozenset({_aten.mm.default, _aten.addmm.default,
                       _aten.bmm.default, _aten.baddbmm.default}),
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default}),
}


@contextlib.contextmanager
def remat_context(policy: Optional[str]):
    prev = getattr(_ctx, "policy", None)
    _ctx.policy = policy
    try:
        yield
    finally:
        _ctx.policy = prev


def current_policy() -> Optional[str]:
    return getattr(_ctx, "policy", None)


def _save_ops_policy(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


_RECOMPUTE = device_range("remat.recompute")


def maybe_remat(fn: Callable) -> Callable:
    """Wrap a layer body according to the active policy (identity when
    no policy is installed)."""
    policy = current_policy()
    if policy in (None, "none"):
        return fn
    body = _RECOMPUTE.inside_backward(fn)
    if policy == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    saved = _SAVED_OPS[policy]
    context_fn = functools.partial(
        create_selective_checkpoint_contexts,
        functools.partial(_save_ops_policy, saved))
    return functools.partial(checkpoint, body, use_reentrant=False,
                             context_fn=context_fn)
