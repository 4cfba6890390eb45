"""In-model sharding constraints (the JAX package's ``dist/sharding.py``,
its in-model half).

Model code marks its activations with the ``constrain*`` helpers, as the
JAX package's models do.  Each is the identity unless a mesh is active,
and nothing activates one yet: the rule tables, ``mesh_context`` and
the launch-time specs wait for ROADMAP Queue 1 item 4, beside the dry
run that is their only caller in the JAX package.  So on one card the
helpers return their inputs unchanged, which is what the JAX package's
do outside a ``mesh_context``.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple, Union

__all__ = ["residual_sharding", "constrain", "constrain_residual",
           "constrain_attn_qkv"]

Axis = Union[None, str, Tuple[str, ...]]

# innermost last
_RESIDUAL_STACK: List[Tuple[Axis, ...]] = [("data", None, None)]


@contextlib.contextmanager
def residual_sharding(axes: Tuple[Axis, ...]):
    """Override the residual-activation axes (e.g. ('data', 'model',
    None) for sequence parallelism) within the context."""
    _RESIDUAL_STACK.append(tuple(axes))
    try:
        yield
    finally:
        _RESIDUAL_STACK.pop()


def constrain(x, axes: Sequence[Axis]):
    """``x`` placed on the active mesh by ``axes``: the identity, since
    no mesh is active until ``mesh_context`` is ported (single-device
    runs)."""
    return x


def constrain_residual(x):
    """(B, S, D) residual stream: data-parallel batch (+ optional
    sequence parallelism from ``residual_sharding``)."""
    return constrain(x, _RESIDUAL_STACK[-1])


def constrain_attn_qkv(q, k, v):
    """(B, S, H, hd) attention activations: heads on 'model'."""
    axes = (("pod", "data"), None, "model", None)
    return (constrain(q, axes), constrain(k, axes), constrain(v, axes))
