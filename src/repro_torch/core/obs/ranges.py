"""Profiler ranges around the LM path's device work.

``device_range(name)`` marks one module of a model so that a
``torch.profiler`` trace credits the kernels of every phase the module
runs in to a ``record_function`` range named ``name``:

  * forward: a range around the call, on the calling thread;
  * backward: a range opened when the gradient of the call's output
    arrives (a hook on the output) and closed once the call has given
    its tensor inputs their gradients (an identity autograd node on the
    inputs that require grad, whose backward runs then).  A hook on the
    inputs themselves would close too late where an input has uses
    outside the call (a stacked parameter's slice is summed with the
    other layers' before its hook runs), and ``autograd.grad`` refuses
    a multi-grad hook a leaf's node.  Autograd runs the hook and the
    node on the thread that launches the backward kernels, so the trace
    puts those kernels inside the range;
  * recompute (the call re-run inside backward by activation
    checkpointing): the plain range, with no hooks, since the
    recomputed graph is never differentiated.

Ranges of one name may nest or overlap (a checkpointed layer's
recompute runs inside the backward range of its own module); a reader
takes their union on each thread.  ``device_range(name).inside_backward``
puts the plain range around a function's calls inside backward alone:
the re-run of a checkpointed layer body in
:func:`repro_torch.train.remat.maybe_remat`.

When no profiler records, a call costs one check of a flag: no range,
no hook, no autograd node.  Values and their order are untouched either
way, so loss and gradients are the same bits with a profiler on and off.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.autograd import profiler as _profiler
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["device_range"]


# Open and close go past any dispatch mode: a selective checkpoint's
# mode counts every op it sees in the forward and in the recompute, and
# the recompute's own range would be one op more than its forward had.
def _enter(name: str) -> Any:
    with torch._C._DisableTorchDispatch():
        return torch.ops.profiler._record_function_enter_new(name, None)


def _exit(handle: Any) -> None:
    with torch._C._DisableTorchDispatch():
        torch.ops.profiler._record_function_exit._RecordFunction(handle)


class _Backward:
    """One call's backward range: opened by the output's gradient, closed
    by :class:`_CloseOnInputs` once the inputs' gradients are computed.
    It opens only where autograd will run the closing node, so that a
    backward pass that needs none of the inputs' gradients leaves no
    range open."""

    def __init__(self, name: str):
        self.name = name
        self.closer = None              # the _CloseOnInputs node
        self.handle = None

    def enter(self, grad) -> None:
        if torch._C._will_engine_execute_node(self.closer):
            self.handle = _enter(self.name)

    def exit(self) -> None:
        if self.handle is not None:
            _exit(self.handle)
            self.handle = None


class _CloseOnInputs(torch.autograd.Function):
    """The identity on a call's inputs; its backward, which runs when
    every gradient the call gives them is summed, closes the call's
    backward range."""

    @staticmethod
    def forward(ctx, rng: _Backward, *xs):
        ctx.rng = rng
        return xs

    @staticmethod
    def backward(ctx, *grads):
        ctx.rng.exit()
        return (None,) + grads


def _plain(name: str, fn: Callable, args, kwargs):
    handle = _enter(name)
    try:
        return fn(*args, **kwargs)
    finally:
        _exit(handle)


def _call_with_backward_range(name: str, fn: Callable, args, kwargs):
    leaves, spec = tree_flatten((args, kwargs))
    hooked = [i for i, t in enumerate(leaves)
              if isinstance(t, torch.Tensor) and t.requires_grad]
    rng = _Backward(name)
    if hooked:
        aliases = _CloseOnInputs.apply(rng, *(leaves[i] for i in hooked))
        rng.closer = aliases[0].grad_fn
        for i, t in zip(hooked, aliases):
            leaves[i] = t
        args, kwargs = tree_unflatten(leaves, spec)
    out = _plain(name, fn, args, kwargs)
    outs = [t for t in tree_flatten(out)[0]
            if isinstance(t, torch.Tensor) and t.requires_grad]
    if hooked and outs:
        torch.autograd.graph.register_multi_grad_hook(outs, rng.enter,
                                                      mode="any")
    return out


class device_range:
    """``@device_range(name)`` on a module's function: the range over its
    forward, recompute and backward (see the module's docstring)."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            if (torch.is_grad_enabled()
                    and torch._C._current_autograd_node() is None):
                return _call_with_backward_range(name, fn, args, kwargs)
            return _plain(name, fn, args, kwargs)
        return call

    def inside_backward(self, fn: Callable) -> Callable:
        """``fn`` with the range around its calls made inside backward
        alone (a checkpointed body's re-run), and around no other."""
        name = self.name

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if (not _profiler._is_profiler_enabled
                    or torch._C._current_autograd_node() is None):
                return fn(*args, **kwargs)
            return _plain(name, fn, args, kwargs)
        return call
