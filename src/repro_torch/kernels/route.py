"""Where the LM path's hand-written kernels run, and the count of each
choice.

Four decisions send a model call either to a kernel or to its plain
PyTorch version.  A call decides only where its tensors hold data on the
card (:func:`on_card`); on the CPU, and over a trace's fake tensors (the
dry run's), every call takes the plain version and counts nothing.  On
the card each call counts once, in ``<route>.kernel`` or in
``<route>.plain``:

  * ``ssd`` (``models/ssm.py::_ssd_local``, the Mamba layers' chunked
    SSD): a call with no incoming state takes the kernels
    (``kernels/ssd_scan/grad.py::ssd_train``); a call with an incoming
    state takes the plain body ``_ssd_plain``.  DTensors are scanned
    rank by rank, and each rank's call is routed so.
  * ``gate_norm`` (``models/ssm.py::_gate_norm``, the mixer's epilogue):
    a call that is not a DTensor takes the kernels
    (``kernels/mamba_gate_norm/grad.py::gate_norm``), which raise
    ``ValueError`` before any launch for dtypes and widths they do not
    take, and the call counts nothing; a DTensor takes the plain lines
    ``_gate_norm_plain``.
  * ``conv`` (``models/ssm.py::_conv``, the mixer's depthwise causal conv
    with its bias and SiLU): a call that is not a DTensor takes the
    kernels (``kernels/causal_conv/grad.py::causal_conv``), which raise
    ``ValueError`` before any launch for dtypes and taps they do not
    take, and the call counts nothing; a DTensor takes the plain lines
    ``_causal_conv``.  Decode (``mamba_step``'s rolling window) is not
    routed.
  * ``attention`` (``models/blocks.py::attention_core``): a call its
    caller allows (``fused_ok``: plain positions, no cache), causal,
    bf16, with no window or soft-cap and a head dim of at most 256 takes
    the fused kernel (SDPA's flash or cuDNN backend); every other call
    takes the float32 einsum.

:func:`route_counts` reads the counts and the kernels' launches in one
flat dict; a reader takes the difference of two readings.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import is_fake

from ..core.obs.metrics import MetricsRegistry
from .causal_conv.kernel import causal_conv_bwd_kernel, causal_conv_kernel
from .mamba_gate_norm.kernel import gate_norm_bwd_kernel, gate_norm_kernel
from .ssd_scan.kernel import ssd_scan_bwd_kernel, ssd_scan_kernel

__all__ = ["on_card", "count", "route_counts", "ROUTES"]

# the routes' calls on the card, "<route>.kernel" and "<route>.plain"
ROUTES = MetricsRegistry()
_COUNTERS = {(route, kernel): ROUTES.counter(
                 f"{route}.{'kernel' if kernel else 'plain'}")
             for route in ("ssd", "gate_norm", "conv", "attention")
             for kernel in (True, False)}
# the kernels the routes launch
_KERNELS = {"ssd_scan": ssd_scan_kernel, "ssd_scan_bwd": ssd_scan_bwd_kernel,
            "gate_norm": gate_norm_kernel,
            "gate_norm_bwd": gate_norm_bwd_kernel,
            "causal_conv": causal_conv_kernel,
            "causal_conv_bwd": causal_conv_bwd_kernel}


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` holds data on the card: a trace's fakes hold none."""
    return t.is_cuda and not is_fake(t)


def count(route: str, kernel: bool) -> None:
    """One call of ``route`` on the card, through the kernel or not."""
    _COUNTERS[route, kernel].inc()


def route_counts() -> Dict[str, int]:
    """Every route's ``<route>.kernel`` and ``<route>.plain`` calls and
    each kernel's ``<name>.launches``, since the process started."""
    out = ROUTES.snapshot()
    out.update((f"{name}.launches", k.launches)
               for name, k in _KERNELS.items())
    return out
