"""Seeded weights, drawn on the device by the benchmark itself.

Every leaf of a parameter spec (``reference.ssm_ref.param_spec``) gets
its own generator, seeded from the run's seed and the leaf's index, so
one leaf can be drawn again alone (the training check reads the change
of each leaf from its initial value) and a run draws each leaf in one
call, in the dtype it is served in.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Spec = Dict[str, Tuple[Tuple[int, ...], str, str, float]]


def _leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (1 << 63)


def draw_one(spec: Spec, seed: int, path: str, device) -> torch.Tensor:
    """The leaf ``path`` of ``spec`` as the run with ``seed`` draws it."""
    index = list(spec).index(path)
    shape, dtype, fill, std = spec[path]
    t = torch.empty(shape, dtype=getattr(torch, dtype), device=device)
    if fill == "normal":
        g = torch.Generator(device=device).manual_seed(_leaf_seed(seed, index))
        t.normal_(0.0, std, generator=g)
    elif fill == "zeros":
        t.zero_()
    elif fill == "ones":
        t.fill_(1.0)
    elif fill == "log_linspace":
        n = shape[-1]
        t.copy_(torch.log(torch.linspace(1.0, 16.0, n, device=device))
                .expand(shape))
    else:
        raise ValueError(f"unknown fill {fill!r}")
    return t


def draw(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``spec``, in its dtype, on ``device``."""
    return {path: draw_one(spec, seed, path, device) for path in spec}
