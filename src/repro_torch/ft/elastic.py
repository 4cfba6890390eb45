"""Elastic scaling: re-plan the mesh after node loss / fleet resize.

COSMOS's compositional argument applies directly (DESIGN.md §2): the
per-component characterization (regions over TP degree x microbatch) is
a property of the MODEL, not of the fleet — so on a mesh change only the
LP (milliseconds) and the mapped compiles (a handful) re-run, not the
characterization sweep.  ``replan`` returns the new mesh shape plus which
knob re-mapping is required, for the launcher's COSMOS re-mapping of
the knobs.

Policy: keep the model axis as large as the surviving chip count allows
(TP degree is a memory-fit constraint), give the remainder to data.
Both axes stay powers of two (the paper's port constraint, for the same
bank-selection reason).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = ["ElasticPlan", "replan", "largest_pow2_leq"]


def largest_pow2_leq(n: int) -> int:
    if n < 1:
        return 0
    return 1 << (n.bit_length() - 1)


@dataclass(frozen=True)
class ElasticPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    usable_devices: int
    dropped_devices: int
    batch_scale: float            # global batch multiplier (DP shrink)
    needs_resharding: bool        # TP degree changed -> params reshard
    note: str = ""


def replan(old_shape: Tuple[int, ...], axis_names: Tuple[str, ...],
           surviving_devices: int, *, min_model: int = 1,
           keep_model_axis: bool = True) -> ElasticPlan:
    """Compute the new mesh after failures leave ``surviving_devices``."""
    old_total = 1
    for s in old_shape:
        old_total *= s
    usable = largest_pow2_leq(surviving_devices)
    if usable < 1:
        raise ValueError("no usable devices")
    shape = dict(zip(axis_names, old_shape))
    model = shape.get("model", 1)
    if keep_model_axis and usable >= model:
        new_model = model
    else:
        new_model = max(min_model, largest_pow2_leq(usable))
    rest = usable // new_model
    if "pod" in shape and shape["pod"] > 1 and rest >= shape["pod"]:
        new_pod = shape["pod"]
        new_data = rest // new_pod
    else:
        new_pod = 1
        new_data = rest
    if "pod" in shape:
        new_shape = (new_pod, new_data, new_model)
    else:
        new_shape = (new_data, new_model)
    new_total = usable
    return ElasticPlan(
        old_shape=tuple(old_shape), new_shape=new_shape,
        axis_names=tuple(axis_names), usable_devices=usable,
        dropped_devices=old_total - surviving_devices,
        batch_scale=new_total / old_total * (model / new_model),
        needs_resharding=(new_model != model),
        note=("TP kept; DP shrinks, global batch scales" if new_model == model
              else "TP degree changed; COSMOS re-maps knobs, params reshard"))
