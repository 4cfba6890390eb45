"""What the example entry points share: the device flag, the refusal
of a recording off the card, and the kernels' launch counts."""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
MEASUREMENTS_DIR = os.path.join(REPO_ROOT, "artifacts", "measurements")


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")


def require_card(ap: argparse.ArgumentParser,
                 device: Optional[str]) -> None:
    """Exit through ``ap.error`` unless ``device`` is a CUDA card that is
    there: a recording holds walls timed on the card."""
    import torch
    kind = "cuda" if device is None else torch.device(device).type
    if kind != "cuda":
        ap.error(f"--record times the kernels on a CUDA card; "
                 f"--device {device} is not one")
    if not torch.cuda.is_available():
        ap.error("--record times the kernels on a CUDA card, and CUDA is "
                 "not available here")


def resume_check(ap: argparse.ArgumentParser, path: str,
                 device: Optional[str]) -> Optional[int]:
    """Record mode resumes a recording already at ``path`` (its timed
    points are not timed again), as the JAX package's recorder does;
    refuse one made on another kind of device.  Returns the number of
    points resumed (None for a fresh recording)."""
    if not os.path.exists(path):
        return None
    from ..core.cuda_oracle import MeasurementStore, device_kind_of
    store = MeasurementStore.load(path)
    card = device_kind_of(device)
    if store.device_kind != card:
        ap.error(f"{path} holds walls from {store.device_kind!r}, not "
                 f"this {card!r}; record into another --out-dir")
    return len(store)


def wami_kernel_counters() -> Dict[str, object]:
    """The launch counter of each WAMI stage's kernel, by kernel name."""
    from ..kernels import (wami_change_det, wami_debayer, wami_gradient,
                           wami_grayscale, wami_steep, wami_warp)
    return {"wami_debayer": wami_debayer.debayer_kernel,
            "wami_grayscale": wami_grayscale.grayscale_kernel,
            "wami_gradient": wami_gradient.gradient_kernel,
            "wami_steepest_descent": wami_steep.steepest_descent_kernel,
            "wami_hessian": wami_steep.hessian_kernel,
            "wami_warp": wami_warp.warp_kernel,
            "wami_change_det": wami_change_det.change_det_kernel}


def fleet_kernel_counters() -> Dict[str, object]:
    """The launch counter of each fleet stage's kernel, by kernel name."""
    from ..kernels.flash_attention import flash_attention_kernel
    from ..kernels.ssd_scan import ssd_scan_kernel
    return {"flash_attention": flash_attention_kernel,
            "ssd_scan": ssd_scan_kernel}


def launches_line(counters: Dict[str, object]) -> str:
    """``kernel launches: name=N, ...`` of ``counters``."""
    return "kernel launches: " + ", ".join(
        f"{n}={c.launches}" for n, c in counters.items())


def provenance_line(meta: Dict) -> str:
    """Where a recording's walls came from, as its ``meta`` says."""
    keys = ("device_kind", "power_limit", "smem_budget_bytes",
            "torch_version", "cuda_version")
    return ", ".join(f"{k} {meta[k]}" for k in keys if k in meta)


def stage_lines(store, failed: Dict[str, int], stages) -> list:
    """Per measured stage: the recorded walls (count and range, in us)
    and the infeasible points the drive's ledger counted."""
    walls: Dict[str, list] = {}
    for (comp, _p, _u), w in store.entries.items():
        walls.setdefault(comp, []).append(w)
    lines = []
    for name in stages:
        ws = sorted(walls.get(name, ()))
        rng = (f"{ws[0] * 1e6:.3f}..{ws[-1] * 1e6:.3f} us" if ws
               else "no walls")
        lines.append(f"{name:14s} {len(ws):3d} walls, "
                     f"{failed.get(name, 0):3d} infeasible, {rng}")
    return lines
