"""What every driver shares: the files a cell is made of, the program's
configuration held against the configuration file, the traced window
read from the profiler's trace, and the spans that the cell's metric
readers ask to be put around calls into the program while it traces."""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def sync(device=None) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Context:
    """One run of one cell: what it was given and what it recorded."""
    cell: Dict
    config: Dict                    # perfbench/configs/<config>.json
    mix: Dict                       # perfbench/traffic/<traffic>.json
    limits: Dict                    # perfbench/limits/<workload>.json
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float                  # perf_counter at process start
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    records: Dict[str, Any] = field(default_factory=dict)
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    traced: Optional["TraceSummary"] = None
    # "module:attribute" -> range name, from the metric readers' WRAP
    wraps: Dict[str, str] = field(default_factory=dict)

    def judge(self, readings: Dict[str, float]) -> None:
        """Hold each reading that the cell's limits name to its limit."""
        self.checks = {k: (v, self.limits[k]) for k, v in readings.items()
                       if k in self.limits}

    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(v <= lim for v, lim in self.checks.values()))


MODEL_KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab", "rope_theta", "ssm_state",
              "ssm_head_dim", "ssm_expand", "ssm_chunk", "conv_kernel",
              "shared_attn_every", "mlp_kind", "norm_kind",
              "tie_embeddings", "dtype", "param_dtype")


def program_config(config: Dict):
    """The program's configuration of ``config["arch"]``, refused where it
    departs from the configuration file in any key the file states."""
    from repro_torch.configs import get_config
    cfg = get_config(config["arch"])
    diff = {k: (getattr(cfg, k), config[k]) for k in MODEL_KEYS
            if k in config and getattr(cfg, k) != config[k]}
    if diff:
        raise SystemExit(f"the program's {config['arch']} departs from "
                         f"its configuration file: {diff}")
    return cfg


def load_params(model, weights: Dict[str, Any]) -> None:
    """Copy the benchmark's weights into the program's parameters, path
    by path; every path and shape has to match."""
    import torch
    from repro_torch.utils import leaves_with_paths
    own = dict(leaves_with_paths(model.params()))
    if sorted(own) != sorted(weights):
        raise SystemExit(f"parameter paths differ: program "
                         f"{sorted(set(own) ^ set(weights))}")
    with torch.no_grad():
        for path, t in own.items():
            if tuple(t.shape) != tuple(weights[path].shape):
                raise SystemExit(f"{path}: program shape {tuple(t.shape)}, "
                                 f"spec {tuple(weights[path].shape)}")
            t.copy_(weights[path])


# ----------------------------------------------------------------------
# spans around calls into the program (traced runs only)
# ----------------------------------------------------------------------

def reader_wraps(readers) -> Dict[str, str]:
    """The calls that metric readers ask to be wrapped: each reader's
    ``WRAP`` (a "module:attribute" or a tuple of them, the attribute
    dotted for a method) in a ``record_function`` range named by its
    ``SPAN``."""
    out: Dict[str, str] = {}
    for r in readers:
        targets = getattr(r, "WRAP", ())
        for t in ((targets,) if isinstance(targets, str) else targets):
            out[t] = r.SPAN
    return out


@contextlib.contextmanager
def spans_around(wraps: Dict[str, str]):
    """Inside the block, each named call runs inside its profiler range;
    the program's own functions are put back after it."""
    import importlib
    import torch
    undo = []
    for target, span in wraps.items():
        mod, attr = target.split(":")
        owner = importlib.import_module(mod)
        *path, name = attr.split(".")
        for p in path:
            owner = getattr(owner, p)
        fn = getattr(owner, name)

        def wrapped(*args, __fn=fn, __span=span, **kwargs):
            with torch.profiler.record_function(__span):
                return __fn(*args, **kwargs)

        functools.update_wrapper(wrapped, fn)
        undo.append((owner, name, vars(owner).get(name)))
        setattr(owner, name, wrapped)
    try:
        yield
    finally:
        for owner, name, own in reversed(undo):
            if own is None:             # inherited: uncover it again
                delattr(owner, name)
            else:
                setattr(owner, name, own)


# ----------------------------------------------------------------------
# the traced window
# ----------------------------------------------------------------------

@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[List]            # [[name, seconds]] most time first
    idle_gaps: List[List]             # [[host activity, seconds]]
    span_device_s: Dict[str, float]   # device time launched in each range
    span_count: Dict[str, int]        # calls of each range
    kernel_s: float                   # all device operations, summed


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160            # a kernel's name in the breakdown, cut


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List]:
    """Total length of the union, and the gaps between its pieces."""
    total, gaps, end = 0.0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total, gaps


def _merged(ranges: List[Tuple[float, float]]) -> Tuple[List, List]:
    """Sorted disjoint (starts, ends) covering the given ranges."""
    starts, ends = [], []
    for a, b in sorted(ranges):
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def summarize_trace(path: str) -> TraceSummary:
    """Read a Chrome trace that ``torch.profiler`` exported: device busy
    time (the union of device operations), the window (first to last
    event), device time by operation name, idle gaps by the innermost
    host operation running at their middle, and, for every
    ``record_function`` range by name, its calls and the device time of
    the kernels launched inside it (on the launching thread)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    if not dev:
        raise RuntimeError("the trace holds no device operation")
    t_lo = min(e["ts"] for e in events)
    t_hi = max(e["ts"] + e["dur"] for e in events)
    busy_us, gaps = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    # what the host was doing in each idle gap: the shortest host op
    # that covers the gap's middle
    host_sorted = sorted(host, key=lambda e: e["ts"])
    starts = [e["ts"] for e in host_sorted]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for e in host_sorted[max(0, i - 64):i]:
            if e["ts"] + e["dur"] >= mid and (best is None
                                              or e["dur"] < best["dur"]):
                best = e
        key = best["name"] if best else "(no host op)"
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
    # kernels launched inside each range, by correlation id
    corr_dur: Dict[Any, float] = {}
    for e in dev:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            corr_dur[c] = corr_dur.get(c, 0.0) + e["dur"] * 1e-6
    by_range: Dict[Tuple[str, Any], List] = {}
    span_n: Dict[str, int] = {}
    for e in host:
        if e.get("cat") == "user_annotation":
            by_range.setdefault((e["name"], e.get("tid")), []).append(
                (e["ts"], e["ts"] + e["dur"]))
            span_n[e["name"]] = span_n.get(e["name"], 0) + 1
    merged = {k: _merged(v) for k, v in by_range.items()}
    span_s: Dict[str, float] = {name: 0.0 for name in span_n}
    for ev in launches:
        c = ev.get("args", {}).get("correlation")
        if c not in corr_dur:
            continue
        t = ev["ts"]
        for (name, tid), (lo, hi) in merged.items():
            if tid != ev.get("tid"):
                continue
            i = bisect.bisect_right(lo, t) - 1
            if i >= 0 and t <= hi[i]:
                span_s[name] += corr_dur[c]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    short = lambda n: n[:NAME_CHARS]  # noqa: E731
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=(t_hi - t_lo) * 1e-6, busy_s=busy_us * 1e-6,
        device_ops=[[short(k), v] for k, v in top],
        idle_gaps=[[k, v] for k, v in top_idle],
        span_device_s=span_s, span_count=span_n,
        kernel_s=sum(by_name.values()))


@contextlib.contextmanager
def traced(ctx: Context):
    """Profile the block (host and device), with the calls that the
    cell's metric readers name wrapped in their ranges, then read its
    trace into ``ctx.traced``; the exported trace is deleted once read."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    sync(ctx.device)
    with spans_around(ctx.wraps), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    record_shapes=False, with_stack=False) as prof:
        yield
        sync(ctx.device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        ctx.traced = summarize_trace(path)
    finally:
        os.remove(path)
