"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload mamba2-780m.train-2k --seed 7 \\
        --seconds 51 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<traffic>.json``); the mix names its driver
(``perfbench/drivers/<driver>.py``) and generator; each metric is read
by ``perfbench/metrics/<metric>.py``, which may name a call of the
program to be wrapped in a range of its own while the run traces; the
limits of the correctness check are ``perfbench/limits/<workload>.json``.  With ``--trace 0`` the
line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the traced window.  The last line of standard
output is the JSON result; the numbers compared for ``correct`` close
standard error and the result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; keep
    libraries from loading JAX."""
    cache = os.path.join(ROOT, "build", "perfbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metric_names(bench: dict, cell: dict, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    metrics: those that list it, or that list no cells."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m["name"] for m in group
            if cell["name"] in m.get("workloads", [cell["name"]])]


def load_metric(name: str):
    """The reader ``perfbench/metrics/<name>.py`` (a name may hold dots)."""
    import importlib.util
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, config_override=None, mix_override=None,
             t_start: float = None):
    """Drive one run of the cell ``name``; returns (Context, metrics).
    ``device``, ``config_override`` and ``mix_override`` serve the
    harness's own tests (a reduced configuration on the CPU)."""
    import torch
    from perfbench.common import Context, load_json, reader_wraps
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = find_cell(bench, name)
    config = load_json(os.path.join(HERE, "configs", cell["config"] + ".json"))
    mix = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", name + ".json"))
    config = config_override(config) if config_override else config
    mix = mix_override(mix) if mix_override else mix
    ctx = Context(cell=cell, config=config, mix=mix, limits=limits,
                  seed=seed, seconds=seconds, trace=trace,
                  device=torch.device(device or "cuda"),
                  t_start=T_START if t_start is None else t_start)
    readers = {m: load_metric(m) for m in metric_names(bench, cell, trace)}
    ctx.wraps = reader_wraps(readers.values())
    driver = importlib.import_module(f"perfbench.drivers.{mix['driver']}")
    driver.run(ctx)
    metrics = {}
    for m, reader in readers.items():
        value = reader.read(ctx)
        if value is not None:
            metrics[m] = {"value": value, "unit": reader.UNIT}
    return ctx, metrics


def result_line(ctx, metrics: dict, chips: int) -> dict:
    import torch
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": chips, "memory_peak_bytes": int(ctx.memory_peak)}
    out = {"correct": ctx.correct(), "attempted": ctx.attempted,
           "failed": ctx.failed, "metrics": metrics, "device": device}
    if ctx.trace and ctx.traced is not None:
        device["busy_s"] = ctx.traced.busy_s
        device["window_s"] = ctx.traced.window_s
        out["breakdown"] = {"device_ops": ctx.traced.device_ops,
                            "idle_gaps": ctx.traced.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in ctx.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _environment()
    import torch
    from perfbench.common import load_json
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = int(find_cell(bench, a.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found", file=sys.stderr)
        return 2
    ctx, metrics = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    line = result_line(ctx, metrics, chips)
    print(f"perfbench: set-up {ctx.setup_s:.2f} s, reference "
          f"{ctx.records.get('reference_s', 0.0):.2f} s, whole run "
          f"{time.perf_counter() - T_START:.2f} s", file=sys.stderr)
    for k, v in ctx.records.get("readings", {}).items():
        if k not in line["checks"] and "[" not in k:
            print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    _environment()
    sys.exit(main())
