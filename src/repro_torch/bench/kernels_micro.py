"""Kernel micro-benchmarks — one cell per registered app x backend.

Both cells drive the app's registered ``parity_cases`` (the registry is
the work list: a new app's kernels join by registering):

  * ``analytical`` — the same cases timed down their plain PyTorch
    versions, on ``--device`` (the card unless ``--device cpu``); a
    regression canary for the plain versions;
  * ``cuda`` — every kernel launched on the card through its wrapper at
    (ports 4, unrolls 8), checked against its plain version on the same
    inputs (max |a - b| / max(1, max |b|) <= 1e-4), and both timed with
    CUDA events.  The cell raises on any parity failure.  It needs a
    CUDA device: off the card it is enumerated as skipped, with a
    reason.

Standalone (all apps at once; ``--smoke`` shrinks the tile and exits
non-zero on any parity failure):

    PYTHONPATH=src python -m repro_torch.bench.kernels_micro --smoke --backend cuda
"""

from __future__ import annotations

import time

# every registered app joins both cells through its parity cases: the
# cuda cell checks + times the kernels on the card, the analytical cell
# times the same cases down their plain versions
SCENARIOS = {"apps": "*", "backends": ("analytical", "cuda")}


def cell_skip_reason(app, backend, variant):
    """Bench-specific capability: both kernels cells drive the app's
    registered parity cases (they need no recordings, so the registry's
    check does not apply); the measured cell launches the kernels, so it
    needs a CUDA device."""
    from .scenarios import cuda_host
    if app.parity_cases is None:
        return (f"app {app.name!r} registers no parity cases "
                f"(nothing for the kernels bench to drive)")
    if backend.measured and not cuda_host():
        return ("no CUDA device on this host (the cuda kernels cell "
                "launches every kernel on the card)")
    return None


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_us(fn, *args, dev, reps=5, **kw):
    """Mean microseconds a call of ``fn`` after one warm call: CUDA
    events on the card, the host clock elsewhere."""
    import torch
    fn(*args, **kw)
    _sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args, **kw)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args, **kw)
    return (time.perf_counter() - t0) / reps * 1e6


def _max_err(a, b) -> float:
    fa, fb = a.float(), b.float()
    denom = float(fb.abs().max()) or 1.0
    return float((fa - fb).abs().max()) / max(1.0, denom)


def _registry_parity_cases(tile: int, app=None, device=None):
    """(name, op, plain_fn, args) from registered apps that expose parity
    cases (all of them, or just ``app``), inputs on ``device``."""
    from ..core.registry import list_apps
    cases = []
    for a in list_apps():
        if app is not None and a.name != app:
            continue
        if a.parity_cases is not None:
            cases += list(a.parity_cases(tile, device=device))
    return cases


def run_cuda(report, *, app=None, tile: int = 128, ports: int = 4,
             unrolls: int = 8, reps: int = 3, tol: float = 1e-4,
             device=None) -> int:
    """Launch every registered kernel (every app's, or one app's cell) on
    the card against its plain version.  Returns the number of parity
    failures."""
    from ..utils import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the cuda kernels cell launches the kernels on "
                           f"a CUDA card; device {str(dev)!r} is not one")
    lines = [f"# CUDA kernels ({app or 'all registered apps'}) on the "
             f"card, tile={tile}, ports={ports}, unrolls={unrolls}",
             "kernel,us_per_call_cuda,us_per_call_plain,max_rel_err"]
    failures = 0
    for name, op, plain, args in _registry_parity_cases(tile, app, dev):
        got = op(*args, ports=ports, unrolls=unrolls)
        want = plain(*args)
        err = max(_max_err(g, w) for g, w in
                  zip(got if isinstance(got, tuple) else (got,),
                      want if isinstance(want, tuple) else (want,)))
        if not err <= tol:
            failures += 1
        us = _time_us(op, *args, dev=dev, reps=reps, ports=ports,
                      unrolls=unrolls)
        plain_us = _time_us(plain, *args, dev=dev, reps=reps)
        lines.append(f"{name},{us:.3f},{plain_us:.3f},{err:.2e}")
        report.csv(f"{name}_cuda", us,
                   f"parity={'OK' if err <= tol else 'FAIL'}_{err:.1e}")
    report.write("kernels_micro_cuda", lines)
    return failures


def run_reference(report, *, app: str, tile: int = 128, reps: int = 5,
                  device=None) -> None:
    """The analytical cell: every parity case the app registers, timed
    down its plain version on ``device``."""
    from ..utils import resolve_device
    dev = resolve_device(device)
    lines = [f"# {app} kernels, plain PyTorch versions on {dev.type}, "
             f"tile={tile}",
             "kernel,us_per_call_ref"]
    for name, op, plain, args in _registry_parity_cases(tile, app, dev):
        us = _time_us(plain, *args, dev=dev, reps=reps)
        lines.append(f"{name},{us:.0f}")
        report.csv(f"{name}_ref", us, "plain_reference")
    report.write(f"kernels_micro_{app}", lines)


def run(report, cell, *, device=None) -> None:
    if cell.backend == "cuda":
        failures = run_cuda(report, app=cell.app, device=device)
        if failures:
            raise RuntimeError(f"{failures} {cell.app} CUDA kernel(s) "
                               f"diverged from their plain versions")
        return
    run_reference(report, app=cell.app, device=device)


def main(argv=None) -> int:
    import argparse
    import sys
    from .run import PrintReport
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.kernels_micro")
    ap.add_argument("--backend", choices=["analytical", "cuda"],
                    default="analytical")
    ap.add_argument("--smoke", action="store_true",
                    help="small tile, 1 rep, non-zero exit on any parity "
                         "failure")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.backend == "cuda":
        tile, reps = (32, 1) if args.smoke else (128, 3)
        failures = run_cuda(PrintReport(), tile=tile, ports=2, unrolls=4,
                            reps=reps, device=args.device)
        if args.smoke and failures:
            print(f"kernels-micro-smoke: FAIL — {failures} kernel(s) "
                  f"diverged from their plain versions", file=sys.stderr)
            return 1
        return 0
    from ..core.registry import list_apps
    for app in list_apps():
        if app.parity_cases is not None:
            run_reference(PrintReport(), app=app.name, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
