"""Multi-pod dry run: trace every (arch x shape x mesh) cell's per-device
program (the JAX package's ``launch/dryrun.py``).

For each cell this builds the production mesh on a fake process group
(:mod:`.mesh`), shards the parameters, optimizer state and inputs by the
rule tables (:mod:`..dist.sharding`), and traces rank 0's train step,
prefill or decode with ``make_fx`` over fake tensors (no allocation):
the counterpart of lowering against ``ShapeDtypeStruct`` stand-ins and
compiling.  DTensor turns the sharded program into rank 0's local ops
and ``_c10d_functional`` collectives, which :mod:`.graph_analysis` reads:

  * ``memory``       — argument, output and peak temporary bytes per
    device (the counterpart of ``memory_analysis()``);
  * ``cost``         — per-device FLOPs and bytes;
  * ``collectives``  — ring-model bytes by kind;
  * ``roofline``     — the three terms on the chip table (an H100 SXM).

The record has the reference's keys: ``lower_s`` is the trace,
``compile_s`` the graph analysis, ``generated_code_bytes`` 0.  Records
land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``, which
:mod:`.roofline` reads.  The trace runs on the card unless the caller
asks for the CPU (``--device cpu``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
        --mesh pod --auto [--device cpu]
    python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import SHAPES, get_config, get_shape, list_archs
from ..configs.base import ModelConfig, ShapeSpec
from ..core.autotune import choose_train_knobs
from ..dist.sharding import (PartitionSpec, batch_spec, cache_spec, lm_rules,
                             mesh_context, mesh_shape, placements,
                             residual_sharding, zero1_spec)
from ..models import (build_model, decode_specs, prefill_specs,
                      train_batch_specs)
from ..optim import (AdamWConfig, OptState, QuantOptState, init_opt,
                     init_opt_q8)
from ..train import TrainStepConfig, make_train_step
from ..utils import resolve_device, tree_leaves, tree_map
from .graph_analysis import analyze_graph, memory_terms, roofline_terms
from .mesh import make_production_mesh

__all__ = ["run_cell", "cell_program", "trace_cell", "run_partition",
           "local_shape", "main", "ARTIFACTS"]

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")

MESH_SHAPES = {"pod": {"data": 16, "model": 16},
               "multipod": {"pod": 2, "data": 16, "model": 16}}


def local_shape(shape: Tuple[int, ...], spec: PartitionSpec,
                mesh: Any) -> Tuple[int, ...]:
    """Rank 0's shard shape of a tensor of ``shape`` laid out by
    ``spec`` (the rules only shard dims that divide)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, ax in enumerate(spec):
        for name in ((ax,) if isinstance(ax, str) else ax or ()):
            out[d] //= sizes[name]
    return tuple(out)


def _opt_shardings(ospecs: OptState, p_spec: Any, mesh: Any) -> OptState:
    """ZeRO-1: each moment keeps its parameter's spec and shards its
    first still-replicated, divisible dim over the data axes."""
    def leaf(sp, m):
        return zero1_spec(sp, tuple(m.shape), mesh)
    return OptState(step=PartitionSpec(),
                    mu=tree_map(leaf, p_spec, ospecs.mu),
                    nu=tree_map(leaf, p_spec, ospecs.nu))


def _q8_opt_shardings(ospecs: QuantOptState, p_spec: Any, mesh: Any
                      ) -> QuantOptState:
    """Quantized moments inherit the parameter spec (int8 tensors are
    param-shaped); row scales drop the trailing dim of the spec."""
    def s_leaf(sp, x):
        return PartitionSpec(*list(sp)[: max(0, len(x.shape))])
    return QuantOptState(step=PartitionSpec(), mu_q=p_spec,
                         mu_s=tree_map(s_leaf, p_spec, ospecs.mu_s),
                         nu_q=p_spec,
                         nu_s=tree_map(s_leaf, p_spec, ospecs.nu_s))


def _dtensor(local: torch.Tensor, meta: torch.Tensor, spec: PartitionSpec,
             mesh: Any):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=meta.shape,
                              stride=meta.stride())


def _locals(metas: Any, specs: Any, mesh: Any,
            make: Callable[[Tuple[int, ...], torch.dtype], torch.Tensor]
            ) -> Any:
    """Rank 0's shard of every tensor leaf (``make(shape, dtype)``);
    other leaves (a cache's length) as they are."""
    return tree_map(lambda m, sp: (make(local_shape(tuple(m.shape), sp,
                                                    mesh), m.dtype)
                                   if isinstance(m, torch.Tensor) else m),
                    metas, specs)


def _wrap(local: Any, metas: Any, specs: Any, mesh: Any) -> Any:
    return tree_map(lambda l, m, sp: (_dtensor(l, m, sp, mesh)
                                      if isinstance(m, torch.Tensor) else l),
                    local, metas, specs)


def _unwrap(tree: Any) -> Any:
    return tree_map(lambda t: t.to_local() if hasattr(t, "to_local") else t,
                    tree)


def cell_program(cfg: ModelConfig, shape: ShapeSpec, mesh: Any, *,
                 microbatches: int = 1, remat: str = "full",
                 accum_dtype: str = "float32", q8_moments: bool = False,
                 seq_parallel: bool = False
                 ) -> Tuple[Callable, Any, Any]:
    """Rank 0's program of a cell: ``(fn, metas, specs)``, where
    ``fn(*locals)`` takes the local shards of the ``metas`` trees (meta
    tensors of the global shapes) laid out by ``specs`` and returns its
    outputs' local tensors.  Train: ``(params, opt, batch)`` ->
    ``(params, opt, metrics)``; prefill: ``(params, batch)`` ->
    ``(logits, cache)``; decode: ``(params, tokens, cache)`` ->
    ``(logits, cache)``."""
    from torch.distributed.tensor.experimental import implicit_replication
    model = build_model(cfg, "meta")
    two_d = cfg.family == "moe" and cfg.param_count() > 2e11
    rules = lm_rules(cfg.family, two_d_experts=two_d)
    pspecs = model.params()
    p_spec = rules.tree(pspecs, mesh)
    if shape.kind == "train":
        ospecs = init_opt_q8(pspecs) if q8_moments else init_opt(pspecs)
        o_spec = (_q8_opt_shardings(ospecs, p_spec, mesh) if q8_moments
                  else _opt_shardings(ospecs, p_spec, mesh))
        bspecs = train_batch_specs(cfg, shape)
        metas = (pspecs, ospecs, bspecs)
        specs = (p_spec, o_spec, batch_spec(bspecs, mesh))
        step = make_train_step(
            model, AdamWConfig(),
            TrainStepConfig(microbatches=microbatches, remat=remat,
                            accum_dtype=accum_dtype,
                            quantized_moments=q8_moments))

        def body(params, opt, batch):
            return step(model.params(), opt, batch)
    elif shape.kind == "prefill":
        bspecs = prefill_specs(cfg, shape)
        metas = (pspecs, bspecs)
        specs = (p_spec, batch_spec(bspecs, mesh))
        # the prompt's cache, allocated as rank 0's shards by the
        # launch-time cache rule
        cache_meta = model.init_cache(shape.global_batch, shape.seq_len)
        c_spec = cache_spec(cache_meta, mesh)

        def sharded_cache(batch: int, max_len: int):
            dev = model.device
            return _wrap(_locals(cache_meta, c_spec, mesh,
                                 lambda s, dt: torch.zeros(s, dtype=dt,
                                                           device=dev)),
                         cache_meta, c_spec, mesh)

        def body(params, batch):
            model.init_cache = sharded_cache
            return model.prefill(batch)
    else:
        tok, cache = decode_specs(cfg, shape)
        metas = (pspecs, tok, cache)
        specs = (p_spec, batch_spec({"tokens": tok}, mesh)["tokens"],
                 cache_spec(cache, mesh,
                            seq_shard=(shape.global_batch == 1)))

        def body(params, tokens, cache):
            return model.decode_step(tokens, cache)

    def fn(*local):
        res = (residual_sharding(("data", "model", None)) if seq_parallel
               else contextlib.nullcontext())
        with mesh_context(mesh), res, implicit_replication():
            args = [_wrap(l, m, sp, mesh)
                    for l, m, sp in zip(local, metas, specs)]
            params = tree_map(lambda t: t.detach().requires_grad_(
                t.is_floating_point() and shape.kind == "train"), args[0])
            model._set_tree(params)
            return _unwrap(body(model.params(), *args[1:]))

    return fn, metas, specs


def trace_cell(fn: Callable, metas: Any, specs: Any, mesh: Any, device
               ) -> torch.fx.GraphModule:
    """``make_fx`` of ``fn`` over fake local shards on ``device``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    with FakeTensorMode():
        local = [_locals(m, sp, mesh,
                         lambda s, dt: torch.empty(s, dtype=dt,
                                                   device=device))
                 for m, sp in zip(metas, specs)]
        return make_fx(fn)(*local)


def run_partition(cfg: ModelConfig, shape: ShapeSpec, mesh: Any, *,
                  steps: int = 2, warmup: int = 1, seed: int = 0,
                  **knobs) -> Dict[str, Any]:
    """Run rank 0's partition of a train cell for real, eagerly, on the
    mesh's device: the same shardings as the trace, with real local
    tensors (parameters drawn from ``seed``, zero moments, random
    tokens).  The mesh's group is fake, so its collectives move no data
    and the loss is not a number to check; the footprint and the local
    kernels are real.  Returns the device ms of each timed step and
    ``max_memory_allocated`` over the run."""
    if shape.kind != "train":
        raise ValueError("run_partition runs train cells")
    fn, metas, specs = cell_program(cfg, shape, mesh, **knobs)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()
                       if mesh.device_type == "cuda" else None)
    g = torch.Generator(device=dev).manual_seed(seed)

    def make(kind):
        def leaf(s, dt):
            if kind == "params" and dt.is_floating_point:
                return (torch.randn(s, generator=g, device=dev) * 0.02).to(dt)
            if kind == "batch" and not dt.is_floating_point:
                return torch.randint(0, cfg.vocab, s, generator=g,
                                     device=dev, dtype=dt)
            if kind == "batch":
                return torch.ones(s, dtype=dt, device=dev)
            return torch.zeros(s, dtype=dt, device=dev)
        return leaf

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    local = [_locals(m, sp, mesh, make(kind)) for m, sp, kind
             in zip(metas, specs, ("params", "opt", "batch"))]
    times = []
    for i in range(warmup + steps):
        t0, t1 = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        t0.record()
        out = fn(*local)
        t1.record()
        torch.cuda.synchronize(dev)
        if i >= warmup:
            times.append(t0.elapsed_time(t1))
        del out
    return {"step_ms": times,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "local_input_bytes": sum(t.numel() * t.element_size()
                                     for t in tree_leaves(local)
                                     if isinstance(t, torch.Tensor))}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             microbatches: int = 1, remat: str = "full",
             accum_dtype: str = "float32", auto: bool = False,
             q8_moments: bool = False, seq_parallel: bool = False,
             out_dir: Optional[str] = None, verbose: bool = True,
             extra_tag: str = "", device=None,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeSpec] = None,
             mesh: Any = None) -> Dict[str, Any]:
    """Trace one cell and analyse its graph; returns (and persists) the
    record.  ``cfg``, ``shape`` and ``mesh`` override the arch's config,
    the named shape and the production mesh (reduced runs, tests)."""
    dev = resolve_device(device)
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    mesh_sizes = (mesh_shape(mesh) if mesh is not None
                  else MESH_SHAPES[mesh_kind])
    plan = None
    if auto and shape.kind == "train":
        plan = choose_train_knobs(cfg, shape, mesh_sizes)
        microbatches, remat = plan.microbatches, plan.remat
        accum_dtype = plan.accum_dtype
    ok, why = shape.applicable(cfg)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind, "microbatches": microbatches, "remat": remat,
        "accum_dtype": accum_dtype, "q8_moments": q8_moments,
        "seq_parallel": seq_parallel,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if plan is not None:
        record["planned_bytes"] = plan.est_bytes
        record["plan_breakdown"] = {k: round(v / 1e9, 3)
                                    for k, v in plan.breakdown.items()}
    if not ok:
        record["status"] = "skip"
        record["skip_reason"] = why
        _persist(record, out_dir, extra_tag)
        return record

    t0 = time.time()
    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                        device=dev)
        fn, metas, specs = cell_program(
            cfg, shape, mesh, microbatches=microbatches, remat=remat,
            accum_dtype=accum_dtype, q8_moments=q8_moments,
            seq_parallel=seq_parallel)
        gm = trace_cell(fn, metas, specs, mesh, dev)
        t_lower = time.time() - t0
        mc = analyze_graph(gm)
        mem = memory_terms(gm)
        t_compile = time.time() - t0 - t_lower
        coll = mc.collectives
        n_dev = mesh.size()
        terms = roofline_terms(flops_per_device=mc.flops,
                               bytes_per_device=mc.bytes,
                               collective_bytes=coll.modeled_bytes)
        record.update({
            "status": "ok",
            "devices": n_dev,
            "lower_s": round(t_lower, 2),
            "compile_s": round(t_compile, 2),
            "memory": dict(mem, generated_code_bytes=0),
            "cost": {"flops_per_device": mc.flops,
                     "bytes_per_device": mc.bytes,
                     # the traced graph is the whole program (no loop is
                     # counted once), so the raw counts are the same
                     "xla_cost_flops_raw": mc.flops,
                     "xla_cost_bytes_raw": mc.bytes},
            "collectives": {
                "modeled_bytes_per_device": coll.modeled_bytes,
                "raw_result_bytes": coll.raw_result_bytes,
                "per_op": coll.per_op,
                "per_op_count": coll.per_op_count,
            },
            "roofline": terms,
        })
        if verbose:
            m = record["memory"]
            print(f"[ok] {arch} x {shape_name} x {mesh_kind} "
                  f"({n_dev} dev): trace {t_lower:.1f}s, "
                  f"args {m['argument_bytes'] / 1e9:.2f} GB/dev, "
                  f"temp {m['temp_bytes'] / 1e9:.2f} GB/dev, "
                  f"bound={terms['bound']}")
    except Exception as e:  # noqa: BLE001 - record the failure, keep going
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[ERR] {arch} x {shape_name} x {mesh_kind}: "
                  f"{record['error'][:200]}")
    _persist(record, out_dir, extra_tag)
    return record


def _persist(record: Dict[str, Any], out_dir: Optional[str], tag: str = ""):
    out_dir = out_dir or ARTIFACTS
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fn = (f"{record['arch']}__{record['shape']}__{record['mesh']}"
          f"{suffix}.json")
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--auto", action="store_true",
                    help="pick microbatches/remat via core.autotune")
    ap.add_argument("--q8-moments", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--accum-dtype", default="float32")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the trace (default: the CUDA card)")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all or not args.shape \
        else [args.shape]

    n_ok = n_skip = n_err = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                if args.skip_existing:
                    fn = os.path.join(args.out or ARTIFACTS,
                                      f"{arch}__{shape}__{mesh_kind}.json")
                    if os.path.exists(fn):
                        with open(fn) as f:
                            if json.load(f).get("status") == "ok":
                                continue
                rec = run_cell(arch, shape, mesh_kind,
                               microbatches=args.microbatches,
                               remat=args.remat, auto=args.auto,
                               accum_dtype=args.accum_dtype,
                               q8_moments=args.q8_moments,
                               seq_parallel=args.seq_parallel,
                               out_dir=args.out,
                               extra_tag=args.tag, device=args.device)
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skip"
                n_err += st == "error"
    print(f"dry-run complete: {n_ok} ok, {n_skip} skip, {n_err} error")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
