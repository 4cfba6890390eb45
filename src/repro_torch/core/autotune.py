"""COSMOS on the training stack: the analytic footprint model as the
synthesis oracle (a copy of the JAX package's ``core/autotune.py``).

``price_train_step`` prices a (config, shape, mesh, microbatches,
remat) point in device-memory bytes per chip, without tracing anything
(the Mnemosyne analogue); the analytical fleet backend
(:class:`~.xlatool.XLATool`) builds on it.  The knobs are

  * ``microbatches``  — the unroll analogue (time/space trade at fixed
    sharding; pow-2);
  * ``remat``         — activation-checkpoint policy (none/dots/full);
  * ``accum_dtype``   — fp32 vs bf16 gradient accumulation.

``choose_train_knobs`` is Algorithm-1-shaped: walk the knob ladder from
cheapest-latency to cheapest-memory and keep the first point whose
PRICED footprint fits the budget, as an :class:`XLAOracle` walk behind
the same ``Oracle``/``OracleLedger`` protocol as the WAMI exploration.
The one confirming run of the mapped rung is
:mod:`repro_torch.launch.dryrun` (a trace of its per-device partition)
and, on the card, that partition run for real.  The budget is the chip
table's device memory (:data:`HBM_BYTES_PER_CHIP`, an H100 SXM's 80 GB;
pass ``XLAOracle(chip=...)`` for another chip).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..configs.base import ModelConfig, ShapeSpec
from .chips import H100_SXM, ChipSpec

__all__ = ["MemoryPlan", "price_train_step", "choose_train_knobs",
           "XLAOracle", "HBM_BYTES_PER_CHIP"]

HBM_BYTES_PER_CHIP = H100_SXM.hbm_bytes


@dataclass(frozen=True)
class MemoryPlan:
    microbatches: int
    remat: str
    accum_dtype: str
    est_bytes: int
    breakdown: Dict[str, float]

    @property
    def fits(self) -> bool:
        return self.est_bytes <= HBM_BYTES_PER_CHIP


def _mesh_sizes(mesh_shape: Dict[str, int]) -> Tuple[int, int]:
    data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    model = mesh_shape.get("model", 1)
    return data, model


def price_train_step(cfg: ModelConfig, shape: ShapeSpec,
                     mesh_shape: Dict[str, int], *, microbatches: int,
                     remat: str, accum_dtype: str = "float32"
                     ) -> MemoryPlan:
    """Analytic HBM footprint of one train step (per device, bytes).

    The napkin model behind the analytical fleet backend; the JAX
    package calibrated it against XLA's ``memory_analysis()``.
    """
    dp, tp = _mesh_sizes(mesh_shape)
    B, S = shape.global_batch, shape.seq_len
    b_loc = max(1, B // dp) / max(1, microbatches)   # tokens rows per mb
    d, L = cfg.d_model, cfg.n_layers
    N = cfg.param_count()
    N_shardable = max(N - cfg.vocab * d, 1)

    # ---- static state ---------------------------------------------------
    params = 2.0 * N / tp                            # bf16, TP-sharded
    grads = (4.0 if accum_dtype == "float32" else 2.0) * N / tp
    opt = 8.0 * N / (tp * dp)                        # fp32 mu+nu, ZeRO-1
    if cfg.family == "moe":
        # experts can shard 2D (model x data)
        params = 2.0 * N / (tp * dp) + 2.0 * cfg.vocab * d / tp
        grads = grads / dp
        opt = 8.0 * N / (tp * dp)

    # ---- residuals (layer boundaries saved by remat='full') ------------
    resid = L * b_loc * S * d * 2.0
    if remat == "none":
        # everything live: roughly x(10-20 tensors)/layer
        resid *= 12.0
    elif remat == "dots":
        resid *= 4.0

    # ---- peak transient inside one layer (recompute included) ----------
    H = max(cfg.n_heads, 1)
    heads_tp = H / tp if H % tp == 0 else 1.0
    if cfg.family in ("ssm", "hybrid"):
        Q = cfg.ssm_chunk
        n_ch = max(1, S // Q)
        hd_heads = cfg.ssm_heads()
        trans = (b_loc * Q * Q * hd_heads * 4.0      # decay matrices
                 + 4 * b_loc * S * cfg.d_inner() * 4.0 / tp) * 1.5
        trans += n_ch * b_loc * Q * Q * hd_heads * 4.0 / 4  # scan residuals
    else:
        kvc = 1024 if S >= 16384 else S
        trans = b_loc * (H / max(heads_tp, 1)) ** 0 * heads_tp * S * kvc * 4.0
        trans += 3 * b_loc * S * max(cfg.d_ff, cfg.expert_ff()) * 2.0 / tp
    if cfg.family == "moe":
        cap = b_loc * S * cfg.top_k * cfg.capacity_factor
        trans += 3 * cap * d * 2.0 / tp + cap * cfg.expert_ff() * 2.0 / tp

    # ---- loss chunk ------------------------------------------------------
    chunk = 512 if cfg.vocab >= 65536 else S
    loss = 2 * b_loc * chunk * cfg.vocab * 4.0 / tp

    # the JAX package's fit against XLA's compiled memory_analysis() on
    # gemma2-9b / qwen2-vl-72b train cells (XLA kept ~2.2x the naive
    # live-set in the layer backward); kept as it is, not refitted for
    # PyTorch on the card
    xla_fudge = 2.2
    total = params + grads + opt + xla_fudge * (resid + trans + loss)
    return MemoryPlan(
        microbatches=microbatches, remat=remat, accum_dtype=accum_dtype,
        est_bytes=int(total),
        breakdown={"params": params, "grads": grads, "opt": opt,
                   "residuals": resid, "transient": trans, "loss": loss})


_LADDER = [
    # fastest -> most memory-frugal (the Algorithm-1 walk)
    dict(microbatches=1, remat="dots"),
    dict(microbatches=1, remat="full"),
    dict(microbatches=2, remat="full"),
    dict(microbatches=4, remat="full"),
    dict(microbatches=8, remat="full"),
    dict(microbatches=16, remat="full"),
    dict(microbatches=32, remat="full"),
    dict(microbatches=64, remat="full"),
]

# relative recompute cost of each remat policy (step-time proxy weights)
_REMAT_FACTOR = {"none": 1.0, "dots": 1.15, "full": 4.0 / 3.0}


def _accum_dtype(cfg: ModelConfig) -> str:
    return "bfloat16" if cfg.param_count() > 30e9 else "float32"


class XLAOracle:
    """The memory planner as a COSMOS oracle over knob-ladder rungs.

    A *component* is one train stage ``(cfg, shape, mesh_shape)``; the
    ``unrolls`` knob indexes the Algorithm-1 ladder (rung 1 = fastest,
    rung ``len(_LADDER)`` = most memory-frugal) and ``ports`` is unused
    (single region).  One evaluation runs the priced memory plan:
    alpha = per-chip device-memory bytes, lambda = a monotone relative
    step-time proxy (recompute factor x microbatch weight-re-read
    overhead) that preserves the ladder's fastest-to-slowest order.
    ``detail["fits"]`` compares with ``chip.hbm_bytes``.  The name is the
    JAX package's, whose oracle confirmed the mapped rung with one XLA
    compile; here :mod:`repro_torch.launch.dryrun` confirms it.
    """

    def __init__(self, stages: Optional[Dict[str, Tuple[ModelConfig,
                                                        ShapeSpec,
                                                        Dict[str, int]]]] = None,
                 *, chip: ChipSpec = H100_SXM):
        self.stages = dict(stages or {})
        self.chip = chip

    def register(self, name: str, cfg: ModelConfig, shape: ShapeSpec,
                 mesh_shape: Dict[str, int]) -> str:
        prev = self.stages.get(name)
        if prev is not None and prev != (cfg, shape, mesh_shape):
            raise ValueError(f"stage {name!r} already registered with a "
                             f"different (cfg, shape, mesh)")
        self.stages[name] = (cfg, shape, mesh_shape)
        return name

    # -- SynthesisTool / Oracle protocol --------------------------------
    def synthesize(self, component: str, *, unrolls: int, ports: int,
                   max_states=None):
        from .knobs import Synthesis
        cfg, shape, mesh_shape = self.stages[component]
        dp, _ = _mesh_sizes(mesh_shape)
        accum = _accum_dtype(cfg)
        if not 1 <= unrolls <= len(_LADDER):
            return Synthesis(lam=float("inf"), area=float("inf"),
                             ports=ports, unrolls=unrolls, feasible=False)
        rung = _LADDER[unrolls - 1]
        mb = rung["microbatches"]
        if shape.global_batch // dp < mb:      # cannot split further
            return Synthesis(lam=float("inf"), area=float("inf"),
                             ports=ports, unrolls=unrolls, feasible=False)
        plan = price_train_step(cfg, shape, mesh_shape, microbatches=mb,
                                remat=rung["remat"], accum_dtype=accum)
        lam = _REMAT_FACTOR[rung["remat"]] + 0.02 * (mb - 1)
        detail = {"est_bytes": float(plan.est_bytes),
                  "microbatches": float(mb),
                  "fits": float(plan.est_bytes <= self.chip.hbm_bytes)}
        detail.update({f"bd_{k}": v for k, v in plan.breakdown.items()})
        return Synthesis(lam=lam, area=float(plan.est_bytes), ports=ports,
                         unrolls=unrolls, states_per_iter=mb, feasible=True,
                         detail=detail)

    #: class-level default, same convention as OracleBatchMixin: tracing
    #: is off unless an instance is handed a real tracer
    tracer = None

    def _tracer(self):
        from .obs import NULL_TRACER
        return self.tracer if self.tracer is not None else NULL_TRACER

    def evaluate(self, request):
        with self._tracer().span("tool.point", component=request.component,
                                 unrolls=request.unrolls,
                                 ports=request.ports):
            return self.synthesize(request.component,
                                   unrolls=request.unrolls,
                                   ports=request.ports,
                                   max_states=request.max_states)

    def evaluate_batch(self, requests, *, workers: Optional[int] = None):
        reqs = list(requests)
        with self._tracer().span("tool.batch", n=len(reqs)):
            return [self.evaluate(r) for r in reqs]   # pricing is cheap

    def cdfg_facts(self, component: str, synth):
        from .knobs import CDFGFacts
        _, shape, _ = self.stages[component]
        return CDFGFacts(gamma_r=1, gamma_w=1,
                         eta=max(1, synth.states_per_iter),
                         trip=shape.global_batch, has_plm_access=False)

    def plan_from_synthesis(self, component: str, synth) -> MemoryPlan:
        """Reconstruct the exact MemoryPlan a feasible synthesis priced."""
        cfg, _, _ = self.stages[component]
        rung = _LADDER[synth.unrolls - 1]
        breakdown = {k[len("bd_"):]: v for k, v in synth.detail.items()
                     if k.startswith("bd_")}
        return MemoryPlan(microbatches=rung["microbatches"],
                          remat=rung["remat"], accum_dtype=_accum_dtype(cfg),
                          est_bytes=int(synth.detail["est_bytes"]),
                          breakdown=breakdown)


def choose_train_knobs(cfg: ModelConfig, shape: ShapeSpec,
                       mesh_shape: Dict[str, int], *,
                       budget: Optional[int] = None,
                       slack: float = 0.90,
                       ledger=None, stage: Optional[str] = None) -> MemoryPlan:
    """Pick the fastest knob setting whose priced footprint fits.

    An :class:`XLAOracle` walk: every reachable ladder rung is priced in
    one ``evaluate_batch`` (rungs are independent) and the fastest rung
    within ``budget * slack`` wins — the characterization half of the
    paper's methodology, with the one confirming run of the mapped rung
    left to :mod:`repro_torch.launch.dryrun`.  ``budget`` defaults to the
    oracle's chip memory.  Pass a shared ``ledger`` (an
    :class:`~.oracle.OracleLedger` over an ``XLAOracle``) to account
    invocations across stages and re-plans: a repeated plan for the same
    stage is a cache hit, not a new pricing.

    Models >30B accumulate gradients in bf16.  Falls back to the most
    frugal reachable rung if nothing fits (the caller reports the deficit
    honestly).
    """
    from .oracle import InvocationRequest, OracleLedger
    if ledger is None:
        ledger = OracleLedger(XLAOracle())
    oracle = ledger.tool
    if not isinstance(oracle, XLAOracle):
        raise TypeError("choose_train_knobs needs a ledger over an XLAOracle")
    if budget is None:
        budget = oracle.chip.hbm_bytes
    name = oracle.register(
        stage or f"{cfg.name}/{shape.name}/{_mesh_key(mesh_shape)}",
        cfg, shape, mesh_shape)

    accum = _accum_dtype(cfg)
    dp, _ = _mesh_sizes(mesh_shape)
    # the reachable prefix of the ladder is known a priori, so it prices
    # as one batch
    rungs = []
    for i, rung in enumerate(_LADDER):
        if shape.global_batch // dp < rung["microbatches"]:
            break
        rungs.append(i + 1)
    if not rungs:
        return price_train_step(cfg, shape, mesh_shape, microbatches=1,
                                remat="full", accum_dtype=accum)
    outs = ledger.evaluate_batch(
        [InvocationRequest(component=name, unrolls=u, ports=1)
         for u in rungs])
    best = None
    for s in outs:
        if not s.feasible:
            continue
        best = s
        if s.detail["est_bytes"] <= budget * slack:
            break
    if best is None:
        return price_train_step(cfg, shape, mesh_shape, microbatches=1,
                                remat="full", accum_dtype=accum)
    return oracle.plan_from_synthesis(name, best)


def _mesh_key(mesh_shape: Dict[str, int]) -> str:
    return "x".join(f"{k}{v}" for k, v in sorted(mesh_shape.items()))
