"""XLATool: the COSMOS SynthesisTool over an analytic fleet cost model.

A *component* is one stage of a multi-model ML system (actor/learner
fleets, draft/target serving, teacher/student pipelines), and the knobs
map onto the paper's exactly:

    ports   -> the stage's FLEET SHARE: chips = 64 * 2^(ports-1)
               (pow-2, the paper's port rule) — resource replication:
               more chips => lower effective latency, more total device
               memory claimed (the paper's area);
    unrolls -> inverse microbatching: microbatches = 2^(max-unrolls),
               so higher unrolls => fewer weight re-reads => faster but
               more memory per chip — the Amdahl-shaped lambda(u) the
               mapping function phi assumes.

One "synthesis" prices the configuration with the analytic footprint
model of :mod:`.autotune`: lambda = roofline step time, alpha = total
device-memory bytes claimed across the stage's chips.  The chip's peak,
memory bandwidth, link bandwidth and memory size come from one
:class:`~.chips.ChipSpec` (default: an H100 SXM); the mesh rule (64
chips at ports 1, tensor parallelism 16, the microbatch ladder) is the
JAX package's, unchanged.  The name is the JAX package's, where the
same model priced TPU slices for XLA.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..configs.base import ModelConfig, ShapeSpec
from .autotune import price_train_step
from .chips import H100_SXM, ChipSpec
from .knobs import CDFGFacts, Synthesis
from .oracle import OracleBatchMixin

__all__ = ["XLATool", "BASE_CHIPS", "MAX_UNROLL"]

BASE_CHIPS = 64          # ports=1 fleet share
MAX_UNROLL = 6           # unrolls=6 -> microbatches=1


class XLATool(OracleBatchMixin):
    """SynthesisTool whose components are (ModelConfig, ShapeSpec) stages.

    Adapts directly to the batched ``Oracle`` protocol via
    :class:`~.oracle.OracleBatchMixin` — pricing is pure, so independent
    fleet-share/microbatch points fan out concurrently.  ``chip`` is the
    chip table; ``hbm_budget`` (default: the chip's memory) is the
    per-chip footprint above which a point fails synthesis.
    """

    def __init__(self, components: Dict[str, tuple], *, tp: int = 16,
                 chip: ChipSpec = H100_SXM,
                 hbm_budget: Optional[int] = None):
        self.components = dict(components)
        self.tp = tp
        self.chip = chip
        self.hbm_budget = chip.hbm_bytes if hbm_budget is None else hbm_budget

    def _chips(self, ports: int) -> int:
        return BASE_CHIPS * (1 << max(0, ports - 1))

    def _microbatches(self, unrolls: int) -> int:
        return 1 << max(0, MAX_UNROLL - unrolls)

    def mesh_for(self, ports: int) -> "tuple[int, Dict[str, int]]":
        """``(chips, mesh_shape)`` for a fleet share — the knob-to-mesh
        rule in one place."""
        chips = self._chips(ports)
        return chips, {"data": max(1, chips // self.tp), "model": self.tp}

    def _lambda(self, cfg: ModelConfig, shape: ShapeSpec, chips: int,
                mesh: Dict[str, int], microbatches: int, plan) -> float:
        """Roofline step time (s) for this stage at this fleet share."""
        tp, dp = mesh["model"], mesh["data"]
        tokens = shape.global_batch * shape.seq_len
        n_act = cfg.active_param_count()
        flops_dev = 8.0 * n_act * tokens / chips      # 6ND + remat re-fwd
        t_comp = flops_dev / self.chip.peak_flops
        w_dev = 2.0 * n_act / tp
        bytes_dev = (3.0 * w_dev * microbatches       # weight re-reads
                     + 4.0 * plan.breakdown["residuals"]
                     + 3.0 * plan.breakdown["opt"]
                     + 2.0 * plan.breakdown["transient"])
        t_mem = bytes_dev / self.chip.hbm_bw
        b_loc = max(1.0, shape.global_batch / dp) / microbatches
        act = b_loc * shape.seq_len * cfg.d_model * 2.0
        layers = max(cfg.n_layers, 1)
        coll = (2 * layers * microbatches * 3 * act * 2 * (tp - 1) / max(tp, 1)
                + 4.0 * n_act / tp * 2 * (dp - 1) / max(dp, 1))
        t_coll = coll / self.chip.link_bw
        return max(t_comp, t_mem, t_coll)

    # ------------------------------------------------------------------
    # SynthesisTool protocol
    # ------------------------------------------------------------------
    def synthesize(self, component: str, *, unrolls: int, ports: int,
                   max_states: Optional[int] = None) -> Synthesis:
        cfg, shape = self.components[component]
        chips, mesh = self.mesh_for(ports)
        microbatches = self._microbatches(unrolls)
        if shape.global_batch % mesh["data"] != 0 and \
                mesh["data"] % shape.global_batch != 0:
            return Synthesis(lam=float("inf"), area=float("inf"),
                             ports=ports, unrolls=unrolls, feasible=False)
        plan = price_train_step(cfg, shape, mesh, microbatches=microbatches,
                                remat="full")
        lam = self._lambda(cfg, shape, chips, mesh, microbatches, plan)
        area = float(plan.est_bytes) * chips          # total memory claimed
        states = microbatches
        # lambda-constraint analogue: a configuration whose per-chip
        # footprint exceeds the chip's memory fails synthesis (cannot be
        # built), exactly like a schedule that does not fit max_states.
        feasible = plan.est_bytes <= self.hbm_budget
        if not feasible:
            return Synthesis(lam=float("inf"), area=float("inf"),
                             ports=ports, unrolls=unrolls,
                             states_per_iter=states, feasible=False)
        return Synthesis(lam=lam, area=area, ports=ports, unrolls=unrolls,
                         states_per_iter=states, feasible=True,
                         detail={"chips": float(chips),
                                 "microbatches": float(microbatches),
                                 "gb_per_chip": plan.est_bytes / 1e9})

    def cdfg_facts(self, component: str, synth: Synthesis) -> CDFGFacts:
        cfg, shape = self.components[component]
        return CDFGFacts(gamma_r=1, gamma_w=1,
                         eta=max(1, synth.states_per_iter),
                         trip=shape.global_batch, has_plm_access=False)
