"""Whole-grid knob pricing: one array dispatch per component, bit-exact.

The analytical backends (`HLSTool`'s list scheduler, `XLATool`'s
roofline) price one ``(component, unrolls, ports, tile)`` point per
call, so a full Algorithm-1 sweep is thousands of scalar dispatches.
:class:`BatchPricer` re-expresses both pricing models as array programs
over the *entire* ``(ports, unrolls)`` plane of a ``(component, tile)``
pair — one vectorized evaluation, memoized, after which every scalar
request is an O(1) table lookup.

The contract is **bit-exactness**, not approximation: a `BatchPricer`
wrapped around a tool returns `Synthesis` objects equal field-for-field
(lam, area, states, feasibility mask, detail dict — and therefore the
same Fig. 11 ledger counts) to what the scalar path returns.  Two rules
make that possible:

* elementwise IEEE-754 ops (`+ - * /`, `np.ceil`, `np.maximum`) are
  correctly rounded in numpy, so mirroring the scalar code's operation
  *order* reproduces its floats exactly;
* transcendentals are NOT safe — numpy's SIMD `log2`/`power` kernels
  may differ from libm by 1 ulp — so ``x ** 0.90`` and
  ``log2(states+1)`` are computed through python's `math` on the (few)
  unique values and broadcast back through a lookup table, and the
  md5 noise hash runs in a python loop with precomputed key prefixes.

`BatchPricer` implements the batched ``Oracle`` protocol (via
:class:`~repro_torch.core.oracle.OracleBatchMixin`), so it drops underneath an
``OracleLedger``/``SharedOracle`` with zero result-visible change; any
request outside a grid's extent (non-power-of-two ports for HLS, a
``tile=`` knob for XLA, unknown components) falls through to the
wrapped tool verbatim.  Grid builds are traced as ``pricing.batch``
spans tagged with the grid size.

The XLA grid prices the tool's own chip table (``XLATool.chip``: peak
FLOP/s, memory and link bandwidth), as the scalar path does, so a
batch-priced fleet drive and a scalar one price the same chip.
"""

from __future__ import annotations

import functools
import hashlib
import math
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .hlsim import (_AREA_CTRL_STATE, _AREA_PER_FU, _AREA_PER_REG,
                    _DMA_WORDS_PER_CYCLE, _FU_SHARING_EXP, HLSTool)
from .knobs import Synthesis
from .memgen import PLMSpec
from .oracle import OracleBatchMixin
from .xlatool import MAX_UNROLL, XLATool

__all__ = ["BatchPricer"]

_TWO_64 = float(1 << 64)             # md5 digest -> uniform [0,1)


@functools.lru_cache(maxsize=1 << 16)
def _noise_col(head: str, tail: str, ports: Tuple[int, ...]
               ) -> Tuple[float, ...]:
    """The scalar path's ``_hash01`` draws for one unroll count over a
    port ladder, memoized.

    Each draw is a pure function of the key string — independent of
    the tool's noise *scale* (which only thresholds it) — so one
    process-wide cache serves every grid, rebuild, and pricer; repeat
    builds skip the md5 entirely."""
    return tuple(
        int.from_bytes(hashlib.md5((head + str(p) + tail).encode())
                       .digest()[:8], "big") / _TWO_64
        for p in ports)


# ----------------------------------------------------------------------
# HLS grid: the list-scheduler economics over a (ports, unrolls) plane
# ----------------------------------------------------------------------
class _HLSGrid:
    """All scalar-path outputs for one ``(component, tile)`` pair.

    ``cycles`` is stored instead of lam so any ``clock_ns`` reprices at
    lookup time with the scalar path's exact expression.
    """

    def __init__(self, tool: HLSTool, component: str, tile: int,
                 max_ports: int, max_unrolls: int):
        spec, tile_key = tool.grid_inputs(component, tile)
        # max_ports is a power of two (the adapter guarantees it), so the
        # ladder indexes by bit_length in lookup()
        ports = [1 << k for k in range(max(1, max_ports).bit_length())
                 if (1 << k) <= max_ports]
        unrolls = list(range(1, max_unrolls + 1))
        self.component, self.tile = component, tile
        self.ports, self.max_unrolls = tuple(ports), max_unrolls
        P, U = len(ports), len(unrolls)
        self.size = P * U
        ln = spec.loop
        p_arr = np.asarray(ports, dtype=np.int64)[:, None]
        u_arr = np.asarray(unrolls, dtype=np.int64)[None, :]
        pf = p_arr.astype(np.float64)
        # -- states: Eq. (1) memory serialization + dependence residue --
        if ln.gamma_r:
            rd = np.ceil((ln.gamma_r * u_arr) / pf).astype(np.int64)
        else:
            rd = np.zeros((P, U), dtype=np.int64)
        if ln.gamma_w:
            wr = np.broadcast_to(
                np.ceil(ln.gamma_w / pf).astype(np.int64), (P, U)).copy()
        else:
            wr = np.zeros((P, U), dtype=np.int64)
        mem = rd + wr
        comp = np.maximum(1, ln.dep_depth - np.maximum(0, mem - 1))
        states = np.maximum(1, mem + comp - 1)
        # -- heuristic perturbation: the md5 hash must match the scalar
        # path bit-for-bit, so it stays a python loop (key prefixes and
        # per-unroll constants hoisted, draws memoized in _noise_r)
        if tool.noise > 0:
            sd, nm = repr(tool.seed), repr(spec.name)
            tail = f", {tile_key})" if tile_key else ")"
            extra = np.zeros((P, U), dtype=np.int64)
            for j, u in enumerate(unrolls):
                p_extra = tool.noise * (0.08 + 0.012 * u)
                mod = max(1, u // 4 + 1)
                col = extra[:, j]
                rs = _noise_col(f"({sd}, {nm}, {u}, ", tail, self.ports)
                for i, r in enumerate(rs):
                    if r < p_extra:
                        col[i] = 1 + int(r * 7919) % mod
            states = states + extra
        self.states = states
        # -- latency (in cycles; lam = cycles * clock_ns * 1e-9) --------
        groups = np.ceil(ln.trip / u_arr.astype(np.float64)).astype(np.int64)
        cyc_load = math.ceil(spec.words_in / _DMA_WORDS_PER_CYCLE)
        cyc_store = math.ceil(spec.words_out / _DMA_WORDS_PER_CYCLE)
        self.cycles = (cyc_load + (groups * states + ln.dep_depth)
                       + cyc_store + 12) * spec.outer_repeats
        # -- area: transcendentals through python math (see module doc) -
        fus = np.asarray([(ln.arith_ops * u) ** _FU_SHARING_EXP
                          for u in unrolls])
        uniq, inv = np.unique(states, return_inverse=True)
        log2_lut = np.asarray([math.log2(s + 1.0) for s in uniq.tolist()])
        ctrl = states.astype(np.float64) * log2_lut[inv].reshape(states.shape)
        regs = (ln.live_values * u_arr).astype(np.float64)
        self.area_logic = (_AREA_PER_FU * fus[None, :] + _AREA_PER_REG * regs
                           + _AREA_CTRL_STATE * ctrl)
        plm_area = np.empty((P, 1))
        banks = np.empty((P, 1))
        for i, p in enumerate(ports):
            plm = tool.memgen.generate(PLMSpec(
                words=spec.plm_size(), word_bits=spec.word_bits, ports=p))
            plm_area[i, 0] = plm.area
            banks[i, 0] = plm.banks
        self.plm_area, self.banks = plm_area, banks
        self.area_total = self.area_logic + plm_area
        self.plm_words = float(spec.plm_size())
        self.word_bits = float(spec.word_bits)

    def covers(self, ports: int, unrolls: int) -> bool:
        return ports <= self.ports[-1] and unrolls <= self.max_unrolls

    def lookup(self, unrolls: int, ports: int,
               max_states: Optional[int], clock_ns: float,
               tile: int) -> Synthesis:
        i = ports.bit_length() - 1
        j = unrolls - 1
        states = int(self.states[i, j])
        if max_states is not None and states > max_states:
            return Synthesis(lam=float("inf"), area=float("inf"),
                             ports=ports, unrolls=unrolls,
                             states_per_iter=states, feasible=False,
                             tile=tile)
        lam = int(self.cycles[i, j]) * clock_ns * 1e-9
        return Synthesis(
            lam=lam, area=float(self.area_total[i, j]), ports=ports,
            unrolls=unrolls, states_per_iter=states, feasible=True,
            detail={"area_logic": float(self.area_logic[i, j]),
                    "area_plm": float(self.plm_area[i, 0]),
                    "banks": float(self.banks[i, 0]),
                    "plm_words": self.plm_words,
                    "word_bits": self.word_bits},
            tile=tile)


# ----------------------------------------------------------------------
# XLA grid: the roofline + memory-footprint model over the same plane
# ----------------------------------------------------------------------
class _XLAGrid:
    """All scalar-path outputs of ``XLATool.synthesize`` for one stage.

    The mesh/footprint branches (family, long-context kv cap, loss
    chunking) are per-component *constants*, so the whole plane reduces
    to elementwise arithmetic on ``(ports, unrolls)`` axes — the only
    care needed is mirroring ``price_train_step``'s operation order.
    The roofline divides by the tool's chip table, as ``XLATool._lambda``
    does.
    """

    def __init__(self, tool: XLATool, component: str,
                 max_ports: int, max_unrolls: int):
        cfg, shape = tool.components[component]
        tp, chip = tool.tp, tool.chip
        B, S = shape.global_batch, shape.seq_len
        d, L = cfg.d_model, cfg.n_layers
        N = cfg.param_count()
        n_act = cfg.active_param_count()
        ports = list(range(1, max_ports + 1))
        unrolls = list(range(1, max_unrolls + 1))
        self.component = component
        self.max_ports, self.max_unrolls = max_ports, max_unrolls
        P, U = len(ports), len(unrolls)
        self.size = P * U
        chips_list = [tool.mesh_for(p)[0] for p in ports]
        dp_list = [tool.mesh_for(p)[1]["data"] for p in ports]
        chips = np.asarray(chips_list, dtype=np.int64)[:, None]
        dp = np.asarray(dp_list, dtype=np.int64)[:, None]
        mb = np.asarray([1 << max(0, MAX_UNROLL - u) for u in unrolls],
                        dtype=np.int64)[None, :]
        self.chips, self.mb = chips, mb
        self.div_ok = np.asarray(
            [(B % dpv == 0) or (dpv % B == 0) for dpv in dp_list])[:, None]
        # -- price_train_step(remat="full", accum="float32") -----------
        b_loc = (np.maximum(1, B // dp).astype(np.float64)
                 / mb.astype(np.float64))
        tpdp = np.asarray([tp * dpv for dpv in dp_list],
                          dtype=np.int64)[:, None]
        params: Any = 2.0 * N / tp
        grads: Any = 4.0 * N / tp
        opt = 8.0 * N / tpdp
        if cfg.family == "moe":
            params = 2.0 * N / tpdp + 2.0 * cfg.vocab * d / tp
            grads = grads / dp
            opt = 8.0 * N / tpdp
        resid = L * b_loc * S * d * 2.0
        H = max(cfg.n_heads, 1)
        heads_tp = H / tp if H % tp == 0 else 1.0
        if cfg.family in ("ssm", "hybrid"):
            Q = cfg.ssm_chunk
            n_ch = max(1, S // Q)
            hd_heads = cfg.ssm_heads()
            trans = (b_loc * Q * Q * hd_heads * 4.0
                     + 4 * b_loc * S * cfg.d_inner() * 4.0 / tp) * 1.5
            trans = trans + n_ch * b_loc * Q * Q * hd_heads * 4.0 / 4
        else:
            kvc = 1024 if S >= 16384 else S
            trans = (b_loc * (H / max(heads_tp, 1)) ** 0
                     * heads_tp * S * kvc * 4.0)
            trans = trans + (3 * b_loc * S * max(cfg.d_ff, cfg.expert_ff())
                             * 2.0 / tp)
        if cfg.family == "moe":
            cap = b_loc * S * cfg.top_k * cfg.capacity_factor
            trans = trans + (3 * cap * d * 2.0 / tp
                             + cap * cfg.expert_ff() * 2.0 / tp)
        chunk = 512 if cfg.vocab >= 65536 else S
        loss = 2 * b_loc * chunk * cfg.vocab * 4.0 / tp
        total = params + grads + opt + 2.2 * (resid + trans + loss)
        est = total.astype(np.int64)            # int(total): truncates
        self.est = est
        self.fits = est <= tool.hbm_budget
        # -- roofline lambda -------------------------------------------
        tokens = B * S
        flops_dev = 8.0 * n_act * tokens / chips.astype(np.float64)
        t_comp = flops_dev / chip.peak_flops
        w_dev = 2.0 * n_act / tp
        bytes_dev = (3.0 * w_dev * mb.astype(np.float64)
                     + 4.0 * resid + 3.0 * opt + 2.0 * trans)
        t_mem = bytes_dev / chip.hbm_bw
        b_loc2 = (np.maximum(1.0, B / dp.astype(np.float64))
                  / mb.astype(np.float64))
        act = b_loc2 * S * d * 2.0
        layers = max(L, 1)
        coll = (2 * layers * mb * 3 * act * 2 * (tp - 1) / max(tp, 1)
                + 4.0 * n_act / tp * 2 * (dp.astype(np.float64) - 1)
                / np.maximum(dp.astype(np.float64), 1))
        t_coll = coll / chip.link_bw
        self.lam = np.maximum(
            np.maximum(np.broadcast_to(t_comp, (P, U)), t_mem), t_coll)
        self.area = est.astype(np.float64) * chips.astype(np.float64)

    def covers(self, ports: int, unrolls: int) -> bool:
        return ports <= self.max_ports and unrolls <= self.max_unrolls

    def lookup(self, unrolls: int, ports: int) -> Synthesis:
        i, j = ports - 1, unrolls - 1
        if not bool(self.div_ok[i, 0]):
            return Synthesis(lam=float("inf"), area=float("inf"),
                             ports=ports, unrolls=unrolls, feasible=False)
        states = int(self.mb[0, j])
        if not bool(self.fits[i, j]):
            return Synthesis(lam=float("inf"), area=float("inf"),
                             ports=ports, unrolls=unrolls,
                             states_per_iter=states, feasible=False)
        est = int(self.est[i, j])
        return Synthesis(
            lam=float(self.lam[i, j]), area=float(self.area[i, j]),
            ports=ports, unrolls=unrolls, states_per_iter=states,
            feasible=True,
            detail={"chips": float(int(self.chips[i, 0])),
                    "microbatches": float(states),
                    "gb_per_chip": est / 1e9})


# ----------------------------------------------------------------------
# the Oracle-protocol adapter
# ----------------------------------------------------------------------
class BatchPricer(OracleBatchMixin):
    """Whole-grid pricing adapter around an analytical tool.

    Drop-in for the wrapped tool everywhere a ``SynthesisTool`` or
    batched ``Oracle`` is accepted: ``synthesize`` answers from the
    memoized grid (building it on first touch, growing it by doubling
    when a request lands outside the current extent), and every other
    attribute (``cdfg_facts``, ``components``, ``plm_requirement``,
    ``grid_inputs``, ...) delegates to the tool.  Use
    :meth:`BatchPricer.wrap` to wrap opportunistically — non-analytical
    tools pass through unchanged.
    """

    #: grids at least this large are built on first touch, so the
    #: common knob spaces (wami: 8 ports x 16 unrolls) need one build
    _MIN_PORTS_HLS, _MIN_UNROLLS_HLS = 8, 16
    _MIN_PORTS_XLA, _MIN_UNROLLS_XLA = 4, 8

    def __init__(self, tool: Any):
        if isinstance(tool, BatchPricer):
            tool = tool._tool
        if not self._grid_exact(tool):
            raise TypeError(
                f"BatchPricer supports the pristine analytical backends "
                f"(HLSTool, XLATool); got {type(tool).__name__}. Use "
                f"BatchPricer.wrap() to pass other tools through.")
        self._mode = "hls" if isinstance(tool, HLSTool) else "xla"
        self._tool = tool
        self._grids: Dict[Tuple[str, int], Any] = {}
        self._lock = threading.Lock()
        # observability counters (read by tests and the pricing bench)
        self.grid_builds = 0
        self.grid_points_priced = 0
        self.lookups = 0
        self.fallbacks = 0

    @staticmethod
    def _grid_exact(tool: Any) -> bool:
        """True when the grid program provably mirrors ``tool``: an
        analytical backend whose ``synthesize`` is the pristine base
        implementation.  Subclasses that override ``synthesize`` (fault
        injection, gating, counting wrappers in tests) carry semantics
        the grid cannot reproduce and must price scalar."""
        for base in (HLSTool, XLATool):
            if isinstance(tool, base):
                return type(tool).synthesize is base.synthesize
        return False

    @classmethod
    def wrap(cls, tool: Any) -> Any:
        """Wrap ``tool`` when its pricing model has a grid program;
        return it unchanged otherwise (measured backends price by
        executing kernels, subclassed analytical tools carry override
        semantics — nothing to vectorize in either case)."""
        if isinstance(tool, cls):
            return tool
        if cls._grid_exact(tool):
            return cls(tool)
        return tool

    @property
    def tool(self) -> Any:
        """The wrapped scalar tool."""
        return self._tool

    def __getattr__(self, name: str) -> Any:
        # delegate everything the adapter does not override; guard via
        # __dict__ so a half-constructed instance cannot recurse
        try:
            tool = self.__dict__["_tool"]
        except KeyError:
            raise AttributeError(name) from None
        return getattr(tool, name)

    # -- grid management ----------------------------------------------
    def _grid_key(self, component: str, unrolls: Any, ports: Any,
                  kw: Dict[str, Any]) -> Optional[Tuple[str, int]]:
        """The memo key when the request is grid-priceable, else None
        (the request falls through to the scalar tool verbatim)."""
        if not isinstance(unrolls, int) or not isinstance(ports, int):
            return None
        if unrolls < 1 or ports < 1:
            return None
        if component not in self._tool.components:
            return None                       # KeyError stays scalar-raised
        if self._mode == "hls":
            if not set(kw) <= {"tile", "clock_ns"}:
                return None
            tile = kw.get("tile", 0)
            if not isinstance(tile, int):
                return None
            if ports & (ports - 1):
                return None                   # non-pow2 port ladder
            return (component, tile)
        if kw:                                # XLATool has no tile/clock
            return None
        return (component, 0)

    def _grid_for(self, key: Tuple[str, int], ports: int,
                  unrolls: int) -> Any:
        with self._lock:
            grid = self._grids.get(key)
            if grid is not None and grid.covers(ports, unrolls):
                return grid
            component, tile = key
            if self._mode == "hls":
                pmax = max(self._MIN_PORTS_HLS, ports,
                           grid.ports[-1] * 2 if grid else 0)
                umax = max(self._MIN_UNROLLS_HLS, unrolls,
                           grid.max_unrolls * 2 if grid else 0)
                with self.tracer.span("pricing.batch", component=component,
                                      tile=tile, ports=pmax, unrolls=umax,
                                      n=0) as sp:
                    grid = _HLSGrid(self._tool, component, tile, pmax, umax)
                    sp.set("n", grid.size)
            else:
                pmax = max(self._MIN_PORTS_XLA, ports,
                           grid.max_ports * 2 if grid else 0)
                umax = max(self._MIN_UNROLLS_XLA, unrolls,
                           grid.max_unrolls * 2 if grid else 0)
                with self.tracer.span("pricing.batch", component=component,
                                      tile=tile, ports=pmax, unrolls=umax,
                                      n=0) as sp:
                    grid = _XLAGrid(self._tool, component, pmax, umax)
                    sp.set("n", grid.size)
            self._grids[key] = grid
            self.grid_builds += 1
            self.grid_points_priced += grid.size
            return grid

    # -- SynthesisTool protocol ---------------------------------------
    def synthesize(self, component: str, *, unrolls: int, ports: int,
                   max_states: Optional[int] = None,
                   **kw: Any) -> Synthesis:
        key = self._grid_key(component, unrolls, ports, kw)
        if key is None:
            self.fallbacks += 1
            return self._tool.synthesize(component, unrolls=unrolls,
                                         ports=ports, max_states=max_states,
                                         **kw)
        grid = self._grid_for(key, ports, unrolls)
        self.lookups += 1
        if self._mode == "hls":
            return grid.lookup(unrolls, ports, max_states,
                               kw.get("clock_ns", 1.0), kw.get("tile", 0))
        return grid.lookup(unrolls, ports)
