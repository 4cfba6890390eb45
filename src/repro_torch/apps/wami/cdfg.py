"""CDFG extraction from ``make_fx`` graphs.

The paper infers the lambda-constraint inputs (gamma_r, gamma_w, eta) "by
traversing the control data flow graph (CDFG) created by the HLS tool for
scheduling the lower-right point" (Section 5).  Each WAMI component
exposes its per-iteration scalar body (``kernel``, plain PyTorch), and
this module traces it with ``make_fx`` into an aten graph and walks that
graph to count

  * ``reads_per_input`` — window elements read per iteration, per input
    array (gamma_r is the largest);
  * ``writes`` — output elements per iteration (gamma_w);
  * ``arith_ops`` / ``dep_depth`` — arithmetic operation count and
    critical dependence-chain depth (the scheduler inputs);
  * ``live_values`` — values alive across states (register cost).

The cost rules are the JAX package's jaxpr walk
(``repro/apps/wami/cdfg.py``), op for op: an arithmetic op costs its
output width and one level, a reduction n - 1 and ceil(log2 n) levels, a
product 2 x width x k and 1 + ceil(log2 k) levels, wiring nothing, and an
op in no class its width and one level.

:data:`WAMI_KERNEL_FACTS` holds the facts of the 12 components as that
walk gives them under jax 0.9; the walk here equals it for 11 of them.
``hessian`` is the exception (:func:`component_facts`): its JAX body's
``jnp.triu_indices`` traces into index arithmetic that aten has no
counterpart for, so its facts stay pinned.

Two common ops differ from the reference by their IR, not by the walk
(``tests/test_torch_cdfg_rules.py`` pins the offsets): aten holds a
softmax as one ``_softmax``, where jax traces seven equations (among them
a ``max`` against ``-inf`` that no aten decomposition has), and indexing
with a tensor as one ``index``, where jax adds the gather's index
arithmetic.
"""

from __future__ import annotations

import math
import operator
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import torch

from ...core.hlsim import LoopNest
from ...launch.graph_analysis import _op_name

__all__ = ["KernelFacts", "WAMI_KERNEL_FACTS", "PINNED_FACTS",
           "analyze_kernel", "loop_nest_from_kernel", "component_facts",
           "clear_facts_cache"]

# Ops that occupy a functional unit for one state (aten names of the
# reference's _ARITH).  An op in no class is priced the same way.
_ARITH = {
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "neg", "abs",
    "sign", "sgn", "pow", "exp", "log", "sqrt", "rsqrt", "tanh", "sigmoid",
    "floor", "ceil", "round", "erf", "square", "atan2", "nextafter",
    "lt", "le", "gt", "ge", "eq", "ne", "where",
    "clamp", "clamp_min", "clamp_max", "maximum", "minimum",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift",
}
_REDUCE = {"sum", "amax", "amin", "prod", "any", "all", "argmax", "argmin"}
# `max` and `min` are reductions in their whole-tensor and `dim` overloads
# (jax's reduce_max / reduce_min); `max.other` / `min.other` are the
# elementwise maximum / minimum and stay in no class, priced as arithmetic
_REDUCE_OVERLOADS = {
    torch.ops.aten.max.default, torch.ops.aten.max.dim,
    torch.ops.aten.min.default, torch.ops.aten.min.dim,
}
# wiring: views, copies, casts, joins and constants
_FREE = {
    "view", "reshape", "_unsafe_view", "unsqueeze", "squeeze", "expand",
    "permute", "t", "transpose", "slice", "select", "cat", "clone", "alias",
    "detach", "_to_copy", "lift_fresh_copy", "split", "split_with_sizes",
    "unbind", "arange", "zeros", "ones", "full", "scalar_tensor",
    "zeros_like", "ones_like", "full_like",
}
_DOT = {"dot", "mm", "mv", "matmul", "bmm"}


@dataclass(frozen=True)
class KernelFacts:
    reads_per_input: Tuple[int, ...]   # window elements read per iteration
    writes: int                        # output elements per iteration
    arith_ops: int
    dep_depth: int
    live_values: int


WAMI_KERNEL_FACTS: Dict[str, KernelFacts] = {
    "debayer": KernelFacts((16,), 12, 48, 4, 32),
    "grayscale": KernelFacts((3,), 1, 5, 3, 8),
    "gradient": KernelFacts((5,), 2, 4, 2, 11),
    "steep_descent": KernelFacts((2, 2), 6, 4, 1, 14),
    "hessian": KernelFacts((6, 21), 21, 582, 14, 31),
    "sd_update": KernelFacts((6, 1, 6), 6, 12, 2, 4),
    "matrix_sub": KernelFacts((1, 1), 1, 1, 1, 4),
    "matrix_add": KernelFacts((1, 1), 1, 1, 1, 4),
    "matrix_mul": KernelFacts((6, 6), 1, 12, 4, 4),
    "matrix_resh": KernelFacts((1,), 1, 1, 1, 4),
    "warp": KernelFacts((4, 2), 1, 12, 5, 11),
    "change_det": KernelFacts((1, 9), 10, 75, 14, 24),
}

# The components whose facts are read from WAMI_KERNEL_FACTS, not walked.
# hessian: the JAX body's `outer[jnp.triu_indices(6)]` traces into 8 `jit`
# equations of index arithmetic (`lt`/`add`/`select_n` on int32[36] and
# int32[21]), a `scatter-add` and a `gather`, all priced as arithmetic;
# aten holds `triu_indices` and `index` in their place, so the walk here
# gives (120, 3, 8) against the reference's (582, 14, 31).
PINNED_FACTS = frozenset({"hessian"})


def _size(val) -> int:
    return val.numel() if isinstance(val, torch.Tensor) else 1


def _outs(node: torch.fx.Node) -> list:
    val = node.meta.get("val")
    return list(val) if isinstance(val, (list, tuple)) else [val]


def _walk(graph: torch.fx.Graph, root: torch.nn.Module,
          depth_in: Dict[torch.fx.Node, int]) -> Tuple[int, int, int]:
    """Return (arith_ops, dep_depth, n_intermediate) of a (possibly
    nested) graph whose placeholders start at the given depths."""
    depth = dict(depth_in)
    arith = 0
    max_depth = max(depth.values(), default=0)
    n_vars = 0

    for node in graph.nodes:
        if node.op != "call_function":
            continue
        d_in = max((depth.get(a, 0) for a in node.all_input_nodes), default=0)
        if node.target is operator.getitem:     # a tuple's element: no value
            depth[node] = d_in
            continue
        name = _op_name(node)
        outs = _outs(node)
        width = max((_size(v) for v in outs), default=1)
        tensors = [a.meta.get("val") for a in node.all_input_nodes
                   if isinstance(a.meta.get("val"), torch.Tensor)]

        if name in _FREE:
            cost, d = 0, d_in
        elif name in _ARITH:
            cost, d = width, d_in + 1
        elif name in _REDUCE or node.target in _REDUCE_OVERLOADS:
            n = max((t.numel() for t in tensors), default=1)
            cost = max(1, n - 1)
            d = d_in + max(1, math.ceil(math.log2(max(2, n))))  # tree reduce
        elif name in _DOT:
            k = tensors[0].shape[-1] if tensors and tensors[0].dim() else 1
            cost = 2 * width * max(1, k)
            d = d_in + 1 + math.ceil(math.log2(max(2, k)))
        elif name in ("cond", "scan"):
            # nested control flow: recurse into the body the reference
            # does — jax orders a cond's branches (false, true) and walks
            # branches[0]; a scan's body runs `length` times
            if name == "cond":
                body, trips = node.args[2], 1
            else:
                body, trips = node.args[0], int(_outs(node.args[2][0])[0]
                                                .shape[0])
            sub = getattr(root, body.target)
            sub_depth = {p: d_in for p in sub.graph.nodes
                         if p.op == "placeholder"}
            a2, d2, n2 = _walk(sub.graph, sub, sub_depth)
            cost, d = a2 * trips, d_in + d2 * trips
            n_vars += n2
        else:   # while_loop too: the reference's `while` has no `jaxpr`
            cost, d = width, d_in + 1

        arith += cost
        depth[node] = d
        n_vars += len(outs)
        max_depth = max(max_depth, d)
    return arith, max_depth, n_vars


def _analyze(kernel: Callable, example_args: Sequence) -> KernelFacts:
    # ops that jax traces as several equations, decomposed the same way:
    # `jnp.stack` is one `concatenate` of expanded operands (unsqueeze
    # each, then cat), `jnp.mean` a `reduce_sum` and a `div`
    from torch._decomp import get_decompositions
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(kernel, decomposition_table=get_decompositions(
        [torch.ops.aten.stack, torch.ops.aten.mean]))(*example_args)
    nodes = list(gm.graph.nodes)
    inputs = [n for n in nodes if n.op == "placeholder"]
    out = next(n for n in nodes if n.op == "output")
    reads = tuple(_size(n.meta.get("val")) for n in inputs)
    # every returned value counts, a value returned twice twice (the
    # reference sums over the jaxpr's outvars)
    writes = sum(_size(n.meta.get("val")) for n in
                 torch.utils._pytree.tree_leaves(out.args[0])
                 if isinstance(n, torch.fx.Node))
    arith, dep_depth, n_vars = _walk(gm.graph, gm, {n: 0 for n in inputs})
    live = max(4, min(n_vars, sum(reads) + writes + 4))
    return KernelFacts(reads_per_input=reads, writes=writes,
                       arith_ops=max(1, arith), dep_depth=max(1, dep_depth),
                       live_values=live)


# facts are a pure function of the body and its arguments' shapes and
# dtypes: each is traced once a process
_CACHE: Dict[tuple, KernelFacts] = {}
_LOCK = threading.Lock()


def analyze_kernel(kernel: Callable, example_args: Sequence) -> KernelFacts:
    """Trace the kernel into an aten graph and extract scheduling facts."""
    key = (kernel, tuple((tuple(a.shape), a.dtype) for a in example_args))
    with _LOCK:
        if key not in _CACHE:
            _CACHE[key] = _analyze(kernel, example_args)
        return _CACHE[key]


def clear_facts_cache() -> None:
    """Forget every walked body, so the next call traces again."""
    with _LOCK:
        _CACHE.clear()


def component_facts(name: str, kernel: Callable,
                    example_args: Sequence) -> KernelFacts:
    """A WAMI component's facts: walked, or pinned (:data:`PINNED_FACTS`)."""
    if name in PINNED_FACTS:
        return WAMI_KERNEL_FACTS[name]
    return analyze_kernel(kernel, example_args)


def loop_nest_from_kernel(kernel: Callable, example_args: Sequence, *,
                          trip: int, has_plm_access: bool = True) -> LoopNest:
    """Build the hlsim LoopNest for a component from its scalar body."""
    f = analyze_kernel(kernel, example_args)
    return LoopNest(trip=trip,
                    gamma_r=max(f.reads_per_input) if f.reads_per_input else 0,
                    gamma_w=max(1, f.writes),
                    arith_ops=f.arith_ops,
                    dep_depth=f.dep_depth,
                    live_values=f.live_values,
                    has_plm_access=has_plm_access)
