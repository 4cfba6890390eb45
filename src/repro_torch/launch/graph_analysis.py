"""Traced-graph analysis: per-device FLOPs, bytes, collective bytes,
peak live memory and roofline terms (the counterpart of the JAX
package's ``launch/hlo_analysis.py``, which parses XLA's optimized HLO).

The input is a ``torch.fx`` graph from ``make_fx`` of rank 0's program
on a DTensor mesh: every node's ``meta["val"]`` holds its local (per
device) shape, and DTensor's redistributions appear as
``_c10d_functional`` nodes.  Bytes moved per device by a collective are
modeled with the reference's ring factors, on its result bytes:

    all-reduce        2 (N-1)/N x result bytes   (reduce-scatter + all-gather)
    all-gather          (N-1)/N x result bytes
    reduce-scatter      (N-1)   x result bytes   (operand = N x result)
    all-to-all          (N-1)/N x result bytes
    collective-permute        1 x result bytes

The roofline terms divide by the chip table (:mod:`..core.chips`, an
H100 SXM: 989e12 FLOP/s bf16 dense, 3.35e12 B/s HBM3, 450e9 B/s NVLink
each way).  ``make_fx`` unrolls Python loops, so a layer loop traced ten
times counts ten times: the reference's trip-count walk over while
loops has no counterpart here.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from ..core.chips import H100_SXM, ChipSpec

__all__ = ["CollectiveStats", "ModuleCost", "parse_collectives",
           "analyze_graph", "roofline_terms", "dtype_bytes",
           "memory_terms", "COLLECTIVE_KINDS"]

# _c10d_functional op name -> the reference's HLO collective kind
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that move no bytes: the _NO_TRAFFIC counterpart (views are found
# from their schemas)
_NO_TRAFFIC = {"wait_tensor", "detach", "alias", "lift_fresh",
               "_assert_tensor_metadata", "sym_size", "sym_stride",
               "sym_numel"}


def dtype_bytes(dt: torch.dtype) -> int:
    return getattr(dt, "itemsize", 4)


@dataclass
class CollectiveStats:
    per_op: Dict[str, float] = field(default_factory=dict)   # modeled bytes
    per_op_count: Dict[str, int] = field(default_factory=dict)
    raw_result_bytes: float = 0.0
    modeled_bytes: float = 0.0                                 # per device

    def add(self, kind: str, bytes_: float, n: int):
        if kind == "all-reduce":
            moved = 2.0 * (n - 1) / max(n, 1) * bytes_
        elif kind == "all-gather":
            moved = (n - 1) / max(n, 1) * bytes_
        elif kind == "reduce-scatter":
            moved = (n - 1) * bytes_
        elif kind == "all-to-all":
            moved = (n - 1) / max(n, 1) * bytes_
        else:                               # collective-permute
            moved = bytes_
        self.per_op[kind] = self.per_op.get(kind, 0.0) + moved
        self.per_op_count[kind] = self.per_op_count.get(kind, 0) + 1
        self.raw_result_bytes += bytes_
        self.modeled_bytes += moved


@dataclass
class ModuleCost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: CollectiveStats = None  # type: ignore


def _tensors(val: Any) -> List[torch.Tensor]:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def _nbytes(val: Any) -> int:
    return sum(t.numel() * dtype_bytes(t.dtype) for t in _tensors(val))


def _val(a: Any) -> Any:
    if isinstance(a, torch.fx.Node):
        return a.meta.get("val")
    if isinstance(a, (list, tuple)):
        return type(a)(_val(x) for x in a)
    return a


def _op_name(node: torch.fx.Node) -> str:
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return t._schema.name.split("::")[-1]
    return getattr(t, "__name__", str(t))


def _is_collective(node: torch.fx.Node) -> bool:
    t = node.target
    return (isinstance(t, torch._ops.OpOverload)
            and t.namespace == "_c10d_functional"
            and _op_name(node) in COLLECTIVE_KINDS)


def _aliases(node: torch.fx.Node, *, writes: bool = True) -> bool:
    """True where the node's output is a view of (or is) an input: view
    ops, the no-traffic ops and, unless ``writes`` is false, in-place
    ops (which allocate nothing but do move bytes)."""
    if node.op != "call_function":
        return False
    if node.target is operator.getitem:
        return True
    if _op_name(node) in _NO_TRAFFIC:
        return True
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return any(r.alias_info is not None
                   and (writes or not r.alias_info.is_write)
                   for r in t._schema.returns)
    return False


def _schema_arg(node: torch.fx.Node, name: str) -> Any:
    for i, a in enumerate(node.target._schema.arguments):
        if a.name == name:
            return node.args[i] if i < len(node.args) else node.kwargs.get(
                name, a.default_value)
    raise KeyError(name)


def _group_size(node: torch.fx.Node) -> int:
    """The size of the node's process group, read from its group name
    through ``torch.distributed``."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(_schema_arg(node, "group_name")).size()


def _add_collective(stats: CollectiveStats, node: torch.fx.Node) -> None:
    kind = COLLECTIVE_KINDS[_op_name(node)]
    n = _group_size(node)
    for t in _tensors(node.meta.get("val")):
        stats.add(kind, float(t.numel() * dtype_bytes(t.dtype)), n)


def parse_collectives(gm: torch.fx.GraphModule) -> CollectiveStats:
    """Sum collective traffic of a traced per-device graph."""
    stats = CollectiveStats()
    for node in gm.graph.nodes:
        if node.op == "call_function" and _is_collective(node):
            _add_collective(stats, node)
    return stats


def _flops(node: torch.fx.Node) -> float:
    from torch.utils.flop_counter import flop_registry
    t = node.target
    packet = getattr(t, "overloadpacket", None)
    if packet not in flop_registry:
        return 0.0
    out = node.meta.get("val")
    return float(flop_registry[packet](*_val(node.args), **_val(node.kwargs),
                                       out_val=out))


def analyze_graph(gm: torch.fx.GraphModule) -> ModuleCost:
    """Per-device cost of a traced graph: FLOPs from
    ``torch.utils.flop_counter``'s formulas on each node's local shapes,
    bytes as each op's operand and output sizes (views, ``getitem`` and
    ``wait_tensor`` move none), collectives by the ring model."""
    cost = ModuleCost(collectives=CollectiveStats())
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        cost.flops += _flops(node)
        if _is_collective(node):
            _add_collective(cost.collectives, node)
        if _aliases(node, writes=False):
            continue
        cost.bytes += (_nbytes(node.meta.get("val"))
                       + sum(_nbytes(a.meta.get("val"))
                             for a in node.all_input_nodes))
    return cost


def memory_terms(gm: torch.fx.GraphModule) -> Dict[str, int]:
    """``argument_bytes`` (the placeholders), ``output_bytes`` (the
    distinct tensors returned) and ``temp_bytes``: the peak of the bytes
    that intermediate nodes hold live, walking the graph in node order
    and freeing a buffer after the last use of it or of any view of it
    (the counterpart of XLA's buffer assignment; outputs and arguments
    excluded)."""
    nodes = list(gm.graph.nodes)
    root: Dict[torch.fx.Node, torch.fx.Node] = {}
    for node in nodes:
        src = node
        if _aliases(node) and node.all_input_nodes:
            src = root.get(node.all_input_nodes[0], node.all_input_nodes[0])
        root[node] = src
    last: Dict[torch.fx.Node, int] = {}
    for i, node in enumerate(nodes):
        for a in node.all_input_nodes:
            last[root[a]] = i
    out_node = nodes[-1]
    outputs = {root[a] for a in out_node.all_input_nodes}
    args = sum(_nbytes(n.meta.get("val")) for n in nodes
               if n.op == "placeholder")
    out_bytes = sum(_nbytes(n.meta.get("val")) for n in outputs)
    live = peak = 0
    frees: Dict[int, int] = {}
    for i, node in enumerate(nodes):
        if (node.op == "call_function" and root[node] is node
                and node not in outputs):
            size = _nbytes(node.meta.get("val"))
            live += size
            peak = max(peak, live)
            end = last.get(node, i)
            frees[end] = frees.get(end, 0) + size
        live -= frees.pop(i, 0)
    return {"argument_bytes": int(args), "output_bytes": int(out_bytes),
            "temp_bytes": int(peak)}


def roofline_terms(*, flops_per_device: float, bytes_per_device: float,
                   collective_bytes: float,
                   chip: ChipSpec = H100_SXM) -> Dict[str, float]:
    """The three roofline terms, in seconds (per device = per step), on
    ``chip``."""
    t_compute = flops_per_device / chip.peak_flops
    t_memory = bytes_per_device / chip.hbm_bw
    t_collective = collective_bytes / chip.link_bw
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_collective), key=lambda kv: kv[1])
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bound": dominant[0],
        "t_bound_s": dominant[1],
    }
