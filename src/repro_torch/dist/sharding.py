"""Sharding-rule resolution and in-model sharding constraints (the JAX
package's ``dist/sharding.py``).

Rules are (path-substring, logical-axes) pairs resolved against a mesh:

  * axis names absent from the mesh resolve to ``None`` (the same rule
    set drives a 1-device run and the 512-rank production mesh);
  * a dimension whose size does not divide the mesh axis resolves to
    ``None`` (divisibility guard — reduced test models never trip it);
  * rules are written for the weight's own dims; layer-stacked arrays
    are LEFT-padded with ``None``.

A resolved spec is a :class:`PartitionSpec`: a tuple with one entry per
tensor dim (``None``, an axis name or a tuple of names), as JAX's is, and
a leaf of the package's trees.  The
resolution reads only the mesh's name-to-size map (:func:`mesh_shape`),
so a ``DeviceMesh``, or any object whose ``shape`` is such a dict, will
do.  :func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``.

The ``constrain*`` helpers used inside model code are the identity
unless a :func:`mesh_context` is active and the tensor is a DTensor;
then they redistribute it to the resolved placements (the counterpart of
``with_sharding_constraint``), so the same model code runs on one device
and sharded.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..utils import leaves_with_paths, tree_map, unflatten_like

__all__ = [
    "PartitionSpec", "tree_paths", "ShardingRules", "lm_rules",
    "mesh_context", "mesh_shape",
    "placements", "residual_sharding", "constrain", "constrain_residual",
    "constrain_attn_qkv", "batch_spec", "cache_spec", "zero1_spec",
]

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (split over them in order)."""

    def __new__(cls, *dims: Axis) -> "PartitionSpec":
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


Spec = PartitionSpec

# stacks, innermost last
_MESH_STACK: List[Any] = []
_RESIDUAL_STACK: List[Tuple[Axis, ...]] = [("data", None, None)]


def tree_paths(tree: Any) -> Any:
    """Same-structure tree whose leaves are 'a/b/0'-style path strings."""
    return unflatten_like(tree, iter(p for p, _ in leaves_with_paths(tree)))


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """A mesh's axis-name-to-size map: a ``DeviceMesh``'s dim names and
    sizes, or ``mesh.shape`` where that is already the map."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_names(ax: Axis) -> Tuple[str, ...]:
    if ax is None:
        return ()
    if isinstance(ax, tuple):
        return ax
    return (ax,)


def _resolve(axes: Sequence[Axis], mesh: Any,
             shape: Optional[Sequence[int]] = None) -> Spec:
    """Resolve logical axes to a spec valid on ``mesh``."""
    sizes = mesh_shape(mesh)
    out: List[Axis] = []
    for i, ax in enumerate(axes):
        names = tuple(n for n in _axis_names(ax) if n in sizes)
        if not names:
            out.append(None)
            continue
        size = math.prod(sizes[n] for n in names)
        if shape is not None and i < len(shape) and shape[i] % size != 0:
            out.append(None)
            continue
        out.append(names if len(names) > 1 else names[0])
    return PartitionSpec(*out)


def _fit(axes: Sequence[Axis], ndim: int) -> Tuple[Axis, ...]:
    """Left-pad (layer-stacked arrays) or left-trim rule axes to ndim."""
    axes = tuple(axes)
    if len(axes) < ndim:
        return (None,) * (ndim - len(axes)) + axes
    if len(axes) > ndim:
        return axes[len(axes) - ndim:]
    return axes


def placements(spec: Sequence[Axis], device_mesh: Any) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``device_mesh``, one per mesh
    dim: ``Shard(d)`` where tensor dim ``d`` names the mesh dim, else
    ``Replicate()``.  A tensor dim on several mesh dims (``("pod",
    "data")``) is split over them in mesh order, which is the spec's
    row-major order when the names come in mesh order (they must)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        axis_names = _axis_names(ax)
        idx = [names.index(n) for n in axis_names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: axes {axis_names} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            if out[i].is_shard():
                raise ValueError(f"spec {spec!r} uses mesh axis "
                                 f"{names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class ShardingRules:
    """Ordered (path-substring, axes) rules; first match wins."""

    rules: Tuple[Tuple[str, Tuple[Axis, ...]], ...]

    def axes_for(self, path: str, ndim: int) -> Tuple[Axis, ...]:
        for pattern, axes in self.rules:
            if pattern in path:
                return _fit(axes, ndim)
        return (None,) * ndim

    def spec(self, path: str, ndim: int, mesh: Any,
             shape: Optional[Sequence[int]] = None) -> Spec:
        return _resolve(self.axes_for(path, ndim), mesh, shape)

    def tree(self, params: Any, mesh: Any) -> Any:
        """The spec of every leaf of ``params`` (tensors, meta or not),
        in ``params``' structure."""
        return tree_map(lambda leaf, path: self.spec(
            path, len(leaf.shape), mesh, tuple(leaf.shape)),
            params, tree_paths(params))


def lm_rules(family: str, *, two_d_experts: bool = False) -> ShardingRules:
    """Megatron-style tensor-parallel rules for the model zoo.

    Experts shard on 'model'; ``two_d_experts`` additionally shards the
    expert FFN dim on 'data' (2D expert sharding for >200B MoE).
    """
    rules: List[Tuple[str, Tuple[Axis, ...]]] = [
        ("embed", ("model", None)),
        ("moe/router", (None, None)),
        ("moe/w_down", ("model", "data", None) if two_d_experts
         else ("model", None, None)),
        ("moe/w_gate", ("model", None, "data") if two_d_experts
         else ("model", None, None)),
        ("moe/w_up", ("model", None, "data") if two_d_experts
         else ("model", None, None)),
        ("attn/wq", (None, "model")),
        ("attn/wk", (None, "model")),
        ("attn/wv", (None, "model")),
        ("attn/wo", ("model", None)),
        ("mlp/w_up", (None, "model")),
        ("mlp/w_gate", (None, "model")),
        ("mlp/w_down", ("model", None)),
        ("ssm/in_proj", (None, "model")),
        ("ssm/out_proj", ("model", None)),
        ("in_proj", (None, "model")),
        ("out_proj", ("model", None)),
    ]
    return ShardingRules(rules=tuple(rules))


# ----------------------------------------------------------------------
# Contexts + in-model constraints
# ----------------------------------------------------------------------
@contextlib.contextmanager
def mesh_context(mesh: Any):
    """Activate ``mesh`` (a ``DeviceMesh`` with named dims) for the
    ``constrain*`` helpers."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


@contextlib.contextmanager
def residual_sharding(axes: Tuple[Axis, ...]):
    """Override the residual-activation axes (e.g. ('data', 'model',
    None) for sequence parallelism) within the context."""
    _RESIDUAL_STACK.append(tuple(axes))
    try:
        yield
    finally:
        _RESIDUAL_STACK.pop()


def _active_mesh() -> Optional[Any]:
    return _MESH_STACK[-1] if _MESH_STACK else None


def constrain(x, axes: Sequence[Axis]):
    """``x`` redistributed to ``axes`` resolved on the active mesh; the
    identity when no ``mesh_context`` is active or ``x`` is not a
    DTensor (single-device runs)."""
    mesh = _active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = _resolve(_fit(axes, x.ndim), mesh, tuple(x.shape))
    want = placements(spec, x.device_mesh)
    y = x if tuple(x.placements) == want else x.redistribute(x.device_mesh,
                                                               want)
    if y.requires_grad:
        # the gradient takes the same layout: partial sums from a
        # column-parallel product's backward are reduced here, once
        # (Megatron's all-reduce in backward), not carried on
        y.register_hook(lambda g: g if tuple(g.placements) == want
                        else g.redistribute(g.device_mesh, want))
    return y


def constrain_residual(x):
    """(B, S, D) residual stream: data-parallel batch (+ optional
    sequence parallelism from ``residual_sharding``)."""
    return constrain(x, _RESIDUAL_STACK[-1])


def constrain_attn_qkv(q, k, v):
    """(B, S, H, hd) attention activations: heads on 'model'."""
    axes = (("pod", "data"), None, "model", None)
    return (constrain(q, axes), constrain(k, axes), constrain(v, axes))


# ----------------------------------------------------------------------
# Input/optimizer specs (launch-time)
# ----------------------------------------------------------------------
def _data_axes(mesh: Any) -> Tuple[str, ...]:
    sizes = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def batch_spec(bspecs: Any, mesh: Any) -> Any:
    """Shard every batch leaf's leading dim over the data axes."""
    axes = _data_axes(mesh)

    def leaf(spec):
        if not axes or not spec.shape:
            return PartitionSpec()
        return _resolve((axes,) + (None,) * (len(spec.shape) - 1), mesh,
                        tuple(spec.shape))

    return tree_map(leaf, bspecs)


def cache_spec(cache_specs: Any, mesh: Any, *,
               seq_shard: bool = False) -> Any:
    """KV/state-cache specs: batch over data axes; for batch-1 decode
    (``seq_shard``) the sequence dim shards over 'model'.  A leaf that is
    not a tensor (the cache's length) gets the empty spec."""
    axes = _data_axes(mesh)

    def leaf(spec):
        shape = tuple(getattr(spec, "shape", ()))
        if not shape:
            return PartitionSpec()
        dims: List[Axis] = [None] * len(shape)
        if seq_shard and len(shape) >= 2:
            dims[1] = "model"
        elif axes:
            dims[0] = axes
        return _resolve(tuple(dims), mesh, shape)

    return tree_map(leaf, cache_specs)


def zero1_spec(param_spec: Sequence[Axis], shape: Tuple[int, ...],
               mesh: Any) -> Spec:
    """ZeRO-1 optimizer-moment spec: keep the param's spec and
    additionally shard the first still-replicated, divisible dim over
    the data axes — unless the param's spec already uses one of them
    (2-D experts), since a mesh axis can split only one dim."""
    axes = _data_axes(mesh)
    if not axes or not shape:
        return PartitionSpec(*param_spec)
    used = {n for ax in param_spec for n in _axis_names(ax)}
    if used & set(axes):
        return PartitionSpec(*_fit(tuple(param_spec), len(shape)))
    sizes = mesh_shape(mesh)
    size = math.prod(sizes[a] for a in axes)
    dims = list(_fit(tuple(param_spec), len(shape)))
    for i, (ax, dim) in enumerate(zip(dims, shape)):
        if ax is None and dim % size == 0:
            dims[i] = axes if len(axes) > 1 else axes[0]
            break
    return PartitionSpec(*dims)


# ----------------------------------------------------------------------
# Per-rank bodies over DTensors
# ----------------------------------------------------------------------
def is_dtensor(x: Any) -> bool:
    """True for a DTensor (without importing it on the unsharded path)."""
    return type(x).__name__ == "DTensor" and hasattr(x, "device_mesh")


def local_call(fn, device_mesh: Any, args: Sequence[Any],
               in_placements: Sequence[Optional[Tuple[Any, ...]]],
               out_placements: Any):
    """``fn`` on each rank's shards: every argument with placements is
    redistributed to them (a plain tensor counts as replicated) and
    passed as its local tensor, the others as they are; the result is
    the DTensor of ``fn``'s local output with ``out_placements`` (or,
    where ``fn`` returns a tuple, one DTensor per element, with the
    matching entry of ``out_placements``).  Both conversions are
    differentiable, so gradients flow as through ``fn``."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate
    rep = (Replicate(),) * device_mesh.ndim
    outs = (list(out_placements) if out_placements
            and not hasattr(out_placements[0], "is_shard")
            else [out_placements])
    # mesh dims along which the ranks compute different things: there a
    # replicated input's gradient is a partial sum
    varies = [any(not o[i].is_replicate() for o in outs)
              for i in range(device_mesh.ndim)]
    local = []
    for a, pl in zip(args, in_placements):
        if pl is None:
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, device_mesh, rep, run_check=False)
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(device_mesh, tuple(pl))
        grad_pl = tuple(Partial() if p.is_replicate() and v else p
                        for p, v in zip(pl, varies))
        x = a.to_local(grad_placements=grad_pl)
        if x.requires_grad:
            # the DTensor ops behind it view their gradients by the
            # global strides, which a local gradient must then have
            x.register_hook(torch.Tensor.contiguous)
        local.append(x)
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, device_mesh, tuple(pl),
                                        run_check=False)
                     for o, pl in zip(out, out_placements))
    return DTensor.from_local(out, device_mesh, tuple(out_placements),
                              run_check=False)


def batch_heads_placements(device_mesh: Any, batch: int,
                           heads: Sequence[int], head_dim: int = 2
                           ) -> Tuple[Tuple[Any, ...], Tuple[Any, ...]]:
    """(row, head) placements for a per-(batch row, head) body such as
    attention: ``row`` splits dim 0 over the data axes when their product
    divides ``batch``; ``head`` adds dim ``head_dim`` on 'model' when
    every count in ``heads`` divides it (so GQA groups stay whole)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(device_mesh.shape)))
    data = [a for a in ("pod", "data") if a in sizes]
    row = [Replicate()] * len(names)
    if data and batch % math.prod(sizes[a] for a in data) == 0:
        for a in data:
            row[names.index(a)] = Shard(0)
    head = list(row)
    if "model" in sizes and all(h % sizes["model"] == 0 for h in heads):
        head[names.index("model")] = Shard(head_dim)
    return tuple(row), tuple(head)


def summed_placements(row: Sequence[Any]) -> Tuple[Any, ...]:
    """The placements of a per-rank sum over the dims ``row`` shards:
    ``Partial`` (summed across ranks) where ``row`` shards, replicated
    elsewhere."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if p.is_shard() else Replicate() for p in row)


def like_placements(x: Any, like: Any) -> Any:
    """``x`` redistributed to ``like``'s placements when both are
    DTensors whose placements differ (a gradient's ``Partial`` sum
    becomes its parameter's layout); otherwise ``x`` itself."""
    if (is_dtensor(x) and is_dtensor(like)
            and tuple(x.placements) != tuple(like.placements)):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def gather_unless_divides(x: Any, dim: int, parts: int) -> Any:
    """``x`` with the mesh dims that shard ``dim`` gathered when their
    product does not divide ``parts`` (a reshape of ``dim`` into
    ``parts`` groups, heads for one, would split a shard); ``x`` itself
    otherwise, and for a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    on = [i for i, p in enumerate(x.placements)
          if p.is_shard() and p.dim % x.ndim == dim % x.ndim]
    if not on or parts % math.prod(x.device_mesh.size(i) for i in on) == 0:
        return x
    want = tuple(Replicate() if i in on else p
                 for i, p in enumerate(x.placements))
    return x.redistribute(x.device_mesh, want)


def gather_grad_unless_divides(x: Any, dim: int, parts: int) -> Any:
    """``x`` itself; on a DTensor that requires grad, its gradient is
    first passed through :func:`gather_unless_divides` — for a tensor
    whose dim ``dim`` merged ``parts`` groups, whose backward splits the
    gradient's dim back into them."""
    if is_dtensor(x) and x.requires_grad:
        x.register_hook(lambda g: gather_unless_divides(g, dim, parts))
    return x


def batch_only(x: Any) -> Any:
    """``x`` with only its batch (dim 0) split kept: a residual split
    along its sequence too (``residual_sharding(("data", "model",
    None))``) is gathered before the tensor-parallel products, as
    sequence parallelism gathers it; ``x`` itself otherwise."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = tuple(p if not p.is_shard() or p.dim % x.ndim == 0
                 else Replicate() for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)
