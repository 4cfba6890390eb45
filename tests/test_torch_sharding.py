"""The port's sharding rules against the JAX package's, on every arch's
full config at both production meshes (the mirror of
``tests/test_sharding_rules.py``).

The reference resolves against a ``jax.sharding.AbstractMesh`` (no
256-device runtime); the port against a stand-in whose ``shape`` is the
same name-to-size map.  Parameter trees are shapes only on both sides
(``jax.eval_shape``, meta tensors)."""

import types

import jax
import pytest
from jax._src.named_sharding import DuplicateSpecError
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.dist import sharding as J
from repro.models import decode_specs as j_decode_specs
from repro.models import params_specs as j_params_specs
from repro.models import prefill_specs as j_prefill_specs
from repro.models import train_batch_specs as j_train_batch_specs

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.dist import sharding as T
from repro_torch.models import (decode_specs, params_specs, prefill_specs,
                                train_batch_specs)
from repro_torch.utils import leaves_with_paths

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
TRAIN, PREFILL, DECODE, LONG = SHAPES


def _meshes(kind):
    sizes, names = MESHES[kind]
    return (AbstractMesh(sizes, names),
            types.SimpleNamespace(shape=dict(zip(names, sizes))))


def _j_flat(tree):
    """(path, leaf) of a JAX tree of shardings, specs or shapes."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    from repro.utils import keystr_path
    return [(keystr_path(kp), leaf) for kp, leaf in flat]


def _spec(ns):
    return tuple(ns.spec)


def _rules(family, cfg):
    two_d = family == "moe" and cfg.param_count() > 2e11
    return two_d, (J.lm_rules(family, two_d_experts=two_d),
                   T.lm_rules(family, two_d_experts=two_d))


@pytest.fixture(scope="module")
def param_trees():
    """Each arch's full parameter tree on both sides (shapes only)."""
    return {a: (j_params_specs(j_get_config(a)), params_specs(get_config(a)))
            for a in list_archs()}


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_reference(param_trees, arch, kind):
    j_mesh, t_mesh = _meshes(kind)
    cfg = get_config(arch)
    j_params, t_params = param_trees[arch]
    two_d, (j_rules, t_rules) = _rules(cfg.family, cfg)
    j_paths = _j_flat(J.tree_paths(j_params))
    t_paths = leaves_with_paths(T.tree_paths(t_params))
    assert [p for p, _ in t_paths] == [p for _, p in j_paths]
    assert [p for p, _ in t_paths] == [p for p, _ in j_paths]
    j_specs = _j_flat(j_rules.tree(j_params, j_mesh))
    t_specs = leaves_with_paths(t_rules.tree(t_params, t_mesh))
    j_leaves = dict(_j_flat(j_params))
    for (path, t_spec), (_, j_ns) in zip(t_specs, j_specs):
        shape = tuple(j_leaves[path].shape)
        want = J._resolve(j_rules.axes_for(path, len(shape)), j_mesh, shape)
        assert isinstance(t_spec, T.PartitionSpec)
        assert tuple(t_spec) == tuple(want) == _spec(j_ns), path
        # ZeRO-1 moment specs
        t_z = tuple(T.zero1_spec(t_spec, shape, t_mesh))
        try:
            j_z = _spec(J.zero1_spec(j_ns, shape, j_mesh))
        except DuplicateSpecError:
            # the reference adds 'data' to a 2-D expert spec that holds
            # it already; the port keeps the parameter's spec
            assert two_d and "data" in {n for ax in t_spec
                                        for n in J._axis_names(ax)}, path
            assert t_z == tuple(t_spec), path
            continue
        assert t_z == j_z, path


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_equal_reference(arch, kind):
    j_mesh, t_mesh = _meshes(kind)
    j_cfg, cfg = j_get_config(arch), get_config(arch)
    for shape, j_fn, t_fn in ((TRAIN, j_train_batch_specs, train_batch_specs),
                              (PREFILL, j_prefill_specs, prefill_specs)):
        want = {p: _spec(s) for p, s in _j_flat(
            J.batch_spec(j_fn(j_cfg, shape), j_mesh))}
        got = {p: tuple(s) for p, s in leaves_with_paths(
            T.batch_spec(t_fn(cfg, shape), t_mesh))}
        assert got == want, shape.name
    for shape in (DECODE, LONG):
        j_tok, j_cache = j_decode_specs(j_cfg, shape)
        t_tok, t_cache = decode_specs(cfg, shape)
        want = _spec(J.batch_spec({"tokens": j_tok}, j_mesh)["tokens"])
        assert tuple(T.batch_spec({"tokens": t_tok}, t_mesh)["tokens"]) \
            == want
        for seq_shard in (False, True):
            want = {p: _spec(s) for p, s in _j_flat(
                J.cache_spec(j_cache, j_mesh, seq_shard=seq_shard))}
            got = {p: tuple(s) for p, s in leaves_with_paths(
                T.cache_spec(t_cache, t_mesh, seq_shard=seq_shard))}
            assert got == want, (shape.name, seq_shard)


def test_resolve_rules_match_reference():
    """The rule half at the reference's own small cases: unknown axes,
    divisibility, left padding, 2-D experts."""
    j_mesh, t_mesh = _meshes("pod")
    cases = [(("data", None), None), (("model",), None),
             (("bogus", None), None), (("data",), (7,)), (("data",), (32,)),
             ((("pod", "data"), None, "model"), (32, 5, 48))]
    for axes, shape in cases:
        assert tuple(T._resolve(axes, t_mesh, shape)) == \
            tuple(J._resolve(axes, j_mesh, shape))
    for fam, two_d in (("dense", False), ("moe", False), ("moe", True)):
        jr = J.lm_rules(fam, two_d_experts=two_d)
        tr = T.lm_rules(fam, two_d_experts=two_d)
        for path, ndim in (("embed", 2), ("layers/attn/wq", 3),
                           ("layers/mlp/w_down", 3), ("final_norm/scale", 1),
                           ("layers/moe/w_gate", 4), ("layers/moe/w_down", 4),
                           ("layers/ssm/in_proj", 3), ("head", 2)):
            assert tr.axes_for(path, ndim) == jr.axes_for(path, ndim)


def test_placements_split_in_row_major_order():
    """A dim on ("pod", "data") is split over both mesh dims, pod major:
    JAX's order of a multi-axis partition."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_offset
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    pl = T.placements(T.PartitionSpec(("pod", "data"), None, "model"), mesh)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert T.placements(T.PartitionSpec(None, None), mesh) == \
        (Replicate(),) * 3
    for p in range(2):
        for d in range(4):
            shape, off = local_offset((16, 3, 8), (2, 4, 2), [p, d, 1], pl)
            assert shape == (2, 3, 4)
            assert off == ((p * 4 + d) * 2, 0, 4)
    with pytest.raises(ValueError):
        T.placements(T.PartitionSpec(("data", "pod")), mesh)
    with pytest.raises(ValueError):     # one mesh axis on two dims
        T.placements(T.PartitionSpec("data", ("pod", "data")), mesh)


def test_zero1_keeps_a_spec_that_holds_the_data_axes():
    """kimi-k2's 2-D expert weights already split a dim over 'data': the
    moment keeps the parameter's spec (the reference's ``zero1_spec``
    adds 'data' a second time, which JAX rejects)."""
    _, t_mesh = _meshes("multipod")
    spec = T.PartitionSpec(None, "model", None, "data")
    got = T.zero1_spec(spec, (60, 384, 7168, 2048), t_mesh)
    assert got == spec
    T.placements(got, types.SimpleNamespace(
        mesh_dim_names=("pod", "data", "model")))


def test_specs_are_tree_leaves():
    tree = {"a": T.PartitionSpec("data", None), "b": [T.PartitionSpec()]}
    assert [p for p, _ in leaves_with_paths(tree)] == ["a", "b/0"]
    assert T.tree_paths({"a": {"b": 1}, "c": [2, 3]}) == \
        {"a": {"b": "a/b"}, "c": ["c/0", "c/1"]}


def test_constrain_is_identity_without_a_mesh():
    import torch
    x = torch.zeros(4, 8, 2)
    assert T.constrain(x, ("data", "model", None)) is x
    with T.mesh_context(types.SimpleNamespace(shape={"data": 2})):
        assert T.constrain(x, ("data", None, None)) is x   # not a DTensor
