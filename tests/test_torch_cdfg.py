"""The port's CDFG walk against the JAX package's: ``analyze_kernel``
over ``make_fx`` graphs of the 12 torch scalar bodies against the
reference's jaxpr walk of its JAX bodies, the bodies' outputs, the walk's
rules on small paired bodies, and the loop nests that feed the synthesis
model.

Inputs come from seeded numpy and feed both packages.  Tolerance of the
bodies' outputs: max|d| / max(1, max|ref|) < 1e-6 in float32.  Facts and
loop nests are integers and compare exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch._higher_order_ops.scan import scan as t_scan
from torch._higher_order_ops.while_loop import while_loop as t_while_loop

import repro.apps.wami.cdfg as JC
import repro.apps.wami.components as J
import repro_torch.apps.wami.cdfg as TC
import repro_torch.apps.wami.components as T

NAMES = list(TC.WAMI_KERNEL_FACTS)
WALKED = [n for n in NAMES if n not in TC.PINNED_FACTS]
# the port's own walk of the torch hessian body, pinned: `triu_indices`
# (an op in no class: its width 42 and one level) and `index` (21, one
# level) stand where the JAX body traces into 8 `jit` equations of index
# arithmetic, a `scatter-add` and a `gather` (cdfg.PINNED_FACTS)
HESSIAN_WALK = (120, 3, 8)


def _fields(f):
    return (f.reads_per_input, f.writes, f.arith_ops, f.dep_depth,
            f.live_values)


@pytest.fixture(scope="module")
def comps():
    return T.build_components(), J.build_components()


@pytest.mark.parametrize("name", NAMES)
def test_walk_equals_reference_walk_and_table(name, comps):
    t, j = comps[0][name], comps[1][name]
    got = TC.analyze_kernel(t.kernel, t.kernel_args)
    want = JC.analyze_kernel(j.kernel, j.kernel_args)
    table = TC.WAMI_KERNEL_FACTS[name]
    assert _fields(table) == _fields(want)
    if name in TC.PINNED_FACTS:
        assert got.reads_per_input == want.reads_per_input
        assert got.writes == want.writes
        assert (got.arith_ops, got.dep_depth, got.live_values) == HESSIAN_WALK
        assert TC.component_facts(name, t.kernel, t.kernel_args) is table
    else:
        assert _fields(got) == _fields(want)
        assert got == table
        assert TC.component_facts(name, t.kernel, t.kernel_args) == table


def _body_inputs(name, rng, case):
    f32 = np.float32
    shapes = {"debayer": [(4, 4)], "grayscale": [(3,)], "gradient": [(5,)],
              "steep_descent": [(2,), (2,)], "hessian": [(6,), (21,)],
              "sd_update": [(6,), (), (6,)], "matrix_sub": [(), ()],
              "matrix_add": [(), ()], "matrix_mul": [(6,), (6,)],
              "matrix_resh": [()], "warp": [(4,), (2,)]}
    if name == "change_det":
        px = f32(rng.uniform(0, 100))
        # match: px within 2.5 sigma of mu[1] only; no match: of none
        off = [60.0, 3.0 if case == "match" else 90.0, -60.0]
        mu = (px + np.asarray(off)).astype(f32)
        var = rng.uniform(16, 36, size=3).astype(f32)
        w = rng.uniform(0.1, 1.0, size=3).astype(f32)
        return [np.asarray(px, f32), np.concatenate([mu, var, w / w.sum()])]
    if name == "warp":
        return [rng.uniform(0, 100, size=4).astype(f32),
                rng.uniform(0, 1, size=2).astype(f32)]
    return [np.asarray(rng.standard_normal(s) * 10.0, f32)
            for s in shapes[name]]


BODY_CASES = [(n, "") for n in NAMES if n != "change_det"] + [
    ("change_det", "match"), ("change_det", "no_match")]


@pytest.mark.parametrize("name,case", BODY_CASES,
                         ids=[f"{n}-{c}" if c else n for n, c in BODY_CASES])
def test_body_outputs_match_reference(name, case, comps):
    args = _body_inputs(name, np.random.default_rng(7), case)
    got = comps[0][name].kernel(*(torch.from_numpy(a) for a in args))
    want = np.asarray(comps[1][name].kernel(*(jnp.asarray(a) for a in args)))
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) / scale < 1e-6
    if name == "change_det":      # the foreground flag: 1 iff no match
        assert got[-1] == want[-1] == (1.0 if case == "no_match" else 0.0)


# (name, torch body, JAX body, argument shapes): each class of the rules
def _t_cond(x):
    return torch.cond(x.sum() > 0, lambda x: x.sin() + 1,
                      lambda x: x.cos() * 2 * x, (x,))


def _j_cond(x):
    return lax.cond(jnp.sum(x) > 0, lambda x: jnp.sin(x) + 1,
                    lambda x: jnp.cos(x) * 2 * x, x)


def _t_while(x):
    i = torch.zeros((), dtype=torch.int64)
    return t_while_loop(lambda i, s: i < 10, lambda i, s: (i + 1, s * 2),
                        (i, x))[1]


def _j_while(x):
    return lax.while_loop(lambda c: c[0] < 10,
                          lambda c: (c[0] + 1, c[1] * 2), (0, x))[1]


def _t_scan(x):
    return t_scan(lambda c, xi: (c + xi * 2, c.clone()), x[0] * 0, x)[0]


def _j_scan(x):
    return lax.scan(lambda c, xi: (c + xi * 2, c), x[0] * 0, x)[0]


RULE_PAIRS = [
    ("reduction", lambda x: torch.sum(x * x) + torch.amax(x),
     lambda x: jnp.sum(x * x) + jnp.max(x), [(7,)]),
    ("dot", lambda a, b: (a @ b) * 2, lambda a, b: jnp.dot(a, b) * 2,
     [(3, 4), (4, 2)]),
    ("matvec", lambda a, b: a @ b, lambda a, b: a @ b, [(3, 5), (5,)]),
    ("wiring", lambda a, b: torch.cat([a.reshape(6), b.reshape(6)])[None].t(),
     lambda a, b: jnp.concatenate([a.reshape(6), b.reshape(6)])[None].T,
     [(2, 3), (3, 2)]),
    ("unclassified", lambda x: torch.cumsum(torch.sin(x), 0) + 1,
     lambda x: jnp.cumsum(jnp.sin(x)) + 1, [(4,)]),
    ("cond", _t_cond, _j_cond, [(3,)]),
    ("while", _t_while, _j_while, [(3,)]),
    ("scan", _t_scan, _j_scan, [(4,)]),
]
# jax turns a cond's bool predicate into its int32 branch index with a
# `convert_element_type` equation, one more value than the aten graph
LIVE_OFFSET = {"cond": -1}


@pytest.mark.parametrize("label,t_body,j_body,shapes", RULE_PAIRS,
                         ids=[p[0] for p in RULE_PAIRS])
def test_walk_rules_equal_reference(label, t_body, j_body, shapes):
    got = TC.analyze_kernel(t_body, [torch.zeros(s) for s in shapes])
    want = JC.analyze_kernel(j_body, [jnp.zeros(s, jnp.float32)
                                      for s in shapes])
    assert _fields(got)[:4] == _fields(want)[:4]
    assert got.live_values == want.live_values + LIVE_OFFSET.get(label, 0)
    if label == "wiring":
        assert (got.arith_ops, got.dep_depth) == (1, 1)   # the floors


def test_cond_walks_the_false_branch_as_the_reference_does():
    def t_true_heavy(x):
        return torch.cond(x.sum() > 0, lambda x: torch.exp(x).exp().exp(),
                          lambda x: x + 1, (x,))

    def j_true_heavy(x):
        return lax.cond(jnp.sum(x) > 0, lambda x: jnp.exp(jnp.exp(
            jnp.exp(x))), lambda x: x + 1, x)

    got = TC.analyze_kernel(t_true_heavy, [torch.zeros(3)])
    want = JC.analyze_kernel(j_true_heavy, [jnp.zeros(3, jnp.float32)])
    # the sum (2 ops, 2 levels), `>` (1, 1), then the false branch's add
    # (3, 1) from depth 3, added to the depth it started from
    assert (got.arith_ops, got.dep_depth) == (want.arith_ops,
                                              want.dep_depth) == (6, 7)


@pytest.mark.parametrize("tile", [128, 64])
@pytest.mark.parametrize("name", WALKED)
def test_loop_nest_from_kernel_equals_reference(name, tile):
    t = T.build_components(tile=tile)[name]
    j = J.build_components(tile=tile)[name]
    for has_plm in (True, False):
        got = TC.loop_nest_from_kernel(t.kernel, t.kernel_args, trip=t.trip,
                                       has_plm_access=has_plm)
        want = JC.loop_nest_from_kernel(j.kernel, j.kernel_args,
                                        trip=j.trip, has_plm_access=has_plm)
        assert repr(got) == repr(want)


@pytest.mark.parametrize("tile", [128, 64])
@pytest.mark.parametrize("name", NAMES)
def test_component_loop_nest_equals_reference(name, tile):
    got = T.build_components(tile=tile)[name].loop_nest()
    want = J.build_components(tile=tile)[name].loop_nest()
    assert repr(got) == repr(want)


def test_only_hessian_reads_the_table(monkeypatch):
    """With every entry but hessian's gone, the 12 loop nests are the
    same: the 11 come from the walk."""
    comps = T.build_components()
    want = {n: repr(c.loop_nest()) for n, c in comps.items()}
    monkeypatch.setattr(TC, "WAMI_KERNEL_FACTS",
                        {"hessian": TC.WAMI_KERNEL_FACTS["hessian"]})
    TC.clear_facts_cache()
    assert {n: repr(c.loop_nest()) for n, c in comps.items()} == want


def test_walk_is_memoised_on_body_shapes_and_dtypes(monkeypatch):
    calls = []
    real = TC._analyze
    monkeypatch.setattr(TC, "_analyze",
                        lambda k, a: calls.append(k) or real(k, a))
    TC.clear_facts_cache()
    s = torch.zeros(())
    first = TC.analyze_kernel(T._k_mat_add, (s, s))
    assert TC.analyze_kernel(T._k_mat_add, (torch.ones(()), s)) is first
    wide = TC.analyze_kernel(T._k_mat_add, (torch.zeros(3), torch.zeros(3)))
    assert (wide.reads_per_input, wide.arith_ops) == ((3, 3), 3)
    assert TC.analyze_kernel(T._k_mat_add, (s.double(), s.double())) == first
    assert len(calls) == 3            # shapes and dtypes key the cache
    TC.clear_facts_cache()
    assert TC.analyze_kernel(T._k_mat_add, (s, s)) == first
    assert len(calls) == 4


def test_component_cdfg_extraction():
    """The mirror of tests/test_wami.py::test_component_cdfg_extraction."""
    comps = T.build_components(tile=64, frame=128)
    assert len(comps) == 12
    ln = comps["gradient"].loop_nest()
    assert ln.gamma_r == 5 and ln.gamma_w == 2      # 5-point stencil, 2 outs
    ln = comps["grayscale"].loop_nest()
    assert ln.gamma_r == 3 and ln.gamma_w == 1      # RGB in, luma out
    assert comps["change_det"].loop_nest().gamma_r == 1  # register-cached
