"""The CDFG walk's rules on common ops that no WAMI body uses, each as a
rule pair against the JAX package's ``analyze_kernel``.

``analyze_kernel`` is public: a new app's scalar body gets its facts
from it, and those facts price the HLS loop nests behind every
analytical front.  Three ops are walked as the reference walks them:

  * ``mean`` is decomposed into ``sum`` + ``div`` (jax's ``reduce_sum``
    and ``div``);
  * ``max`` / ``min`` over a dim, or over the whole tensor, are
    reductions (jax's ``reduce_max`` / ``reduce_min``); their ``other``
    overloads, the elementwise maximum and minimum, stay arithmetic;
  * every returned value is a write, one returned twice twice (the
    reference sums over the jaxpr's outvars).

Two ops differ by their IR, not by the walk, and hold a pinned offset
(port minus reference), as ``LIVE_OFFSET["cond"]`` is pinned in
``tests/test_torch_cdfg.py``:

  * softmax: aten holds one ``_softmax``, priced as one op of its width;
    jax traces ``reduce_max``, a ``max`` against ``-inf``,
    ``stop_gradient``, ``sub``, ``exp``, ``reduce_sum`` and ``div``
    (decomposing ``_softmax`` would still give (38, 9) against (39, 10));
  * indexing with a tensor: aten holds one ``index``, where jax adds the
    gather's index arithmetic (``lt``, ``add``, ``select_n``,
    ``broadcast``): ``hessian``'s case.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.apps.wami.cdfg as JC
import repro_torch.apps.wami.cdfg as TC


def _facts(f):
    return (f.reads_per_input, f.writes, f.arith_ops, f.dep_depth,
            f.live_values)


def _dup(y):
    z = y * 2
    return z, z


def _j_dup(y):
    z = y * 2
    return z, z


# (label, torch body, JAX body, argument shapes)
RULE_PAIRS = [
    ("mean", lambda x: x.mean(), lambda x: jnp.mean(x), [(8,)]),
    ("mean_dim", lambda x: x.mean(dim=1), lambda x: jnp.mean(x, axis=1),
     [(4, 6)]),
    ("max_dim", lambda x: x.max(dim=0).values,
     lambda x: jnp.max(x, axis=0), [(4, 3)]),
    ("min_dim", lambda x: x.min(dim=1).values + 1,
     lambda x: jnp.min(x, axis=1) + 1, [(4, 3)]),
    ("max_all", lambda x: x.max() * 2, lambda x: jnp.max(x) * 2, [(4, 3)]),
    ("duplicate_outputs", _dup, _j_dup, [(3,)]),
    ("softmax", lambda x: torch.softmax(x, 0),
     lambda x: jax.nn.softmax(x, 0), [(8,)]),
    ("tensor_index", lambda x: x[torch.tensor([0, 2])] + 1,
     lambda x: x[jnp.array([0, 2])] + 1, [(5,)]),
]
# port minus reference in (writes, arith_ops, dep_depth, live_values)
OFFSET = {
    "softmax": (0, 8 - 39, 1 - 10, 4 - 9),
    "tensor_index": (0, 4 - 10, 2 - 4, 4 - 6),
}


def _pair(t_body, j_body, shapes):
    TC.clear_facts_cache()
    got = TC.analyze_kernel(t_body, [torch.zeros(s) for s in shapes])
    want = JC.analyze_kernel(j_body, [jnp.zeros(s, jnp.float32)
                                      for s in shapes])
    return got, want


@pytest.mark.parametrize("label,t_body,j_body,shapes", RULE_PAIRS,
                         ids=[p[0] for p in RULE_PAIRS])
def test_rule_pair_against_reference(label, t_body, j_body, shapes):
    got, want = _pair(t_body, j_body, shapes)
    assert got.reads_per_input == want.reads_per_input
    off = OFFSET.get(label, (0, 0, 0, 0))
    assert _facts(got)[1:] == tuple(w + o for w, o in
                                    zip(_facts(want)[1:], off))


def test_five_common_bodies_read_as_measured():
    """The five bodies' facts as (writes, arith, depth, live), port and
    reference: the first three equal, the last two at their offsets."""
    table = {"mean": ((1, 8, 4, 4), (1, 8, 4, 4)),
             "max_dim": ((3, 11, 4, 4), (3, 11, 4, 4)),
             "duplicate_outputs": ((6, 3, 1, 4), (6, 3, 1, 4)),
             "softmax": ((8, 8, 1, 4), (8, 39, 10, 9)),
             "tensor_index": ((2, 4, 2, 4), (2, 10, 4, 6))}
    pairs = {p[0]: p[1:] for p in RULE_PAIRS}
    for label, (port, ref) in table.items():
        got, want = _pair(*pairs[label])
        assert _facts(got)[1:] == port, label
        assert _facts(want)[1:] == ref, label


def test_max_other_stays_elementwise():
    """``torch.max(a, b)`` is the elementwise maximum: one op of its
    width, one level, as jax's ``max``; not a reduction."""
    got, want = _pair(lambda a, b: torch.max(a, b) + torch.min(a, b),
                      lambda a, b: jnp.maximum(a, b) + jnp.minimum(a, b),
                      [(3,), (3,)])
    assert _facts(got) == _facts(want)
    assert (got.arith_ops, got.dep_depth) == (9, 2)


def test_distinct_outputs_each_count():
    """Two distinct returned values are both writes, as one returned
    twice is."""
    got, want = _pair(lambda a, b: (a + 1, b * 2),
                      lambda a, b: (a + 1, b * 2), [(3,), (5,)])
    assert _facts(got) == _facts(want)
    assert got.writes == 8

