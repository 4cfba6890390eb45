"""The port's checkpoint store and ``AsyncCheckpointer`` (mirrors of
``tests/test_substrate.py``'s checkpoint tests), its NamedTuple paths,
NamedTuple restore and bfloat16 round trip, and directories written by
either package restored by the other."""

import os
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as ref_restore
from repro.checkpoint import save as ref_save
from repro.optim import init_opt as ref_init_opt
from repro.utils import keystr_path as ref_keystr_path
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    list_steps, restore, save)
from repro_torch.optim import OptState, init_opt, init_opt_q8
from repro_torch.utils import leaves_with_paths
from torch_lm_reference import torch_one_thread  # noqa: F401  (autouse)


def _tree():
    return {"layer": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                      "b": np.ones(4, np.float32)},
            "step_count": np.int32(5)}


def test_checkpoint_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        save(d, 10, _tree(), extra={"data_step": 10})
        out, extra = restore(d, 10, _tree())
        assert extra == {"data_step": 10}
        np.testing.assert_array_equal(out["layer"]["w"], _tree()["layer"]["w"])


def test_checkpoint_atomicity_ignores_torn_tmp():
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, _tree())
        os.makedirs(os.path.join(d, "step_00000002.tmp"))
        assert latest_step(d) == 1
        assert list_steps(d) == [1]


def test_checkpoint_latest_pointer_fallback():
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, _tree())
        save(d, 2, _tree())
        os.remove(os.path.join(d, "LATEST"))
        assert latest_step(d) == 2


def test_checkpoint_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, _tree())
        bad = _tree()
        bad["layer"]["w"] = np.zeros((2, 2), np.float32)
        with pytest.raises(ValueError):
            restore(d, 1, bad)


def test_async_checkpointer_gc():
    with tempfile.TemporaryDirectory() as d:
        with AsyncCheckpointer(d, keep_last=2) as ck:
            for s in (1, 2, 3, 4):
                ck.save_async(s, _tree())
        assert list_steps(d) == [3, 4]


def test_async_checkpointer_raises_a_failed_write_on_wait():
    with tempfile.TemporaryDirectory() as d:
        blocker = os.path.join(d, "file")
        open(blocker, "w").close()
        ck = AsyncCheckpointer(os.path.join(blocker, "root"))
        ck.save_async(1, _tree())
        with pytest.raises(OSError):
            ck.wait()
        ck.wait()                       # the error is raised once


def test_async_checkpointer_snapshots_before_returning():
    """A tensor changed after ``save_async`` returns is saved as it was."""
    t = torch.arange(6, dtype=torch.float32)
    with tempfile.TemporaryDirectory() as d:
        with AsyncCheckpointer(d) as ck:
            ck.save_async(1, {"t": t})
            t.add_(100.0)
        out, _ = restore(d, 1, {"t": torch.zeros(6)})
        assert torch.equal(out["t"], torch.arange(6, dtype=torch.float32))


# ----------------------------------------------------------------------
# the store's repaired faults
# ----------------------------------------------------------------------
def _opt_tree(mod):
    params = {"a": mod.zeros((2, 3)), "b": {"c": mod.zeros((4,))}}
    return params


def test_namedtuple_fields_are_named_as_jax_names_them():
    """``{"opt": OptState}`` flattens to ``opt/step``, ``opt/mu/a``...: the
    JAX package's paths (``GetAttrKey``), in its order."""
    params = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)}}
    got = [p for p, _ in leaves_with_paths({"opt": init_opt(params)})]
    ref_params = {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros((4,))}}
    want = [ref_keystr_path(kp) for kp, _ in
            jax.tree_util.tree_flatten_with_path(
                {"opt": ref_init_opt(ref_params)})[0]]
    assert got == want
    assert got[:3] == ["opt/step", "opt/mu/a", "opt/mu/b/c"]
    # plain tuples and lists keep their indices
    assert [p for p, _ in leaves_with_paths({"t": (1, [2, 3])})] == [
        "t/0", "t/1/0", "t/1/1"]


def test_namedtuple_state_restores():
    params = {"a": torch.randn(2, 3), "b": {"c": torch.randn(4)}}
    opt = init_opt(params)
    opt.mu["a"].add_(1.5)
    q8 = init_opt_q8(params)
    q8.mu_q["a"].add_(3)
    with tempfile.TemporaryDirectory() as d:
        save(d, 3, {"params": params, "opt": opt, "q8": q8})
        out, _ = restore(d, 3, {"params": params, "opt": init_opt(params),
                                "q8": init_opt_q8(params)})
    assert isinstance(out["opt"], OptState)
    assert torch.equal(out["opt"].mu["a"], opt.mu["a"])
    assert out["opt"].step.dtype == torch.int32
    assert type(out["q8"]) is type(q8)
    assert torch.equal(out["q8"].mu_q["a"], q8.mu_q["a"])
    assert out["q8"].mu_q["a"].dtype == torch.int8


def _bf16_values():
    return np.random.default_rng(0).standard_normal((2, 3)).astype(
        ml_dtypes.bfloat16)


def test_bfloat16_leaf_round_trips_bit_for_bit():
    arr = _bf16_values()
    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, {"t": t, "a": arr})
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            manifest = f.read()
        assert manifest.count('"dtype": "bfloat16"') == 2
        # the JAX package's file layout: the raw bits as |V2
        assert np.load(os.path.join(d, "step_00000001", "t.npy")).dtype.str \
            == "|V2"
        like = {"t": torch.zeros(2, 3, dtype=torch.bfloat16),
                "a": np.zeros((2, 3), ml_dtypes.bfloat16)}
        out, _ = restore(d, 1, like)
        as_f32, _ = restore(d, 1, {"t": torch.zeros(2, 3),
                                   "a": np.zeros((2, 3), np.float32)})
    assert out["t"].dtype == torch.bfloat16
    assert torch.equal(out["t"].view(torch.int16), t.view(torch.int16))
    assert out["a"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(out["a"].view(np.int16), arr.view(np.int16))
    want = arr.astype(np.float32)
    assert np.array_equal(as_f32["t"].numpy(), want)
    assert np.array_equal(as_f32["a"], want)


# ----------------------------------------------------------------------
# across packages
# ----------------------------------------------------------------------
def _params_np(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((8, 4)).astype(dtype),
            "layers": {"w": rng.standard_normal((2, 4, 4)).astype(dtype),
                       "scale": rng.standard_normal((2, 4)).astype(dtype)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_the_port(dtype):
    """``{"params", "opt"}`` saved by the JAX package (bf16 parameters
    included, which it cannot read back itself) restores into the
    port's tensors with equal values."""
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    pn = _params_np(1, np_dt)
    jp = jax.tree.map(jnp.asarray, pn)
    opt = ref_init_opt(jp)
    opt = opt._replace(step=jnp.asarray(7, jnp.int32),
                       mu=jax.tree.map(lambda x: x + 0.25, opt.mu))
    tdt = getattr(torch, dtype)
    like_p = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=tdt), pn)
    like = {"params": like_p, "opt": init_opt(like_p)}
    with tempfile.TemporaryDirectory() as d:
        ref_save(d, 7, {"params": jp, "opt": opt}, extra={"data_step": 7})
        out, extra = restore(d, 7, like)
    assert extra == {"data_step": 7}
    assert int(out["opt"].step) == 7
    for path, t in leaves_with_paths(out["params"]):
        want = pn
        for k in path.split("/"):
            want = want[k]
        assert t.dtype == tdt
        assert np.array_equal(t.float().numpy(), want.astype(np.float32))
    for t in jax.tree.leaves(out["opt"].mu):
        assert torch.equal(t, torch.full_like(t, 0.25))


def test_port_checkpoint_restores_into_jax():
    """The reverse, in float32 (the JAX package cannot restore a bf16
    leaf: ROADMAP Queue 3)."""
    pn = _params_np(2)
    params = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                  {kk: torch.from_numpy(vv) for kk, vv in v.items()})
              for k, v in pn.items()}
    opt = init_opt(params)
    opt.nu["embed"].add_(2.0)
    opt = opt._replace(step=torch.tensor(4, dtype=torch.int32))
    jp = jax.tree.map(jnp.asarray, pn)
    with tempfile.TemporaryDirectory() as d:
        save(d, 4, {"params": params, "opt": opt})
        out, _ = ref_restore(d, 4, {"params": jp, "opt": ref_init_opt(jp)})
    assert int(out["opt"].step) == 4
    np.testing.assert_array_equal(out["params"]["layers"]["w"],
                                  pn["layers"]["w"])
    np.testing.assert_array_equal(out["opt"].nu["embed"],
                                  np.full((8, 4), 2.0, np.float32))
