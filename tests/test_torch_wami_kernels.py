"""The PyTorch WAMI kernels' wrappers against the JAX package's.

On the CPU a wrapper runs its kernel's plain version (the CUDA kernel
itself is held against that plain version on the card by
``chip_smoke.py``).  Inputs come from seeded numpy and feed both
packages.  Tolerance: the reference's ``_close`` —
max|Δ| / max(1, max|ref|) < 1e-5, and 1e-4 for the Hessian, whose sum
order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import wami_gradient as jgrad
from repro.kernels import wami_grayscale as jgray
from repro.kernels import wami_steep as jsteep
from repro_torch.apps.wami.knobs import WAMI_KNOB_TABLE
from repro_torch.core.knobs import powers_of_two
from repro_torch.kernels import wami_gradient as tgrad
from repro_torch.kernels import wami_grayscale as tgray
from repro_torch.kernels import wami_steep as tsteep

TILE = 128
KNOBS = [(1, 1), (4, 8), (16, 32)]          # (ports, unrolls)
SD_KNOBS = [(1, 1), (4, 8), (8, 16)]        # steep_descent: max_ports 8


def _close(a, b, tol=1e-5):
    fa, fb = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(fb).max()))
    assert float(np.abs(fa - fb).max()) / scale < tol


def _inputs(shape, seed=7):
    rng = np.random.default_rng(seed)
    H, W = shape
    return {
        "rgb": (rng.uniform(size=(H, W, 3)) * 255.0).astype(np.float32),
        "gray": (rng.uniform(size=(H, W)) * 255.0).astype(np.float32),
        "gx": rng.standard_normal((H, W)).astype(np.float32),
        "gy": rng.standard_normal((H, W)).astype(np.float32),
        "sd": rng.standard_normal((H, W, 6)).astype(np.float32),
    }


# (name, port op, jax oracle, jax pallas op, input names, tolerance)
CASES = {
    "grayscale": (tgray.grayscale, jgray.grayscale_oracle, jgray.grayscale,
                  ("rgb",), 1e-5),
    "gradient": (tgrad.gradient, jgrad.gradient_oracle, jgrad.gradient,
                 ("gray",), 1e-5),
    "steep_descent": (tsteep.steepest_descent,
                      jsteep.steepest_descent_oracle,
                      jsteep.steepest_descent, ("gx", "gy"), 1e-5),
    "hessian": (tsteep.hessian, jsteep.hessian_oracle, jsteep.hessian,
                ("sd",), 1e-4),
}


def _flat(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _check(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.numpy(), np.asarray(w), tol)


@pytest.mark.parametrize("name,ports,unrolls", [
    (n, p, u) for n in CASES
    for p, u in (SD_KNOBS if n == "steep_descent" else KNOBS)])
def test_port_op_matches_jax_oracle_at_tile(name, ports, unrolls):
    op, oracle, _, args, tol = CASES[name]
    x = _inputs((TILE, TILE))
    got = op(*(torch.from_numpy(x[a]) for a in args), ports=ports,
             unrolls=unrolls)
    _check(got, oracle(*(jnp.asarray(x[a]) for a in args)), tol)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CASES))
def test_port_op_matches_jax_pallas_interpret(name):
    """The JAX Pallas kernel, run in interpret mode on the CPU, at a
    small shape with a knob point that splits both axes."""
    op, _, pallas_op, args, tol = CASES[name]
    x = _inputs((32, 64), seed=11)
    got = op(*(torch.from_numpy(x[a]) for a in args), ports=2, unrolls=8)
    want = pallas_op(*(jnp.asarray(x[a]) for a in args), ports=2,
                     unrolls=8, interpret=True)
    _check(got, want, tol)


COST_MODELS = {
    "grayscale": ((tgray.vmem_bytes, jgray.vmem_bytes),
                  (tgray.grid_steps, jgray.grid_steps)),
    "gradient": ((tgrad.vmem_bytes, jgrad.vmem_bytes),
                 (tgrad.grid_steps, jgrad.grid_steps)),
    "steep_descent": ((tsteep.vmem_bytes, jsteep.vmem_bytes),
                      (tsteep.grid_steps, jsteep.grid_steps)),
    "hessian": ((tsteep.hessian_vmem_bytes, jsteep.hessian_vmem_bytes),
                (tsteep.grid_steps, jsteep.grid_steps)),
}


@pytest.mark.parametrize("name", sorted(COST_MODELS))
def test_cost_models_equal_reference_over_table1(name):
    max_ports, max_unrolls = WAMI_KNOB_TABLE[name]
    n = 0
    for H, W in ((TILE, TILE), (512, 512)):
        for ports in powers_of_two(1, max_ports):
            for unrolls in range(1, max_unrolls + 1):
                for port_fn, ref_fn in COST_MODELS[name]:
                    assert (port_fn(H, W, ports=ports, unrolls=unrolls)
                            == ref_fn(H, W, ports=ports, unrolls=unrolls))
                    n += 1
    assert n > 0


def test_cpu_tensors_never_launch_a_kernel():
    kernels = (tgray.grayscale_kernel, tgrad.gradient_kernel,
               tsteep.steepest_descent_kernel, tsteep.hessian_kernel)
    before = [k.launches for k in kernels]
    x = _inputs((32, 32))
    tgray.grayscale(torch.from_numpy(x["rgb"]), ports=2, unrolls=4)
    tgrad.gradient(torch.from_numpy(x["gray"]), ports=2, unrolls=4)
    tsteep.steepest_descent(torch.from_numpy(x["gx"]),
                            torch.from_numpy(x["gy"]), ports=2, unrolls=4)
    tsteep.hessian(torch.from_numpy(x["sd"]), ports=2, unrolls=4)
    assert [k.launches for k in kernels] == before == [0, 0, 0, 0]


@pytest.mark.parametrize("ports,unrolls", [(3, 4), (2, 5), (0, 4)])
def test_non_dividing_knobs_raise(ports, unrolls):
    gray = torch.zeros((32, 32))
    with pytest.raises(ValueError):
        tgrad.gradient(gray, ports=ports, unrolls=unrolls)


def test_hessian_plain_version_is_symmetric_and_knob_free():
    sd = torch.from_numpy(_inputs((TILE, TILE))["sd"])
    outs = [tsteep.hessian(sd, ports=p, unrolls=u)
            for p, u in ((1, 32), (2, 4), (16, 1))]
    for o in outs[1:]:
        _close(o.numpy(), outs[0].numpy(), 1e-4)
    _close(outs[0].numpy(), outs[0].numpy().T, 1e-4)


@pytest.mark.parametrize("kernel", [
    tgray.grayscale_kernel, tgrad.gradient_kernel,
    tsteep.steepest_descent_kernel, tsteep.hessian_kernel],
    ids=lambda k: k.symbol)
def test_binding_matches_the_c_entry_point(kernel):
    """Each ctypes binding declares one argtype per parameter of its
    exported C function, pointers as c_void_p and ints as c_int (the C
    source is parsed; it cannot be compiled here)."""
    import ctypes
    import os
    import re
    from repro_torch.kernels.build import CSRC_DIR, SOURCES
    assert kernel.library in SOURCES
    with open(os.path.join(CSRC_DIR, f"{kernel.library}.cu")) as f:
        src = f.read()
    m = re.search(r"WAMI_EXPORT int " + kernel.symbol + r"\(([^)]*)\)", src)
    assert m, f"{kernel.symbol} not exported by {kernel.library}.cu"
    params = [p.strip() for p in m.group(1).split(",")]
    want = [ctypes.c_int if p.startswith("int ") else ctypes.c_void_p
            for p in params]
    assert all(p.startswith("int ") or "*" in p for p in params), params
    assert kernel.argtypes == want
