"""The PyTorch fleet kernels' wrappers against the JAX package's.

On the CPU a wrapper runs its kernel's plain version (the CUDA kernel
itself is held against that plain version on the card by
``chip_smoke.py``).  Inputs come from seeded numpy and feed both
packages.  Tolerances are the reference's (``tests/test_kernels.py``):
max|Δ| < 2e-5 in float32 and 2e-2 in bfloat16 for attention, 1e-4 for
the SSD scan's y and final state.
"""

import ctypes
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.fleet.pipeline as JF
from repro.kernels.flash_attention import mha as j_mha, mha_ref as j_mha_ref
from repro.kernels.ssd_scan import ssd as j_ssd, ssd_oracle as j_ssd_oracle
import repro_torch.apps.fleet.pipeline as TF
from repro_torch.kernels.build import CSRC_DIR, SOURCES
from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                 flash_smem_bytes, mha,
                                                 mha_ref)
from repro_torch.kernels.ssd_scan import (ssd, ssd_chunked_ref,
                                          ssd_heads_per_cta, ssd_oracle,
                                          ssd_p_split, ssd_scan_kernel,
                                          ssd_scratch_floats, ssd_smem_bytes)

FLASH_SHAPES = [
    (1, 128, 128, 4, 4, 64),       # MHA
    (2, 128, 128, 8, 2, 64),       # GQA 4:1
    (1, 256, 256, 4, 2, 32),       # small head dim
    (1, 128, 256, 4, 2, 64),       # Sq < Skv (chunked prefill)
]
SSD_SHAPES = [
    (2, 128, 4, 32, 64, 32),
    (1, 256, 2, 64, 128, 128),
    (2, 64, 8, 16, 32, 64),        # chunk == S (single chunk)
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SMEM_H100 = 232448                 # an H100's opt-in smem per block


def _flash_inputs(B, Sq, Skv, H, K, d, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, Sq, H, d), (B, Skv, K, d),
                               (B, Skv, K, d)))


def _ssd_inputs(Bz, S, H, P, N, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(a.astype(np.float32) for a in (
        rng.standard_normal((Bz, S, H, P)),
        np.logaddexp(0.0, rng.standard_normal((Bz, S, H)) * 0.5),
        -np.exp(rng.standard_normal((H,)) * 0.3),
        rng.standard_normal((Bz, S, N)) * 0.3,
        rng.standard_normal((Bz, S, N)) * 0.3))


def _both(arrays, dtype):
    """The same numpy arrays as torch tensors and jax arrays of
    ``dtype`` ("float32" or "bfloat16")."""
    t = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    j = tuple(jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays)
    return t, j


def _max_err(got, want):
    return float(np.abs(got.float().numpy()
                        - np.asarray(want.astype(jnp.float32))).max())


@pytest.mark.parametrize("B,Sq,Skv,H,K,d", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_oracle(B, Sq, Skv, H, K, d, dtype):
    t, j = _both(_flash_inputs(B, Sq, Skv, H, K, d), dtype)
    off = Skv - Sq
    got = mha(*t, q_offset=off, block_q=64, block_kv=64)
    assert got.dtype == t[0].dtype and tuple(got.shape) == (B, Sq, H, d)
    assert _max_err(got, j_mha_ref(*j, q_offset=off)) < TOL[dtype]


@pytest.mark.parametrize("window,softcap", [(64, 0.0), (0, 30.0),
                                            (32, 20.0)])
def test_flash_window_softcap_matches_jax_oracle(window, softcap):
    t, j = _both(_flash_inputs(1, 128, 128, 4, 2, 64), "float32")
    got = mha(*t, window=window, softcap=softcap, block_q=64, block_kv=64)
    want = j_mha_ref(*j, window=window, softcap=softcap)
    assert _max_err(got, want) < TOL["float32"]


def test_flash_head_dim_256_matches_jax_oracle():
    """gemma2-9b's head dim, its window and soft-cap, GQA 2:1, bf16."""
    t, j = _both(_flash_inputs(1, 128, 128, 4, 2, 256, seed=9), "bfloat16")
    kw = dict(window=64, softcap=50.0)
    assert _max_err(mha(*t, block_q=64, block_kv=32, **kw),
                    j_mha_ref(*j, **kw)) < TOL["bfloat16"]


def test_flash_plain_is_block_invariant():
    t, _ = _both(_flash_inputs(1, 256, 256, 4, 2, 64), "float32")
    outs = [mha(*t, block_q=bq, block_kv=bk)
            for bq, bk in ((64, 64), (128, 128), (64, 256), (256, 64))]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("Bz,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_plain_matches_jax_oracle(Bz, S, H, P, N, chunk):
    t, j = _both(_ssd_inputs(Bz, S, H, P, N), "float32")
    y, h = ssd(*t, chunk=chunk)
    jy, jh = j_ssd_oracle(*j)
    assert y.dtype == h.dtype == torch.float32
    assert tuple(h.shape) == (Bz, H, P, N)
    assert _max_err(y, jy) < 1e-4
    assert _max_err(h, jh) < 1e-4


def test_ssd_oracle_is_the_plain_version():
    t, _ = _both(_ssd_inputs(1, 64, 2, 16, 32), "float32")
    for a, b in zip(ssd(*t, chunk=16), ssd_oracle(*t)):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _fleet_ssd_lanes(heads):
    """The fleet parity inputs (S 256, P 64, N 64) cut to ``heads`` head
    lanes, as torch tensors, and the JAX oracle's (y, h_final) on them."""
    _, _, _, args = TF.fleet_cuda_parity_cases(TF.SSD_S, device="cpu")[1]
    x, dt, A, Bm, Cm = args
    lanes = (x[:, :, :heads].contiguous(), dt[:, :, :heads].contiguous(),
             A[:heads].contiguous(), Bm, Cm)
    return lanes, j_ssd_oracle(*(jnp.asarray(a.numpy()) for a in lanes))


@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_ssd_chunked_decomposition_matches_jax_oracle(chunk, heads):
    """The CUDA kernel's three passes (chunk terms, sequential state
    pass, output), in plain PyTorch, at every chunk and head count the
    fleet DSE times: chunk 8 carries the state across 32 chunks."""
    lanes, (jy, jh) = _fleet_ssd_lanes(heads)
    y, h = ssd_chunked_ref(*lanes, chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    assert tuple(h.shape) == (1, heads, TF.SSD_P, TF.SSD_N)
    assert _max_err(y, jy) < 1e-4
    assert _max_err(h, jh) < 1e-4


@pytest.mark.slow
def test_flash_matches_jax_pallas_interpret_at_fleet_geometry():
    """The JAX Pallas kernel, run in interpret mode, at the fleet parity
    geometry (S 128, 2 query heads on one KV head, d 64) and a knob point
    that splits both axes."""
    name, op, _, args = TF.fleet_cuda_parity_cases(128, device="cpu")[0]
    assert name == "flash_attention"
    j = tuple(jnp.asarray(a.numpy()) for a in args)
    got = op(*args, ports=2, unrolls=2)
    want = j_mha(*j, causal=True, block_q=64, block_kv=32, use_pallas=True,
                 interpret=True)
    assert _max_err(got, want) < TOL["float32"]


@pytest.mark.slow
def test_ssd_matches_jax_pallas_interpret_at_fleet_geometry():
    name, op, _, args = TF.fleet_cuda_parity_cases(128, device="cpu")[1]
    assert name == "ssd_scan"
    j = tuple(jnp.asarray(a.numpy()) for a in args)
    y, h = op(*args, ports=1, unrolls=4)
    jy, jh = j_ssd(*j, chunk=32, use_pallas=True, interpret=True)
    assert _max_err(y, jy) < 1e-4
    assert _max_err(h, jh) < 1e-4


@pytest.mark.slow
def test_ssd_chunked_decomposition_matches_jax_pallas_interpret():
    """The chunked passes against the JAX Pallas kernel in interpret mode
    at one fleet point (S 128, 8 heads, chunk 32: unrolls 4)."""
    _, _, _, args = TF.fleet_cuda_parity_cases(128, device="cpu")[1]
    j = tuple(jnp.asarray(a.numpy()) for a in args)
    y, h = ssd_chunked_ref(*args, chunk=32)
    jy, jh = j_ssd(*j, chunk=32, use_pallas=True, interpret=True)
    assert _max_err(y, jy) < 1e-4
    assert _max_err(h, jh) < 1e-4


@pytest.mark.parametrize("fn", ["flash_vmem_bytes", "flash_grid_steps",
                                "ssd_vmem_bytes", "ssd_grid_steps"])
def test_cost_models_equal_reference_over_the_knob_grid(fn):
    port, ref = getattr(TF, fn), getattr(JF, fn)
    shape = ((TF.FLASH_S, TF.FLASH_S) if fn.startswith("flash")
             else (TF.SSD_S, TF.SSD_MAX_HEADS))
    for ports in range(1, 5):
        for unrolls in range(1, 9):
            assert (port(*shape, ports=ports, unrolls=unrolls)
                    == ref(*shape, ports=ports, unrolls=unrolls))


def test_footprint_model_rules_out_two_flash_points_on_the_card():
    """2 * step against an H100's 232,448 bytes: flash (1, 4) and (1, 8)
    do not fit, (1, 2) just does; every SSD point fits."""
    step = lambda fn, p, u: 2 * fn(128, 128, ports=p, unrolls=u)  # noqa
    assert step(TF.flash_vmem_bytes, 1, 4) == 264192 > SMEM_H100
    assert step(TF.flash_vmem_bytes, 1, 8) == 329728 > SMEM_H100
    assert step(TF.flash_vmem_bytes, 1, 2) == 231424 <= SMEM_H100
    assert max(2 * TF.ssd_vmem_bytes(256, 8, ports=p, unrolls=u)
               for p in (1, 2, 4) for u in range(1, 9)) == 197120


def _ssd_staging(Bz, S, H, P, N, chunk):
    """(p_split, shared-memory bytes) the SSD wrapper launches with on an
    H100 (132 SMs, 232,448 B per block)."""
    hpc = ssd_heads_per_cta(Bz, H, S // chunk, 132)
    split = ssd_p_split(Bz, H, P, S // chunk, 132, chunk=chunk, N=N,
                        smem_cap=SMEM_H100, heads_per_cta=hpc)
    return split, ssd_smem_bytes(chunk, P // split, N)


def test_kernels_stage_within_the_card_at_the_paths_shapes():
    """What the CUDA kernels stage in shared memory at every point the
    fleet DSE times and at the model-width blocks ``chip_smoke.py``
    runs (the wrappers refuse anything larger)."""
    for ports in (1, 2, 4):
        for unrolls in (1, 2, 4, 8):
            assert flash_smem_bytes(64, 128 // ports,
                                    16 * unrolls) <= SMEM_H100
            _, smem = _ssd_staging(1, TF.SSD_S, ports, TF.SSD_P, TF.SSD_N,
                                   8 * unrolls)
            assert smem <= SMEM_H100
    assert flash_smem_bytes(256, 64, 32) <= SMEM_H100        # gemma2-9b
    assert flash_smem_bytes(256, 128, 128) > SMEM_H100       # refused
    # mamba2-780m: 64 chunks x 48 heads fill the card unsplit
    assert _ssd_staging(1, 4096, 48, 64, 128, 64) == (1, 103968)
    # chunk 128 at N 128 fits once P is split; chunk 256 cannot
    assert _ssd_staging(1, 256, 2, 64, 128, 128)[1] <= SMEM_H100
    assert ssd_smem_bytes(256, 16, 128) > SMEM_H100           # refused


def test_ssd_p_split_fills_the_card_and_keeps_slices_wide():
    """The chunk and output passes' grid: (chunks, heads x slices of P,
    batch), P split while the grid has fewer CTAs than SMs or a slice
    stages more than the card allows, never below 16 wide."""
    split = functools.partial(ssd_p_split, chunk=64, N=64,
                              smem_cap=SMEM_H100)
    assert split(1, 1, 64, 4, 132) == 4      # 16-wide slices at most
    assert split(1, 4, 64, 32, 132) == 2     # 128 CTAs -> 256
    assert split(1, 48, 64, 64, 132) == 1    # 3,072 CTAs already
    assert split(1, 4, 24, 1, 132) == 1      # 12 wide is too narrow
    # a 64-wide slice of chunk 128 at N 128 stages 240,672 B
    assert ssd_smem_bytes(128, 64, 128) == 240672 > SMEM_H100
    assert ssd_p_split(1, 48, 64, 32, 132, chunk=128, N=128,
                       smem_cap=SMEM_H100) == 2


def test_ssd_groups_heads_only_where_the_grid_stays_deep():
    """A CTA takes 4 or 2 heads (sharing B, C and C.B^T) where at least
    four CTAs per SM remain: the mamba2-780m layer, not the DSE."""
    assert ssd_heads_per_cta(1, 48, 64, 132) == 4     # 768 CTAs
    assert ssd_heads_per_cta(1, 48, 32, 132) == 2     # chunk 128: 768
    assert ssd_heads_per_cta(1, 6, 256, 132) == 2     # 6 % 4 != 0
    for heads in (1, 2, 4, 8):
        for chunk in (8, 16, 32, 64):
            assert ssd_heads_per_cta(1, heads, 256 // chunk, 132) == 1
    # grouped heads count once in the grid that P is split to fill
    assert ssd_p_split(1, 8, 64, 16, 132, chunk=16, N=64,
                       smem_cap=SMEM_H100, heads_per_cta=4) == 4


def test_ssd_scratch_holds_every_chunk_state_and_decay():
    """(Bz, n_chunks, H, P, N) chunk states, then (Bz, n_chunks, H)
    decays: ~101 MB at the mamba2-780m layer."""
    assert ssd_scratch_floats(2, 4, 3, 8, 16) == 2 * 4 * 3 * (8 * 16 + 1)
    assert 4 * ssd_scratch_floats(1, 64, 48, 64, 128) == 100675584


def test_cpu_tensors_never_launch_a_kernel():
    kernels = (flash_attention_kernel, ssd_scan_kernel)
    before = [k.launches for k in kernels]
    t, _ = _both(_flash_inputs(1, 64, 64, 2, 1, 32), "float32")
    mha(*t, block_q=32, block_kv=16)
    s, _ = _both(_ssd_inputs(1, 32, 2, 16, 16), "float32")
    ssd(*s, chunk=8)
    for name, op, _, args in TF.fleet_cuda_parity_cases(32, device="cpu"):
        op(*args, ports=2, unrolls=2)
    assert [k.launches for k in kernels] == before == [0, 0]


@pytest.mark.parametrize("block_q,block_kv", [(48, 64), (64, 48), (0, 64)])
def test_non_dividing_flash_blocks_raise(block_q, block_kv):
    t, _ = _both(_flash_inputs(1, 128, 128, 2, 1, 32), "float32")
    with pytest.raises(ValueError):
        mha(*t, block_q=block_q, block_kv=block_kv)


def test_non_dividing_ssd_chunk_raises():
    s, _ = _both(_ssd_inputs(1, 64, 2, 16, 16), "float32")
    with pytest.raises(ValueError):
        ssd(*s, chunk=24)


@pytest.mark.parametrize("kernel", [flash_attention_kernel, ssd_scan_kernel],
                         ids=lambda k: k.symbol)
def test_binding_matches_the_c_entry_point(kernel):
    """Each ctypes binding declares one argtype per parameter of its
    exported C function: pointers as c_void_p, ints as c_int, floats as
    c_float (the C source is parsed; it cannot be compiled here)."""
    assert kernel.library in SOURCES
    with open(os.path.join(CSRC_DIR, f"{kernel.library}.cu")) as f:
        src = f.read()
    m = re.search(r"KERNEL_EXPORT int " + kernel.symbol + r"\(([^)]*)\)",
                  src)
    assert m, f"{kernel.symbol} not exported by {kernel.library}.cu"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
            for p in params]
    assert kernel.argtypes == want
