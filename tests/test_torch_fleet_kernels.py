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
from repro_torch.kernels.flash_attention import (H100_SMEM_OPTIN,
                                                 HEAD_DIMS,
                                                 flash_attention_kernel,
                                                 flash_blocks, flash_plan,
                                                 flash_smem_bytes,
                                                 flash_tiled_ref,
                                                 flash_wide_smem_bytes, mha,
                                                 mha_ref)
from repro_torch.kernels.ssd_scan import (ssd, ssd_chunked_ref,
                                          ssd_heads_per_cta, ssd_oracle,
                                          ssd_p_split, ssd_plan,
                                          ssd_scan_kernel,
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


@functools.lru_cache(maxsize=None)
def _fleet_flash_case():
    """The fleet parity inputs (S 128, 2 query heads on one KV head,
    d 64, float32) and the JAX oracle's causal attention on them."""
    _, _, _, args = TF.fleet_cuda_parity_cases(TF.FLASH_S, device="cpu")[0]
    return args, j_mha_ref(*(jnp.asarray(a.numpy()) for a in args),
                           causal=True)


@pytest.mark.parametrize("ports", [1, 2, 4])
@pytest.mark.parametrize("unrolls", [1, 2, 4, 8])
def test_flash_tiled_ref_matches_jax_oracle_at_every_dse_point(ports,
                                                               unrolls):
    """The CUDA kernel's float32 numerics (3xTF32 products, the online
    softmax over its KV blocks), in plain PyTorch, at every knob point the
    fleet DSE times: block_q = 128 / ports, block_kv = 16 * unrolls."""
    args, want = _fleet_flash_case()
    got = flash_tiled_ref(*args, causal=True, block_q=TF.FLASH_S // ports,
                          block_kv=16 * unrolls)
    assert got.dtype == torch.float32
    assert _max_err(got, want) < TOL["float32"]


def test_flash_tiled_ref_head_dim_256_window_softcap_bf16():
    """The bf16 numerics (S scaled after the product, P rounded to bf16
    before P . V) at gemma2-9b's head dim, window and soft-cap."""
    t, j = _both(_flash_inputs(1, 128, 128, 4, 2, 256, seed=9), "bfloat16")
    kw = dict(window=64, softcap=50.0)
    got = flash_tiled_ref(*t, block_q=64, block_kv=32, **kw)
    assert got.dtype == torch.bfloat16
    assert _max_err(got, j_mha_ref(*j, **kw)) < TOL["bfloat16"]


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
    assert step(TF.flash_vmem_bytes, 1, 4) == 264192 > H100_SMEM_OPTIN
    assert step(TF.flash_vmem_bytes, 1, 8) == 329728 > H100_SMEM_OPTIN
    assert step(TF.flash_vmem_bytes, 1, 2) == 231424 <= H100_SMEM_OPTIN
    assert max(2 * TF.ssd_vmem_bytes(256, 8, ports=p, unrolls=u)
               for p in (1, 2, 4) for u in range(1, 9)) == 197120


def _ssd_staging(Bz, S, H, P, N, chunk):
    """(p_split, shared-memory bytes) the SSD wrapper launches with on an
    H100 (132 SMs, 232,448 B per block)."""
    hpc = ssd_heads_per_cta(Bz, H, S // chunk, 132)
    split = ssd_p_split(Bz, H, P, S // chunk, 132, chunk=chunk, N=N,
                        smem_cap=H100_SMEM_OPTIN, heads_per_cta=hpc)
    return split, ssd_smem_bytes(chunk, P // split, N)


def test_kernels_stage_within_the_card_at_the_paths_shapes():
    """What the CUDA kernels stage in shared memory at every point the
    fleet DSE times and at the model-width blocks ``chip_smoke.py``
    runs (the wrappers refuse anything larger).  Flash attention stages
    Q and two cp.async stages of K/V rows of d + 4 floats in float32, and
    the 64-row-padded Q, a two-stage TMA ring of K/V tiles, 1,024 bytes
    of alignment slack and the mbarriers in bfloat16."""
    f32, bf16 = torch.float32, torch.bfloat16
    for ports in (1, 2, 4):
        for unrolls in (1, 2, 4, 8):
            # (1, 4) and (1, 8) too: the footprint model rules them out,
            # the parity checks run them
            assert flash_smem_bytes(64, 128 // ports, 16 * unrolls,
                                    f32) <= H100_SMEM_OPTIN
            _, smem = _ssd_staging(1, TF.SSD_S, ports, TF.SSD_P, TF.SSD_N,
                                   8 * unrolls)
            assert smem <= H100_SMEM_OPTIN
    assert flash_smem_bytes(64, 128, 128, f32) == 174080       # (1, 8)
    # gemma2-9b (d 256, bf16): the old blocks and the larger ones
    assert flash_smem_bytes(256, 64, 32, bf16) == 99392
    assert flash_smem_bytes(256, 64, 64, bf16) == 164928 <= H100_SMEM_OPTIN
    # blocks whose own staging exceeds the card run at the plan's tiles,
    # which fit: two 64-row CTAs a 128-row block in bf16, 16-row KV steps
    # in f32
    assert flash_smem_bytes(256, 128, 128, bf16) > H100_SMEM_OPTIN
    plan = flash_plan(256, 512, 512, 128, 128, bf16, H100_SMEM_OPTIN)
    assert (plan.tile_q, plan.tile_kv, plan.smem) == (64, 64, 164928)
    assert flash_smem_bytes(256, 64, 64, f32) > H100_SMEM_OPTIN
    plan = flash_plan(256, 512, 512, 64, 64, f32, H100_SMEM_OPTIN)
    assert (plan.tile_q, plan.tile_kv) == (64, 32)
    assert plan.smem <= H100_SMEM_OPTIN
    # mamba2-780m: 64 chunks x 48 heads fill the card unsplit
    assert _ssd_staging(1, 4096, 48, 64, 128, 64) == (1, 103968)
    # chunk 128 at N 128 fits once P is split; chunk 256 does not at any
    # split, and runs as four chunks of 64, which fit with P whole
    assert _ssd_staging(1, 256, 2, 64, 128, 128)[1] <= H100_SMEM_OPTIN
    assert ssd_smem_bytes(256, 16, 128) > H100_SMEM_OPTIN
    plan = ssd_plan(1, 256, 2, 64, 128, 256, 132, H100_SMEM_OPTIN)
    assert (plan.chunk, plan.n_chunks) == (64, 4)
    assert plan.smem <= H100_SMEM_OPTIN


def test_ssd_p_split_fills_the_card_and_keeps_slices_wide():
    """The chunk and output passes' grid: (chunks, heads x slices of P,
    batch), P split while the grid has fewer CTAs than SMs or a slice
    stages more than the card allows, never below 16 wide."""
    split = functools.partial(ssd_p_split, chunk=64, N=64,
                              smem_cap=H100_SMEM_OPTIN)
    assert split(1, 1, 64, 4, 132) == 4      # 16-wide slices at most
    assert split(1, 4, 64, 32, 132) == 2     # 128 CTAs -> 256
    assert split(1, 48, 64, 64, 132) == 1    # 3,072 CTAs already
    assert split(1, 4, 24, 1, 132) == 1      # 12 wide is too narrow
    # a 64-wide slice of chunk 128 at N 128 stages 240,672 B
    assert ssd_smem_bytes(128, 64, 128) == 240672 > H100_SMEM_OPTIN
    assert ssd_p_split(1, 48, 64, 32, 132, chunk=128, N=128,
                       smem_cap=H100_SMEM_OPTIN) == 2


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
                       smem_cap=H100_SMEM_OPTIN, heads_per_cta=4) == 4


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


# ----------------------------------------------------------------------
# every shape the reference computes: the launch plans
# ----------------------------------------------------------------------
BF16, F32 = torch.bfloat16, torch.float32
# tests/test_kernels.py::test_flash_block_size_invariance's blockings
REF_BLOCKINGS = [(64, 64), (128, 128), (64, 256), (256, 64)]


def _assert_plan_covers(plan, d, Sq, Skv, dtype):
    """A plan's launch fits the card and its tiles cover the call: the
    least native head dim >= d, whole tiles over both sequences, TMA in
    bf16 exactly where d % 8 == 0 (aligned tensors), one warpgroup (64
    query rows) a CTA in bf16 at D 256."""
    assert plan.smem == flash_smem_bytes(plan.D, plan.tile_q, plan.tile_kv,
                                         dtype) <= H100_SMEM_OPTIN
    assert plan.D == min(n for n in HEAD_DIMS if n >= d)
    assert plan.tile_q % 16 == 0 and 16 <= plan.tile_q <= 128
    assert plan.tile_kv in (16, 32, 64, 128)
    assert plan.n_kv == -(-Skv // plan.tile_kv)
    assert plan.tma == (dtype == BF16 and d % 8 == 0)
    assert plan.slices == 1
    assert plan.general == bool(d != plan.D or Sq % plan.tile_q
                                or Skv % plan.tile_kv)
    if plan.general:                        # the bodies built for it
        assert plan.tile_kv == 16 and (dtype == F32 or plan.tile_q <= 64)
    if dtype == BF16:                       # O at d 256: one warpgroup
        assert plan.tile_q <= 64 or plan.D < 256


@pytest.mark.parametrize("d,dtype", [(d, t) for t in (F32, BF16)
                                     for d in range(16, 257, 8)]
                         + [(100, F32)], ids=str)
def test_flash_plan_takes_every_head_dim(d, dtype):
    """Head dims 16-256 in steps of 8 in both types, and 100 in float32
    (bf16's is in test_flash_plan_without_a_tensor_map), run in the next
    native body at the blocks the fleet and gemma use; none is refused."""
    for block_q, block_kv in ((128, 128), (64, 64)):
        plan = flash_plan(d, 512, 512, block_q, block_kv, dtype,
                          H100_SMEM_OPTIN)
        _assert_plan_covers(plan, d, 512, 512, dtype)


def test_flash_plan_without_a_tensor_map():
    """bf16 head dims off the 16-byte grid (d % 8 != 0) get no TMA: the
    producer warp's copies; f32 plans them like any other d.  Tensors off
    the 16-byte grid take the general body, without TMA in bf16."""
    for d in (100, 33, 1, 250):
        plan = flash_plan(d, 64, 64, 32, 32, BF16, H100_SMEM_OPTIN)
        assert not plan.tma
        _assert_plan_covers(plan, d, 64, 64, BF16)
        _assert_plan_covers(flash_plan(d, 64, 64, 32, 32, F32,
                                       H100_SMEM_OPTIN), d, 64, 64, F32)
    for dtype in (F32, BF16):
        plan = flash_plan(64, 64, 64, 32, 32, dtype, H100_SMEM_OPTIN,
                          aligned=False)
        assert plan.general and not plan.tma and plan.tile_kv == 16


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
@pytest.mark.parametrize("block_q,block_kv", REF_BLOCKINGS)
def test_flash_plan_takes_the_reference_blockings(block_q, block_kv,
                                                  dtype):
    """(1, 256, 4 on 2, d 64) at the reference's four blockings: an
    over-sized block runs as 128-row sub-tiles (more CTAs for queries,
    more steps of the KV walk)."""
    bq, bkv = flash_blocks(256, 256, block_q, block_kv)
    plan = flash_plan(64, 256, 256, bq, bkv, dtype, H100_SMEM_OPTIN)
    _assert_plan_covers(plan, 64, 256, 256, dtype)
    assert plan.tile_q == min(block_q, 128)
    assert plan.tile_kv == min(block_kv, 128)


def test_flash_plan_head_dim_256_bf16_at_128_blocks():
    """gemma2-9b's head dim at (128, 128) in bf16: two 64-row CTAs per
    query block (one warpgroup each) and 64-row KV steps."""
    plan = flash_plan(256, 4096, 4096, 128, 128, BF16, H100_SMEM_OPTIN)
    _assert_plan_covers(plan, 256, 4096, 4096, BF16)
    assert (plan.tile_q, plan.tile_kv) == (64, 64)
    assert 4096 // plan.tile_q == 64        # CTAs per (head, batch)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
def test_flash_plan_takes_decode(dtype):
    """Decode: one query row (block_q clips to 1) at q_offset Skv - 1
    runs as one 16-row tile whose other rows are masked."""
    bq, bkv = flash_blocks(1, 256, 128, 128)
    assert (bq, bkv) == (1, 128)
    for d in (64, 128, 256):
        plan = flash_plan(d, 1, 256, bq, bkv, dtype, H100_SMEM_OPTIN)
        _assert_plan_covers(plan, d, 1, 256, dtype)
        assert plan.tile_q == 16 and plan.general


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
@pytest.mark.parametrize("block", [12, 20])
def test_flash_plan_takes_blocks_off_the_16_row_grid(block, dtype):
    """Blocks of 12 and 20 over whisper's 1,500 frames: 16-row KV tiles
    (the general body's), the last one cut short (1,500 = 93 x 16 + 12),
    and 16- or 32-row query tiles."""
    bq, bkv = flash_blocks(1500, 1500, block, block)
    plan = flash_plan(64, 1500, 1500, bq, bkv, dtype, H100_SMEM_OPTIN)
    _assert_plan_covers(plan, 64, 1500, 1500, dtype)
    assert plan.general and (plan.tile_kv, plan.n_kv) == (16, 94)
    assert plan.tile_q == {12: 16, 20: 32}[block]


def test_flash_plan_keeps_the_launch_at_the_paths_blocks():
    """At the fleet DSE's 12 knob points (f32, d 64, S 128) and the gemma
    blocks (bf16, d 256, S 4096) the plan is the caller's blocks in the
    exact body: the grid (S / tile_q CTAs a head), threads (from tile_q)
    and staging of the launch before the plan existed."""
    for ports in (1, 2, 4):
        for unrolls in (1, 2, 4, 8):
            bq, bkv = 128 // ports, 16 * unrolls
            plan = flash_plan(64, 128, 128, bq, bkv, F32, H100_SMEM_OPTIN)
            assert plan == ("f32", 64, bq, bkv, 128 // bkv,
                            4 * (bq + 4 * bkv) * 68, False, False, 1)
    for bq, bkv in ((64, 32), (64, 64)):
        plan = flash_plan(256, 4096, 4096, bq, bkv, BF16, H100_SMEM_OPTIN)
        assert plan == ("bf16", 256, bq, bkv, 4096 // bkv,
                        flash_smem_bytes(256, bq, bkv, BF16), True, False,
                        1)


def test_flash_plan_refuses_head_dims_above_256():
    """What the plan still refuses: a head dim or a block below 1.  A head
    dim above 256, which no config of the repository has, is no longer
    refused: d 264 runs as two slices of the wide body."""
    for d, bq, bkv in ((0, 64, 64), (264, 0, 64), (264, 64, 0)):
        with pytest.raises(ValueError):
            flash_plan(d, 128, 128, bq, bkv, BF16, H100_SMEM_OPTIN)
    assert flash_plan(264, 128, 128, 64, 64, BF16,
                      H100_SMEM_OPTIN).slices == 2


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
@pytest.mark.parametrize("d", [257, 320, 384, 512, 1024])
def test_flash_plan_takes_head_dims_above_256(d, dtype):
    """Above d 256 the plan runs ceil(d / 256) slices of V's columns, each
    at most D = 256 wide, in the wide body (general, 16-row KV tiles, no
    TMA, in either type), at the query tiles of the blocks (up to 128
    rows in bf16 too), staging what ``flash_wide_smem_bytes`` says --
    within the card at every block -- whatever d is."""
    for block_q, block_kv, Sq, Skv in ((128, 128, 512, 512),
                                       (64, 64, 512, 512),
                                       (1, 128, 1, 256),
                                       (20, 20, 1500, 1500)):
        plan = flash_plan(d, Sq, Skv, block_q, block_kv, dtype,
                          H100_SMEM_OPTIN)
        assert plan.slices == -(-d // 256) and plan.D == 256
        assert plan.body == ("bf16" if dtype == BF16 else "f32")
        assert plan.general and not plan.tma and plan.tile_kv == 16
        assert plan.n_kv == -(-Skv // 16)
        assert plan.tile_q == {128: 128, 64: 64, 1: 16, 20: 32}[block_q]
        assert plan.smem == flash_wide_smem_bytes(256, plan.tile_q)
        assert plan.smem <= flash_wide_smem_bytes(256, 128) == 55808


# (B, Sq, Skv, H, K, d), kwargs: the wide body's shapes -- GQA, causal,
# window and soft-cap, decode (q_offset), blocks off the 16-row grid
FLASH_WIDE_SHAPES = [
    ((1, 64, 64, 4, 2, 320), dict(block_q=32, block_kv=32)),
    ((1, 64, 64, 4, 2, 512), dict(window=40, softcap=30.0, block_q=32,
                                  block_kv=64)),
    ((2, 1, 48, 2, 1, 384), dict(q_offset=47)),
    ((1, 60, 60, 2, 2, 300), dict(causal=False, block_q=20, block_kv=12)),
    ((1, 32, 32, 2, 1, 513), dict(block_q=16, block_kv=16)),
]
FLASH_WIDE_IDS = ["d320", "d512-window-softcap", "d384-decode",
                  "d300-blocks20x12", "d513"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", FLASH_WIDE_SHAPES, ids=FLASH_WIDE_IDS)
def test_flash_sliced_ref_matches_jax_oracle_at_wide_head_dims(shape, kw,
                                                               dtype):
    """The plain version and the wide body's decomposition
    (``flash_tiled_ref`` above d 256: a walk per 256-column slice of V,
    S over all d in 64-column 3xTF32 chunks) against the JAX oracle."""
    t, j = _both(_flash_inputs(*shape), dtype)
    jkw = {key: val for key, val in kw.items() if not key.startswith("block")}
    want = j_mha_ref(*j, **jkw)
    assert _max_err(mha(*t, **kw), want) < TOL[dtype]
    got = flash_tiled_ref(*t, **kw)
    assert got.dtype == t[0].dtype and tuple(got.shape) == tuple(t[0].shape)
    assert _max_err(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", FLASH_WIDE_SHAPES[:2],
                         ids=FLASH_WIDE_IDS[:2])
def test_flash_sliced_ref_matches_jax_pallas_interpret(shape, kw, dtype):
    """The wide body's decomposition against the JAX Pallas kernel in
    interpret mode at the same blocks, d 320 and 512, from one seed."""
    t, j = _both(_flash_inputs(*shape), dtype)
    want = _j_flash(j, **kw)
    assert _max_err(flash_tiled_ref(*t, **kw), want) < TOL[dtype]


def _j_flash(j, **kw):
    return j_mha(*j, use_pallas=True, interpret=True, **kw)


FLASH_NEW_SHAPES = [
    # (B, Sq, Skv, H, K, d), kwargs: head dims 80 and 128 (GQA 4 on 2),
    # decode, the reference's over-sized blockings
    ((1, 128, 128, 4, 2, 80), dict(block_q=64, block_kv=64)),
    ((1, 128, 128, 4, 2, 128), dict(block_q=128, block_kv=128)),
    ((2, 1, 256, 4, 2, 64), dict(q_offset=255, block_q=128, block_kv=128)),
    ((1, 256, 256, 4, 2, 64), dict(block_q=64, block_kv=256)),
    ((1, 256, 256, 4, 2, 64), dict(block_q=256, block_kv=64)),
]
FLASH_NEW_IDS = ["d80", "d128", "decode", "blocks64x256", "blocks256x64"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", FLASH_NEW_SHAPES, ids=FLASH_NEW_IDS)
def test_flash_plain_and_tiled_ref_at_new_shapes_match_jax_oracle(
        shape, kw, dtype):
    """The plain version and ``flash_tiled_ref`` (the kernel's tiles and
    numerics) against the JAX oracle at the shapes the kernel now takes."""
    t, j = _both(_flash_inputs(*shape), dtype)
    want = j_mha_ref(*j, q_offset=kw.get("q_offset", 0))
    assert _max_err(mha(*t, **kw), want) < TOL[dtype]
    got = flash_tiled_ref(*t, **kw)
    assert got.dtype == t[0].dtype and tuple(got.shape) == tuple(t[0].shape)
    assert _max_err(got, want) < TOL[dtype]


@pytest.mark.slow
@pytest.mark.parametrize("shape,kw", FLASH_NEW_SHAPES, ids=FLASH_NEW_IDS)
def test_flash_tiled_ref_at_new_shapes_matches_jax_pallas_interpret(shape,
                                                                    kw):
    """The same shapes against the JAX Pallas kernel in interpret mode at
    the same blocks, float32."""
    t, j = _both(_flash_inputs(*shape), "float32")
    want = _j_flash(j, causal=True, **kw)
    assert _max_err(flash_tiled_ref(*t, **kw), want) < TOL["float32"]
    assert _max_err(mha(*t, **kw), want) < TOL["float32"]


def test_ssd_plan_runs_chunk_256_as_sub_chunks():
    """chunk 256 (mamba2-780m: P 64, N 128, 48 heads; zamba2-2.7b: N 64,
    80 heads) stages more than the card at any split of P and runs as the
    largest sub-chunks that fit with P whole (64 at N 128, where 128
    fits only split; 128 at N 64); chunks that fit keep their launch."""
    for H, N, run in ((48, 128, 64), (80, 64, 128)):
        plan = ssd_plan(1, 4096, H, 64, N, 256, 132, H100_SMEM_OPTIN)
        assert (plan.chunk, plan.n_chunks) == (run, 4096 // run)
        assert plan.smem <= ssd_smem_bytes(run, 64, N) <= H100_SMEM_OPTIN
    for Bz, S, H, P, N, chunk in ((1, 4096, 48, 64, 128, 64),
                                  (1, 256, 2, 64, 128, 128),
                                  (1, TF.SSD_S, 4, TF.SSD_P, TF.SSD_N, 8),
                                  (1, TF.SSD_S, 1, TF.SSD_P, TF.SSD_N, 64)):
        hpc = ssd_heads_per_cta(Bz, H, S // chunk, 132)
        split = ssd_p_split(Bz, H, P, S // chunk, 132, chunk=chunk, N=N,
                            smem_cap=H100_SMEM_OPTIN, heads_per_cta=hpc)
        assert ssd_plan(Bz, S, H, P, N, chunk, 132, H100_SMEM_OPTIN) == (
            chunk, S // chunk, hpc, split, ssd_smem_bytes(chunk, P // split,
                                                          N))


@pytest.mark.slow
def test_ssd_chunk_256_matches_jax_pallas_interpret():
    """(1, 512, 2, 16, 32) at chunk 256: the plain version, and the
    kernel's decomposition at the chunk the plan runs (128), against the
    JAX kernel in interpret mode at chunk 256."""
    t, j = _both(_ssd_inputs(1, 512, 2, 16, 32), "float32")
    jy, jh = j_ssd(*j, chunk=256, use_pallas=True, interpret=True)
    run = ssd_plan(1, 512, 2, 16, 32, 256, 132, H100_SMEM_OPTIN).chunk
    assert run == 128
    for y, h in (ssd(*t, chunk=256), ssd_chunked_ref(*t, chunk=run)):
        assert _max_err(y, jy) < 1e-4
        assert _max_err(h, jh) < 1e-4
