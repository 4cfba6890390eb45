"""ctypes binding of ``csrc/ssd_scan.cu``: one entry point per call (the
chunk, state and output passes, issued in order on the current stream),
float32.

The chunk and output passes run one CTA per (chunk, group of heads,
slice of the head dim P, batch): :func:`ssd_heads_per_cta` groups heads
(B and C, and C.B^T, are shared across heads) where the grid stays deep,
and :func:`ssd_p_split` splits P (exact, see the C source) while the grid
has fewer CTAs than the card has SMs, or while a CTA's staging exceeds
the card's opt-in shared memory.  A chunk whose staging still exceeds it
(chunk 256, the ``ssm_chunk`` of mamba2-780m and zamba2-2.7b) runs as
sub-chunks: :func:`ssd_plan` gives the chunk the kernel actually runs
(:func:`ssd_smem_bytes` is the C source's staging formula).  The chunk
states go through a scratch buffer of :func:`ssd_scratch_floats`
floats.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..build import (CudaKernel, current_stream, require_cuda_tensor,
                     smem_optin)

__all__ = ["ssd_scan_kernel", "ssd_scan_cuda", "ssd_smem_bytes",
           "ssd_heads_per_cta", "ssd_p_split", "ssd_scratch_floats",
           "ssd_plan", "SsdPlan"]

_F32 = (torch.float32,)
_MIN_SLICE = 16          # the narrowest slice of P one CTA takes
_WARPS = 8               # warps per CTA (kThreads / 32 in the C source)
_GROUPS = (4, 2)         # heads a CTA may take, widest first
_DEPTH = 4               # CTAs per SM a grouped grid keeps, at least

# x, dt, A, B, C, y, h_final, scratch; Bz, S, H, P, N, chunk, p_split,
# heads_per_cta; stream
ssd_scan_kernel = CudaKernel(
    "ssd_scan", "ssd_scan_fwd",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def ssd_smem_bytes(chunk: int, p_slice: int, N: int) -> int:
    """Shared memory one CTA stages, float32: the larger of the chunk
    pass (B and C (Qp, Np + 4), C.B^T (Qp, Qp + 4), the x slice
    (Qp, Pp + 8), dt and cum (Qp), the scan's per-warp totals) and the
    output pass (C, two state slices (Pp, Np + 4), dt, cum, totals); Qp is
    the chunk rounded up to 16, Np is N rounded up to 8, Pp the slice
    rounded up to 16.  It does not depend on the heads a CTA takes: they
    are staged one after another."""
    qp, np_, pp = (_round_up(chunk, 16), _round_up(N, 8),
                   _round_up(p_slice, 16))
    ld_bc = np_ + 4
    chunk_pass = (2 * qp * ld_bc + qp * (qp + 4) + qp * (pp + 8) + 2 * qp
                  + _WARPS)
    output_pass = qp * ld_bc + 2 * pp * ld_bc + 2 * qp + _WARPS
    return 4 * max(chunk_pass, output_pass)


def ssd_heads_per_cta(Bz: int, H: int, n_chunks: int, sms: int) -> int:
    """Heads one CTA takes: the widest of 4 and 2 that divides H and
    leaves at least ``_DEPTH`` CTAs per SM, else 1."""
    for hpc in _GROUPS:
        if H % hpc == 0 and Bz * n_chunks * (H // hpc) >= _DEPTH * sms:
            return hpc
    return 1


def ssd_p_split(Bz: int, H: int, P: int, n_chunks: int, sms: int, *,
                chunk: int, N: int, smem_cap: int,
                heads_per_cta: int = 1) -> int:
    """Slices of P per (chunk, group of heads, batch): doubled while the
    grid has fewer CTAs than the card has SMs, or the staging exceeds
    ``smem_cap``, and a slice stays 16 wide or more."""
    groups = H // heads_per_cta
    split = 1
    while ((Bz * groups * n_chunks * split < sms
            or ssd_smem_bytes(chunk, P // split, N) > smem_cap)
           and P % (2 * split) == 0 and P // (2 * split) >= _MIN_SLICE):
        split *= 2
    return split


def ssd_scratch_floats(Bz: int, n_chunks: int, H: int, P: int,
                       N: int) -> int:
    """The chunk states (Bz, n_chunks, H, P, N), overwritten in place by
    the states entering each chunk, then exp(cum_Q) per (Bz, n_chunks,
    H)."""
    return Bz * n_chunks * H * (P * N + 1)


class SsdPlan(NamedTuple):
    """How one call runs: the ``chunk`` the kernel runs at and its
    ``n_chunks``, the heads a CTA takes, the slices of P and the bytes a
    CTA stages."""
    chunk: int
    n_chunks: int
    heads_per_cta: int
    p_split: int
    smem: int


def ssd_plan(Bz: int, S: int, H: int, P: int, N: int, chunk: int, sms: int,
             smem_cap: int) -> SsdPlan:
    """The launch of a call at ``chunk`` (dividing S) on a card with
    ``sms`` SMs and ``smem_cap`` bytes of shared memory a block.  A chunk
    whose staging fits at some split of P runs as it is (the launch does
    not change).  One that fits at none (chunk 256 at N 128 or N 64) runs
    as sub-chunks, halving it while it stays even: the largest whose
    staging fits with P whole, else the largest that fits at all (a split
    of P to fit the staging leaves one CTA an SM, and measured slower):
    4 x 64 at mamba2-780m's N 128, 2 x 128 at zamba2-2.7b's N 64.  The
    chunked decomposition is the recurrence regrouped, so sub-chunks move
    only the float rounding (the reference holds chunks 16-128 within
    1e-4).  Raises ``ValueError`` if no sub-chunk fits."""
    def launch(run: int) -> SsdPlan:
        n_chunks = S // run
        hpc = ssd_heads_per_cta(Bz, H, n_chunks, sms)
        split = ssd_p_split(Bz, H, P, n_chunks, sms, chunk=run, N=N,
                            smem_cap=smem_cap, heads_per_cta=hpc)
        return SsdPlan(run, n_chunks, hpc, split,
                       ssd_smem_bytes(run, P // split, N))

    plan = launch(chunk)
    if plan.smem <= smem_cap:
        return plan
    subs, run = [], chunk
    while run % 2 == 0:
        run //= 2
        subs.append(launch(run))
    fits = [p for p in subs if p.smem <= smem_cap]
    if not fits:
        raise ValueError(f"chunk {chunk} at P={P}, N={N}: no sub-chunk "
                         f"stages within the card's {smem_cap} B per block")
    whole = [p for p in fits if ssd_smem_bytes(p.chunk, P, N) <= smem_cap]
    return (whole or fits)[0]


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *,
                  chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Bz,S,H,P); dt: (Bz,S,H); A: (H,); B, C: (Bz,S,N), float32 on
    the card, contiguous; S % chunk == 0 -> (y (Bz,S,H,P), h_final
    (Bz,H,P,N)).  The kernel runs at :func:`ssd_plan`'s chunk."""
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    require_cuda_tensor("x", x, (Bz, S, H, P), _F32)
    require_cuda_tensor("dt", dt, (Bz, S, H), _F32, dev)
    require_cuda_tensor("A", A, (H,), _F32, dev)
    require_cuda_tensor("B", B, (Bz, S, N), _F32, dev)
    require_cuda_tensor("C", C, (Bz, S, N), _F32, dev)
    if chunk < 1 or S % chunk:
        raise ValueError(f"chunk {chunk} does not divide S={S}")
    plan = ssd_plan(Bz, S, H, P, N, chunk,
                    torch.cuda.get_device_properties(dev)
                    .multi_processor_count, smem_optin(dev))
    y = torch.empty_like(x)
    h = torch.empty((Bz, H, P, N), dtype=torch.float32, device=dev)
    scratch = torch.empty(ssd_scratch_floats(Bz, plan.n_chunks, H, P, N),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        ssd_scan_kernel.launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), h.data_ptr(), scratch.data_ptr(),
            Bz, S, H, P, N, plan.chunk, plan.p_split, plan.heads_per_cta,
            current_stream(dev))
    return y, h
