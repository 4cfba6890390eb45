// Mamba2 SSD chunked scan for Hopper (sm_90a), chunk-parallel: within a
// chunk of Q tokens the recurrence is a masked-decay (Q x Q) product, and
// across chunks only the (P, N) state is carried -- so only that small
// state pass runs in chunk order.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan, pl.pallas_call at :91).  The TPU kernel walks its grid
// (Bz, H, n_chunks) with the chunk axis sequential, carrying the state in
// VMEM scratch.  Here one call issues three kernels on its stream:
//
//   1. chunk pass, one CTA per (chunk, group of heads, slice of P,
//      batch), all in parallel.  B and C are shared across heads, so a
//      CTA stages them and forms G = C . B^T once for its heads; then
//      per head, in the TPU kernel's arithmetic (kernel.py:44-72):
//        cum  = cumsum(dt * A)                     (warp-shuffle scan)
//        W_ij = G_ij * exp(cum_i - cum_j) * dt_j for i >= j, else 0,
//               in G's epilogue when the CTA has one head, else as the
//               product reads it (the TPU kernel masks the exponent with
//               -1e30 before exp, so the upper triangle is exactly 0; it
//               is not formed)
//        y    = W . x                              (the chunk's own part)
//        S_c  = (x * rem)^T . B,  rem_j = exp(cum_Q - cum_j) * dt_j
//      S_c goes to the scratch buffer (Bz, n_chunks, H, P, N) and
//      exp(cum_Q) to a (Bz, n_chunks, H) tail of it.
//   2. state pass, one thread per (batch, head, p, n) -- four of them,
//      as one 16-byte access, on a large state -- walking the chunks
//      in order: h_in[c] = exp(total_{c-1}) h_in[c-1] + S_{c-1}, written
//      over S_{c-1}'s slot as h_in[c]; the last state is h_final.
//   3. output pass, one CTA per (chunk >= 1, group of heads, slice,
//      batch), C staged once for the group:
//        y += (C . h_in[c]^T) * exp(cum)           (chunk 0's state is 0)
//      With 2-8 chunks (the DSE's chunks 32 and 64) each of its CTAs
//      walks the states before its chunk itself, in the same order, and
//      the state pass -- one launch of latency -- is not issued.
//
// Splitting P is exact: column p of y and row p of the state depend only
// on x[:, p].  The wrapper groups heads (4 or 2 a CTA) where the grid
// stays several CTAs deep on every SM, and splits P while the grid has
// fewer CTAs than the card has SMs, or while the staging exceeds the
// opt-in shared memory (kernels/ssd_scan/kernel.py, ssd_heads_per_cta
// and ssd_p_split; the staging is Geometry below, the same formula as
// ssd_smem_bytes).
//
// Products run on the tensor cores: mma.sync m16n8k8 in TF32 with the
// three-term split of csrc/tf32_mma.cuh (a_big b_big + a_big b_small +
// a_small b_big), which keeps float32 accuracy; 16 x 32 warp tiles reuse
// each split A fragment four times.  x, B, C and the states reach
// shared memory by cp.async (the output pass fetches the next head's
// state slice while it works on this one's), rows padded (B, C, G and
// the state by 4 floats, x by 8) so a warp's fragment loads fall in
// distinct banks, and zero-padded to the mma's 16 x 8 x 8 tile.
//
// Bound on an H100 SXM (published peaks, 700 W limit): for one
// mamba2-780m layer (S 4096, H 48, P 64, N 128, chunk 64, f32) the inputs
// and outputs are ~107 MB (~32 us at 3.35 TB/s) and the chunked
// algorithm's products ~7.3 GFLOP (~0.11 ms at 67 TFLOP/s of f32 on the
// CUDA cores; at the 495 TFLOP/s TF32 tensor-core rate the three-term
// split's ~22 GFLOP take ~44 us).  The scratch adds 4 x Bz n_chunks H P N
// bytes written once and read twice, and h_in written once: ~101 MB each
// way at that layer, 4 x ~101 MB ~ 0.12 ms at 3.35 TB/s -- the price of
// running the chunks in parallel.
#include <cstdint>

#include "kernel_export.cuh"
#include "ssd_common.cuh"

namespace {

// state pass: a small one (the DSE's chunks 8 and 16) runs one element a
// thread with 32 chunks' loads in flight, a large one four elements a
// thread (16-byte accesses) with 8 in flight
constexpr int kSmallState = 1 << 16;   // elements

// A CTA's staging, in floats.  Q rows pad to 16 (the mma's rows), N to 8
// (its depth), the slice of P to 16 (rows of the S_c product).
struct Geometry {
    int Q, N, Pc, Qp, Np, Pp, ldBC, ldW, ldX, ldH;
    __host__ __device__ Geometry(int Q_, int N_, int Pc_)
        : Q(Q_), N(N_), Pc(Pc_), Qp(round_up(Q_, 16)), Np(round_up(N_, 8)),
          Pp(round_up(Pc_, 16)), ldBC(Np + 4), ldW(Qp + 4), ldX(Pp + 8),
          ldH(Np + 4) {}
    // chunk pass: B, C (Qp, ldBC), G = C . B^T (Qp, ldW), x (Qp, ldX),
    // dt, cum, the scan's per-warp totals
    __host__ __device__ long long chunk_floats() const {
        return 2LL * Qp * ldBC + (long long)Qp * ldW + (long long)Qp * ldX
               + 2LL * Qp + kWarps;
    }
    // output pass: C (Qp, ldBC), two state slices (Pp, ldH) -- one head's
    // in use, the next one's in flight --, dt, cum, the scan's per-warp
    // totals
    __host__ __device__ long long output_floats() const {
        return (long long)Qp * ldBC + 2LL * Pp * ldH + 2LL * Qp + kWarps;
    }
};

// ------------------------------------------------------------- operands
// W_ij = G_ij * exp(cum_i - cum_j) * dt_j for j <= i < Q, else 0, formed
// from the head-independent G = C . B^T as the operand is read, so one G
// serves every head of the CTA (the TPU kernel's order: (G * L) * dt)
struct DecayedScores {
    const float* g;
    int ld, Q;
    const float* cum;
    const float* dts;
    __device__ __forceinline__ float at(int i, int j) const {
        return (j <= i && i < Q) ? g[i * ld + j] * expf(cum[i] - cum[j])
                                       * dts[j]
                                 : 0.f;
    }
};

// CTA (chunk, group of hpc heads x slice of P, batch)
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ decays,
                 int S, int H, int P, int N, int Q, int Pc, int hpc) {
    extern __shared__ float4 smem4[];
    const Geometry gm(Q, N, Pc);
    float* bs = reinterpret_cast<float*>(smem4);
    float* cs = bs + gm.Qp * gm.ldBC;
    float* gs = cs + gm.Qp * gm.ldBC;
    float* xs = gs + gm.Qp * gm.ldW;
    float* dts = xs + gm.Qp * gm.ldX;
    float* cum = dts + gm.Qp;
    float* wsum = cum + gm.Qp;

    const int c = blockIdx.x, nc = gridDim.x;
    const int split = gridDim.y / (H / hpc);
    const int h0 = blockIdx.y / split * hpc;
    const int p0 = (blockIdx.y % split) * Pc;
    const int b = blockIdx.z;
    const long long tok0 = (long long)b * S + (long long)c * Q;
    const long long xld = (long long)H * P;

    // G = C . B^T on the lower triangle, once for all the CTA's heads;
    // with one head, W itself, formed in the product's epilogue
    const bool one = hpc == 1;
    const auto stage_head = [&](int h) {
        stage(xs, gm.ldX, x + (tok0 * H + h) * P + p0, xld, Q, Pc, gm.Qp,
              gm.Pp);
        chunk_cumsum(dt, tok0, H, h, Q, gm.Qp, A[h], dts, cum, wsum);
    };
    stage(bs, gm.ldBC, Bm + tok0 * N, N, Q, N, gm.Qp, gm.Np);
    stage(cs, gm.ldBC, Cm + tok0 * N, N, Q, N, gm.Qp, gm.Np);
    if (one) stage_head(h0);
    cp_async_wait_all();
    __syncthreads();
    warp_products(Operand{cs, gm.ldBC, 1}, Operand{bs, gm.ldBC, 1}, gm.Qp,
                  gm.Qp, gm.Np, kLowerOut, [&](int i, int j, float v) {
        gs[i * gm.ldW + j] = !one                 ? v
                             : (j <= i && i < Q) ? v * expf(cum[i] - cum[j])
                                                       * dts[j]
                                                 : 0.f;
    });

    for (int h = h0; h < h0 + hpc; ++h) {
        if (!one) {
            stage_head(h);
            cp_async_wait_all();
        }
        __syncthreads();

        // y = W . x, the chunk's own part
        float* yc = y + (tok0 * H + h) * P + p0;
        const auto store_y = [&](int i, int p, float v) {
            if (i < Q && p < Pc) yc[i * xld + p] = v;
        };
        if (one)
            warp_products(Operand{gs, gm.ldW, 1}, Operand{xs, 1, gm.ldX},
                          gm.Qp, gm.Pp, gm.Qp, kLowerA, store_y);
        else
            warp_products(DecayedScores{gs, gm.ldW, Q, cum, dts},
                          Operand{xs, 1, gm.ldX}, gm.Qp, gm.Pp, gm.Qp,
                          kLowerA, store_y);
        __syncthreads();

        // x * rem, rem_j = exp(cum_Q - cum_j) * dt_j (0 on the padded
        // rows), rem formed over dt's slot
        const float total = cum[Q - 1];
        if (threadIdx.x < gm.Qp)
            dts[threadIdx.x] = expf(total - cum[threadIdx.x])
                               * dts[threadIdx.x];
        __syncthreads();
        for (int e = threadIdx.x; e < gm.Qp * gm.Pp; e += kThreads) {
            const int j = e / gm.Pp, p = e - j * gm.Pp;
            xs[j * gm.ldX + p] *= dts[j];
        }
        __syncthreads();

        // S_c = (x * rem)^T . B
        float* sc = states + (((long long)b * nc + c) * H + h) * P * N
                    + (long long)p0 * N;
        warp_products(Operand{xs, 1, gm.ldX}, Operand{bs, 1, gm.ldBC},
                      gm.Pp, gm.Np, gm.Qp, kDense,
                      [&](int p, int n, float v) {
            if (p < Pc && n < N) sc[(long long)p * N + n] = v;
        });
        if (threadIdx.x == 0 && p0 == 0)
            decays[((long long)b * nc + c) * H + h] = expf(total);
        __syncthreads();      // x, dt and cum are staged anew per head
    }
}

// One thread per V consecutive (batch, head, p, n) elements: h_in[c] =
// exp(total_{c-1}) * h_in[c-1] + S_{c-1}, in chunk order, each S_c's slot
// overwritten by h_in[c]; U chunks' loads in flight at a time.  V = 4
// (16-byte accesses) needs P * N % 4 == 0.
template <int V>
struct Vec;
template <>
struct Vec<1> {
    using T = float;
};
template <>
struct Vec<4> {
    using T = float4;
};

__device__ __forceinline__ float fma_state(float d, float h, float s) {
    return d * h + s;
}
__device__ __forceinline__ float4 fma_state(float d, float4 h, float4 s) {
    return make_float4(d * h.x + s.x, d * h.y + s.y, d * h.z + s.z,
                       d * h.w + s.w);
}

template <int V, int U>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(float* __restrict__ states,
                 const float* __restrict__ decays,
                 float* __restrict__ h_final, int Bz, int nc, int H,
                 int PN) {
    using T = typename Vec<V>::T;
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long per_batch = (long long)H * PN / V;   // in units of T
    if (e >= Bz * per_batch) return;
    const long long b = e / per_batch, r = e - b * per_batch;
    const int h = static_cast<int>(r * V / PN);
    T* s = reinterpret_cast<T*>(states) + b * nc * per_batch + r;
    const float* d = decays + b * nc * H + h;         // chunk c: c * H
    T hv{};
    for (int c0 = 0; c0 < nc; c0 += U) {
        T sv[U];
        float dv[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
            if (c0 + k < nc) {
                sv[k] = s[(c0 + k) * per_batch];
                dv[k] = d[(long long)(c0 + k) * H];
            }
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
            if (c0 + k < nc) {
                s[(c0 + k) * per_batch] = hv;
                hv = fma_state(dv[k], hv, sv[k]);
            }
        }
    }
    reinterpret_cast<T*>(h_final)[e] = hv;
}

// y += (C . h_in[c]^T) * exp(cum) for chunks c >= 1; CTA (chunk - 1,
// group of hpc heads x slice of P, batch).  With walk set, h_in[c] is
// formed here from S_0 .. S_{c-1} in chunk order (the state pass's
// recurrence), and the last chunk's CTAs also write h_final.
__global__ void __launch_bounds__(kThreads, 2)
ssd_output_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Cm,
                  const float* __restrict__ states,
                  const float* __restrict__ decays, float* __restrict__ y,
                  float* __restrict__ h_final, int S, int H, int P, int N,
                  int Q, int Pc, int nc, int hpc, bool walk) {
    extern __shared__ float4 smem4[];
    const Geometry gm(Q, N, Pc);
    float* cs = reinterpret_cast<float*>(smem4);
    float* hs[2] = {cs + gm.Qp * gm.ldBC, cs + gm.Qp * gm.ldBC
                                              + gm.Pp * gm.ldH};
    float* dts = hs[1] + gm.Pp * gm.ldH;
    float* cum = dts + gm.Qp;
    float* wsum = cum + gm.Qp;

    const int c = blockIdx.x + 1;
    const int split = gridDim.y / (H / hpc);
    const int h0 = blockIdx.y / split * hpc;
    const int p0 = (blockIdx.y % split) * Pc;
    const int b = blockIdx.z;
    const long long tok0 = (long long)b * S + (long long)c * Q;
    const long long yld = (long long)H * P;
    const long long chunk_stride = (long long)H * P * N;
    // the state entering chunk c, head h, into dst: by cp.async from the
    // state pass's h_in[c], or walked from the chunk states
    const auto fill_state = [&](int h, float* dst) {
        const float* s0 = states + ((long long)b * nc * H + h) * P * N
                          + (long long)p0 * N;
        if (!walk) {
            stage(dst, gm.ldH, s0 + c * chunk_stride, N, Pc, N, gm.Pp,
                  gm.Np);
        } else {
            // c < nc <= kWalkChunks: every load is issued before the
            // recurrence runs; the last chunk's CTAs go one chunk further
            const float* d = decays + (long long)b * nc * H + h;
            const int last = c == nc - 1 ? c : c - 1;
            for (int e = threadIdx.x; e < gm.Pp * gm.Np; e += kThreads) {
                const int p = e / gm.Np, n = e - p * gm.Np;
                float hv = 0.f;
                if (p < Pc && n < N) {
                    const float* sp = s0 + (long long)p * N + n;
                    float sv[kWalkChunks], dv[kWalkChunks];
#pragma unroll
                    for (int k = 0; k < kWalkChunks; ++k) {
                        sv[k] = k <= last ? sp[k * chunk_stride] : 0.f;
                        dv[k] = k <= last ? d[(long long)k * H] : 0.f;
                    }
                    float hf = 0.f;
#pragma unroll
                    for (int k = 0; k < kWalkChunks; ++k) {
                        if (k < c) hv = dv[k] * hv + sv[k];
                        if (k == c && c == nc - 1) hf = dv[k] * hv + sv[k];
                    }
                    if (c == nc - 1)
                        h_final[((long long)b * H + h) * P * N
                                + (long long)(p0 + p) * N + n] = hf;
                }
                dst[p * gm.ldH + n] = hv;
            }
        }
        cp_async_commit();
    };

    stage(cs, gm.ldBC, Cm + tok0 * N, N, Q, N, gm.Qp, gm.Np);
    fill_state(h0, hs[0]);
    for (int k = 0; k < hpc; ++k) {
        const int h = h0 + k;
        if (k + 1 < hpc) fill_state(h + 1, hs[(k + 1) & 1]);
        chunk_cumsum(dt, tok0, H, h, Q, gm.Qp, A[h], dts, cum, wsum);
        if (threadIdx.x < gm.Qp) cum[threadIdx.x] = expf(cum[threadIdx.x]);
        if (k + 1 < hpc)
            cp_async_wait_one();
        else
            cp_async_wait_all();
        __syncthreads();

        // cum now holds exp(cum)
        float* yc = y + (tok0 * H + h) * P + p0;
        warp_products(Operand{cs, gm.ldBC, 1}, Operand{hs[k & 1], gm.ldH, 1},
                      gm.Qp, gm.Pp, gm.Np, kDense,
                      [&](int i, int p, float v) {
            if (i < Q && p < Pc) {
                float* o = yc + i * yld + p;
                *o = *o + v * cum[i];
            }
        });
        __syncthreads();      // a slice is refilled two heads on
    }
}

}  // namespace

// x: (Bz, S, H, P); dt: (Bz, S, H); A: (H,); B, C: (Bz, S, N) -> y:
// (Bz, S, H, P), h_final: (Bz, H, P, N); scratch: Bz * n_chunks * H *
// (P * N + 1) floats; all contiguous float32.  S % chunk == 0 and
// P % p_split == 0, with the staging within the opt-in shared memory
// and H % heads_per_cta == 0 (checked by the Python wrapper).  Up to
// three launches on the stream: the chunk pass on grid (n_chunks, H /
// heads_per_cta * p_split, Bz); the state pass, unless 2 <= n_chunks <=
// kWalkChunks; the output pass on grid (n_chunks - 1, H / heads_per_cta
// * p_split, Bz), unless n_chunks == 1.
KERNEL_EXPORT int ssd_scan_fwd(const float* x, const float* dt,
                               const float* A, const float* B,
                               const float* C, float* y, float* h_final,
                               float* scratch, int Bz, int S, int H, int P,
                               int N, int chunk, int p_split,
                               int heads_per_cta, void* stream) {
    const int hpc = heads_per_cta;
    if (Bz <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 || S <= 0
        || S % chunk || p_split <= 0 || P % p_split || hpc <= 0 || H % hpc
        || (long long)(H / hpc) * p_split > 65535 || Bz > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const int nc = S / chunk, Pc = P / p_split;
    const Geometry gm(chunk, N, Pc);
    if (gm.Qp > kThreads) return static_cast<int>(cudaErrorInvalidValue);
    const long long smem_chunk = gm.chunk_floats() * 4;
    const long long smem_out = gm.output_floats() * 4;
    static long long granted_chunk = 48 * 1024, granted_out = 48 * 1024;
    cudaError_t err = opt_in(reinterpret_cast<const void*>(ssd_chunk_kernel),
                             smem_chunk, granted_chunk);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = opt_in(reinterpret_cast<const void*>(ssd_output_kernel), smem_out,
                 granted_out);
    if (err != cudaSuccess) return static_cast<int>(err);

    float* states = scratch;
    float* decays = scratch + (long long)Bz * nc * H * P * N;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(nc, (H / hpc) * p_split, Bz);
    ssd_chunk_kernel<<<grid, kThreads, static_cast<size_t>(smem_chunk),
                       s>>>(x, dt, A, B, C, y, states, decays, S, H, P, N,
                            chunk, Pc, hpc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool walk = nc > 1 && nc <= kWalkChunks;
    const long long elems = (long long)Bz * H * P * N;
    if (walk) {
        // the output pass walks the chunk states: no state pass
    } else if (elems >= kSmallState && (P * N) % 4 == 0) {
        const long long threads = elems / 4;
        ssd_state_kernel<4, 8><<<static_cast<unsigned>(
                                     (threads + kThreads - 1) / kThreads),
                                 kThreads, 0, s>>>(states, decays, h_final,
                                                   Bz, nc, H, P * N);
    } else {
        ssd_state_kernel<1, 32><<<static_cast<unsigned>(
                                      (elems + kThreads - 1) / kThreads),
                                  kThreads, 0, s>>>(states, decays, h_final,
                                                    Bz, nc, H, P * N);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess || nc == 1) return static_cast<int>(err);
    ssd_output_kernel<<<dim3(nc - 1, (H / hpc) * p_split, Bz), kThreads,
                        static_cast<size_t>(smem_out), s>>>(
        dt, A, C, states, decays, y, h_final, S, H, P, N, chunk, Pc, nc, hpc,
        walk);
    return static_cast<int>(cudaGetLastError());
}
