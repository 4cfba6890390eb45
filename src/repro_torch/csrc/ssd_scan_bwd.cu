// The backward of csrc/ssd_scan.cu's chunked SSD (sm_90a): given dy and,
// where one is given, dh_final, the gradients of x, dt, A, B and C.
//
// Replaces no TPU kernel: the JAX package's kernel has no backward, and
// its models differentiate the plain chunked SSD with jax.grad.  This one
// lets training run the SSD on the card: kernels/ssd_scan/grad.py wraps
// the forward (ssd_scan_fwd, unchanged) and this entry point in one
// torch.autograd.Function.  The forward leaves in its scratch the state
// entering each chunk, h_in[c] (or, with 2-8 chunks, each chunk's own
// state, from which pass 0 below walks h_in), and exp(T_c), T_c the
// chunk's summed log-decay; the function saves that scratch.  The terms
// are the map of the Mamba2 paper's chunked backward (arXiv:2405.21060,
// section 7).  Within a chunk of Q tokens, cum = cumsum(dt * A),
// G = C . B^T, W_ij = G_ij exp(cum_i - cum_j) dt_j (i >= j) and
// rem_j = exp(T - cum_j) dt_j.  One call issues up to six kernels:
//
//   0. (2-8 chunks) h_in[c] from the chunk states, in chunk order, into
//      the scratch; the saved states stay as they are.
//   1. chunk pass, one CTA per (chunk >= 1, group of heads, batch), in
//      parallel: E_c = sum_i exp(cum_i) dy_i (x) C_i, the gradient the
//      chunk's outputs give the state entering it, into the scratch.
//   2. reverse state pass, one thread per 4 (batch, head, p, n) (1 where
//      P N % 4 != 0), walking the chunks backwards from dh_final, the
//      loads of 4 (8) chunks in flight:
//      g_c = dh[c + 1], the gradient of the state leaving chunk c, over
//      E_c's slot, then dh[c] = exp(T_c) g_c + E_c.  Each warp also sums
//      its part of <h_in[c], g_c> (the gradient of exp(T_c)), one partial
//      a warp: no atomics.
//   3. per-chunk pass, one CTA per (chunk, group of heads, batch), in
//      shared memory: K = (dy . x^T) * exp(cum_i - cum_j) (i >= j) and
//      G = C . B^T, whose products give
//        dx = W^T . dy + rem * (B . g^T)
//        dB = (K dt)^T . C + rem x . g     (summed over the CTA's heads)
//        dC = (K dt) . B + exp(cum) dy . h_in
//      and the gradient of cum: rows minus columns of K G dt (the
//      decays), -r rem with r_j = x_j . (B . g^T)_j (rem's), exp(cum_i)
//      dy_i . (C . h_in^T)_i (the inter-chunk term), and at the chunk's
//      last token exp(T) <h_in, g> + sum_j r_j rem_j.  Its reverse
//      cumulative sum, da, gives ddt = sum_i K_ij G_ij + r exp(T - cum)
//      + A da and the chunk's part of dA, sum_k da_k dt_k.
//   4. dB and dC: the CTAs' partials summed over groups of heads, in
//      group order.
//   5. dA: the (batch, chunk) partials summed in a fixed order.
// Every reduction runs in a fixed order, so one input gives the same bits
// in every run.
//
// Products run as the forward's, through the warp tiles both share
// (csrc/ssd_common.cuh): mma.sync m16n8k8 with the 3xTF32 split of
// csrc/tf32_mma.cuh (float32 accuracy), 16 x 32 warp tiles, operands
// formed as they are read (the decays, dt, rem and exp(cum) scalings),
// triangles skipped by depth; rows padded so a warp's fragment loads
// fall in distinct banks.
//
// Pass 3 stages B and C (Q, N), G and K (Q, Q), x, dy and one product
// (Q, P) and one state slice (P, N): 193,568 bytes at chunk 64, N 128, P
// 64, so a CTA an SM, one head at a time; g and h_in take the state slot
// in turn.  Its chunk is the forward's: the
// saved states are at its boundaries (kernels/ssd_scan/kernel.py,
// ssd_grad_plan, halves the forward's sub-chunk where this staging does
// not fit: 64 at N 128 and at N 64).
//
// Bound on an H100 SXM (published peaks, 700 W limit), for one
// mamba2-780m layer of the training cell (Bz 20, S 2048, H 48, P 64,
// N 128, chunk 64): x, dy, dt, B, C, the saved states and the gradients
// are ~2.6 GB (~0.78 ms at 3.35 TB/s); the products ~0.21 TFLOP (~3.1 ms
// at 67 TFLOP/s of f32 on the CUDA cores; the three-term split's ~0.63
// TFLOP at 495 TFLOP/s of TF32 take ~1.3 ms) -- chip_smoke.py's
// _ssd_bwd_work.  The scratch adds E and g (Bz n_chunks H P N floats,
// ~1 GB, written twice and read twice).  Measured: ~13 ms a call, the
// per-chunk pass most of it, latency-bound at one CTA an SM.
#include <cstdint>

#include "kernel_export.cuh"
#include "ssd_common.cuh"

namespace {

// pass 3 gives a thread each row and each column of the chunk's Q x Q
// products
constexpr int kMaxQp = kThreads / 2;

// A CTA's staging, in floats.  Q rows pad to 16 (the mma's rows), N to 8
// (its depth), P to 16 (rows of E).
struct Geometry {
    int Q, N, P, Qp, Np, Pp, ldBC, ldW, ldX, ldH;
    __host__ __device__ Geometry(int Q_, int N_, int P_)
        : Q(Q_), N(N_), P(P_), Qp(round_up(Q_, 16)), Np(round_up(N_, 8)),
          Pp(round_up(P_, 16)), ldBC(Np + 4), ldW(Qp + 4), ldX(Pp + 8),
          ldH(Np + 4) {}
    // pass 1: C (Qp, ldBC), dy (Qp, ldX), dt, cum, the scan's totals
    __host__ __device__ long long chunk_floats() const {
        return (long long)Qp * ldBC + (long long)Qp * ldX + 2LL * Qp
               + kWarps;
    }
    // pass 3: B, C (Qp, ldBC), G, K (Qp, ldW), x, dy, U/Y (Qp, ldX), a
    // state slice (Pp, ldH), eight vectors of Qp, the scans' totals
    __host__ __device__ long long main_floats() const {
        return 2LL * Qp * ldBC + 2LL * Qp * ldW + 3LL * Qp * ldX
               + (long long)Pp * ldH + 8LL * Qp + kWarps;
    }
};

// ------------------------------------------------------------- operands
// Operand (ssd_common.cuh) times a per-row scale
struct RowScaled {
    const float* p;
    int sr, sk;
    const float* s;
    __device__ __forceinline__ float at(int r, int k) const {
        return p[r * sr + k * sk] * s[r];
    }
};

// the same, times a per-depth scale
struct DepthScaled {
    const float* p;
    int sr, sk;
    const float* s;
    __device__ __forceinline__ float at(int r, int k) const {
        return p[r * sr + k * sk] * s[k];
    }
};

// two operands one after the other along the depth: k < ks from the
// first, the rest from the second
template <class First, class Second>
struct Joined {
    First a;
    Second b;
    int ks;
    __device__ __forceinline__ float at(int r, int k) const {
        return k < ks ? a.at(r, k) : b.at(r, k - ks);
    }
};

// W^T: element (j, i) = G_ij exp(cum_i - cum_j) dt_j for j <= i < Q,
// else 0 (the forward's W, read transposed)
struct DecayedScoresT {
    const float* g;
    int ld, Q;
    const float* cum;
    const float* dts;
    __device__ __forceinline__ float at(int j, int i) const {
        return (j <= i && i < Q) ? g[i * ld + j] * expf(cum[i] - cum[j])
                                       * dts[j]
                                 : 0.f;
    }
};

// a product's starting value (warp_tiles' init): what a buffer holds
struct Partial {
    const float* p;
    long long ld;
    int rows, cols;
    bool load;
    __device__ __forceinline__ float at(int r, int c) const {
        return load && r < rows && c < cols ? p[r * ld + c] : 0.f;
    }
};

// ---------------------------------------------------------- chunk terms
// out[k] = sum_{k <= i < Qp} in[k] for k < Qp: chunk_cumsum's scan
// (ssd_common.cuh) on the reversed index.  Qp <= kThreads.  Ends with
// the block synchronised.
__device__ void suffix_sum(const float* in, float* out, int Qp,
                           float* wsum) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float v = tid < Qp ? in[Qp - 1 - tid] : 0.f;
    if (warp * 32 < Qp) {
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float u = __shfl_up_sync(0xffffffffu, v, off);
            if (lane >= off) v += u;
        }
        if (lane == 31) wsum[warp] = v;
    }
    __syncthreads();
    if (tid < Qp) {
        float base = 0.f;
        for (int w = 0; w < warp; ++w) base += wsum[w];
        out[Qp - 1 - tid] = base + v;
    }
    __syncthreads();
}

// a warp's sum of v, the same order in every run
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// ---------------------------------------------------------------- pass 0
// h_in[c] = exp(T_{c-1}) h_in[c-1] + S_{c-1}, h_in[0] = 0, from the chunk
// states S into out; one thread per (batch, head, p, n)
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_in_kernel(const float* __restrict__ states,
                         const float* __restrict__ decays,
                         float* __restrict__ out, int Bz, int nc, int H,
                         int PN) {
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long per_batch = (long long)H * PN;
    if (e >= Bz * per_batch) return;
    const long long b = e / per_batch, r = e - b * per_batch;
    const int h = static_cast<int>(r / PN);
    float hv = 0.f;
    for (int c = 0; c < nc; ++c) {
        const long long off = (b * nc + c) * per_batch + r;
        out[off] = hv;
        hv = decays[(b * nc + c) * H + h] * hv + states[off];
    }
}

// ---------------------------------------------------------------- pass 1
// E_c = (dy * exp(cum))^T . C for chunks c >= 1; CTA (chunk - 1, group of
// hpc heads, batch), C staged once for the group
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_kernel(const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Cm,
                     const float* __restrict__ dy, float* __restrict__ E,
                     int S, int H, int P, int N, int Q, int nc, int hpc) {
    extern __shared__ float4 smem4[];
    const Geometry gm(Q, N, P);
    float* cs = reinterpret_cast<float*>(smem4);
    float* dys = cs + gm.Qp * gm.ldBC;
    float* dts = dys + gm.Qp * gm.ldX;
    float* cum = dts + gm.Qp;
    float* wsum = cum + gm.Qp;

    const int c = blockIdx.x + 1;
    const int h0 = blockIdx.y * hpc;
    const int b = blockIdx.z;
    const long long tok0 = (long long)b * S + (long long)c * Q;
    const long long xld = (long long)H * P;

    stage(cs, gm.ldBC, Cm + tok0 * N, N, Q, N, gm.Qp, gm.Np);
    for (int h = h0; h < h0 + hpc; ++h) {
        stage(dys, gm.ldX, dy + (tok0 * H + h) * P, xld, Q, P, gm.Qp,
              gm.Pp);
        chunk_cumsum(dt, tok0, H, h, Q, gm.Qp, A[h], dts, cum, wsum);
        if (threadIdx.x < gm.Qp) cum[threadIdx.x] = expf(cum[threadIdx.x]);
        cp_async_wait_all();
        __syncthreads();
        float* ec = E + (((long long)b * nc + c) * H + h) * P * N;
        warp_products(DepthScaled{dys, 1, gm.ldX, cum},
                      Operand{cs, 1, gm.ldBC}, gm.Pp, gm.Np, gm.Qp, kDense,
                      gm.Qp, [&](int p, int n, float v) {
            if (p < P && n < N) ec[(long long)p * N + n] = v;
        });
        __syncthreads();      // dy, dt and cum are staged anew per head
    }
}

// ---------------------------------------------------------------- pass 2
template <int V>
struct Vec;
template <>
struct Vec<1> {
    using T = float;
    __device__ static float dot(float a, float b) { return a * b; }
    __device__ static float axpy(float d, float g, float e) {
        return d * g + e;
    }
};
template <>
struct Vec<4> {
    using T = float4;
    __device__ static float dot(float4 a, float4 b) {
        return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
    __device__ static float4 axpy(float d, float4 g, float4 e) {
        return make_float4(d * g.x + e.x, d * g.y + e.y, d * g.z + e.z,
                           d * g.w + e.w);
    }
};

// CTA (slice of P N, batch x head): g_c over E_c's slot in reverse chunk
// order, and each warp's part of <h_in[c], g_c> into parts (parts per
// (batch, chunk, head), one a warp).  V elements a thread, P N % V == 0;
// U chunks' loads in flight at a time.
template <int V, int U>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const float* __restrict__ h_in,
                     const float* __restrict__ decays,
                     const float* __restrict__ dh_final,
                     float* __restrict__ gst, float* __restrict__ dots,
                     int nc, int H, int PN, int parts) {
    using Ops = Vec<V>;
    using T = typename Ops::T;
    const int bh = blockIdx.y;
    const long long b = bh / H;
    const int h = bh - static_cast<int>(b) * H;
    const long long unit = (long long)blockIdx.x * kThreads + threadIdx.x;
    const bool live = unit * V < PN;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    T g{};
    if (live && dh_final != nullptr)
        g = reinterpret_cast<const T*>(dh_final + (long long)bh * PN)[unit];
    for (int c0 = nc - 1; c0 >= 0; c0 -= U) {
        T hv[U], ev[U];
        float dv[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const int c = c0 - k;
            hv[k] = T{};
            ev[k] = T{};
            dv[k] = 0.f;
            if (c < 0) continue;
            const long long base = ((b * nc + c) * H + h) * PN;
            if (live) {
                hv[k] = reinterpret_cast<const T*>(h_in + base)[unit];
                if (c > 0)
                    ev[k] = reinterpret_cast<const T*>(gst + base)[unit];
            }
            dv[k] = decays[(b * nc + c) * H + h];
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const int c = c0 - k;
            if (c < 0) break;
            const long long base = ((b * nc + c) * H + h) * PN;
            if (live) reinterpret_cast<T*>(gst + base)[unit] = g;
            const float s = warp_sum(live ? Ops::dot(hv[k], g) : 0.f);
            if (lane == 0)
                dots[((b * nc + c) * H + h) * parts + blockIdx.x * kWarps
                     + warp] = s;
            g = Ops::axpy(dv[k], g, ev[k]);
        }
    }
}

// ---------------------------------------------------------------- pass 3
// CTA (chunk, group of hpc heads, batch)
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_main_kernel(const float* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ A,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ dy,
                    const float* __restrict__ h_in,
                    const float* __restrict__ decays,
                    const float* __restrict__ gst,
                    const float* __restrict__ dots, int parts,
                    float* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ dA_part, float* __restrict__ dB_part,
                    float* __restrict__ dC_part, int S, int H, int P, int N,
                    int Q, int hpc) {
    extern __shared__ float4 smem4[];
    const Geometry gm(Q, N, P);
    const int Qp = gm.Qp;
    float* bs = reinterpret_cast<float*>(smem4);
    float* cs = bs + Qp * gm.ldBC;
    float* gs = cs + Qp * gm.ldBC;
    float* ks = gs + Qp * gm.ldW;
    float* xs = ks + Qp * gm.ldW;
    float* dys = xs + Qp * gm.ldX;
    float* us = dys + Qp * gm.ldX;
    float* hs = us + Qp * gm.ldX;
    float* dts = hs + gm.Pp * gm.ldH;
    float* cum = dts + Qp;
    float* row = cum + Qp;        // sum_j K_ij G_ij dt_j; then da
    float* col = row + Qp;        // sum_i K_ij G_ij
    float* rr = col + Qp;         // r_j = x_j . U_j
    float* rem = rr + Qp;         // exp(T - cum_j) dt_j
    float* ecum = rem + Qp;       // exp(cum_i)
    float* dcum = ecum + Qp;
    float* wsum = dcum + Qp;

    const int c = blockIdx.x, nc = gridDim.x;
    const int grp = blockIdx.y, groups = gridDim.y;
    const int h0 = grp * hpc;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const long long tok0 = (long long)b * S + (long long)c * Q;
    const long long xld = (long long)H * P;
    const long long PN = (long long)P * N;

    stage(bs, gm.ldBC, Bm + tok0 * N, N, Q, N, Qp, gm.Np);
    stage(cs, gm.ldBC, Cm + tok0 * N, N, Q, N, Qp, gm.Np);
    cp_async_wait_all();
    __syncthreads();
    // G = C . B^T on the lower triangle, once for the CTA's heads
    warp_products(Operand{cs, gm.ldBC, 1}, Operand{bs, gm.ldBC, 1}, Qp, Qp,
                  gm.Np, kLowerOut, Qp, [&](int i, int j, float v) {
        gs[i * gm.ldW + j] = (j <= i && i < Q) ? v : 0.f;
    });

    for (int k = 0; k < hpc; ++k) {
        const int h = h0 + k;
        const long long sbase = (((long long)b * nc + c) * H + h) * PN;
        stage(xs, gm.ldX, x + (tok0 * H + h) * P, xld, Q, P, Qp, gm.Pp);
        stage(dys, gm.ldX, dy + (tok0 * H + h) * P, xld, Q, P, Qp, gm.Pp);
        stage(hs, gm.ldH, gst + sbase, N, P, N, gm.Pp, gm.Np);
        chunk_cumsum(dt, tok0, H, h, Q, Qp, A[h], dts, cum, wsum);
        cp_async_wait_all();
        __syncthreads();
        const float total = cum[Q - 1];

        // K = (dy . x^T) * exp(cum_i - cum_j) on the lower triangle
        warp_products(Operand{dys, gm.ldX, 1}, Operand{xs, gm.ldX, 1}, Qp,
                      Qp, gm.Pp, kLowerOut, Qp, [&](int i, int j, float v) {
            ks[i * gm.ldW + j] = (j <= i && i < Q)
                                     ? v * expf(cum[i] - cum[j])
                                     : 0.f;
        });
        // U = B . g^T
        warp_products(Operand{bs, gm.ldBC, 1}, Operand{hs, gm.ldH, 1}, Qp,
                      gm.Pp, gm.Np, kDense, Qp, [&](int j, int p, float v) {
            us[j * gm.ldX + p] = v;
        });
        if (tid < Qp) {
            rem[tid] = expf(total - cum[tid]) * dts[tid];
            ecum[tid] = expf(cum[tid]);
        }
        __syncthreads();
        if (tid < Qp) {
            float s = 0.f, r = 0.f;
            for (int j = 0; j <= tid; ++j)
                s += ks[tid * gm.ldW + j] * gs[tid * gm.ldW + j] * dts[j];
            for (int p = 0; p < gm.Pp; ++p)
                r += xs[tid * gm.ldX + p] * us[tid * gm.ldX + p];
            row[tid] = s;
            rr[tid] = r;
        } else if (tid < 2 * Qp) {
            const int j = tid - Qp;
            float s = 0.f;
            for (int i = j; i < Qp; ++i)
                s += ks[i * gm.ldW + j] * gs[i * gm.ldW + j];
            col[j] = s;
        }
        // dx = W^T . dy + rem * U
        float* dxc = dx + (tok0 * H + h) * P;
        warp_products(DecayedScoresT{gs, gm.ldW, Q, cum, dts},
                      Operand{dys, 1, gm.ldX}, Qp, gm.Pp, Qp, kUpperA, Qp,
                      [&](int j, int p, float v) {
            if (j < Q && p < P)
                dxc[j * xld + p] = v + rem[j] * us[j * gm.ldX + p];
        });
        // dB = (K dt)^T . C + rem x . g, summed over the CTA's heads
        const long long pld = (long long)groups * N;
        const long long poff = (tok0 * groups + grp) * N;
        warp_products(
            Joined<RowScaled, RowScaled>{
                RowScaled{ks, 1, gm.ldW, dts}, RowScaled{xs, gm.ldX, 1, rem},
                Qp},
            Joined<Operand, Operand>{Operand{cs, 1, gm.ldBC},
                                     Operand{hs, 1, gm.ldH}, Qp},
            Qp, gm.Np, Qp + gm.Pp, kUpperA, Qp,
            Partial{dB_part + poff, pld, Q, N, k > 0},
            [&](int j, int n, float v) {
                if (j < Q && n < N) dB_part[poff + j * pld + n] = v;
            });
        __syncthreads();      // g and U are read: h_in and Y take them

        stage(hs, gm.ldH, h_in + sbase, N, P, N, gm.Pp, gm.Np);
        cp_async_wait_all();
        __syncthreads();
        // Y = C . h_in^T
        warp_products(Operand{cs, gm.ldBC, 1}, Operand{hs, gm.ldH, 1}, Qp,
                      gm.Pp, gm.Np, kDense, Qp, [&](int i, int p, float v) {
            us[i * gm.ldX + p] = v;
        });
        // dC = (K dt) . B + exp(cum) dy . h_in, summed over the heads
        warp_products(
            Joined<DepthScaled, RowScaled>{
                DepthScaled{ks, gm.ldW, 1, dts},
                RowScaled{dys, gm.ldX, 1, ecum}, Qp},
            Joined<Operand, Operand>{Operand{bs, 1, gm.ldBC},
                                     Operand{hs, 1, gm.ldH}, Qp},
            Qp, gm.Np, Qp + gm.Pp, kLowerA, Qp,
            Partial{dC_part + poff, pld, Q, N, k > 0},
            [&](int i, int n, float v) {
                if (i < Q && n < N) dC_part[poff + i * pld + n] = v;
            });
        __syncthreads();

        // the gradient of cum
        if (tid < Qp) {
            float q = 0.f;
            for (int p = 0; p < gm.Pp; ++p)
                q += dys[tid * gm.ldX + p] * us[tid * gm.ldX + p];
            dcum[tid] = tid < Q ? row[tid] - dts[tid] * col[tid]
                                      - rr[tid] * rem[tid] + ecum[tid] * q
                                : 0.f;
        }
        // the chunk's decay: exp(T) <h_in, g> (warp 0, from the state
        // pass's partials) and sum_j r_j rem_j (warp 1)
        if (tid < 64) {
            const float* dp = dots + (((long long)b * nc + c) * H + h)
                                         * parts;
            float v = 0.f;
            if (tid < 32)
                for (int w = tid; w < parts; w += 32) v += dp[w];
            else
                for (int j = tid - 32; j < Q; j += 32) v += rr[j] * rem[j];
            v = warp_sum(v);
            if (tid == 0) wsum[0] = v;
            if (tid == 32) wsum[1] = v;
        }
        __syncthreads();
        if (tid == 0)
            dcum[Q - 1] += decays[((long long)b * nc + c) * H + h] * wsum[0]
                           + wsum[1];
        __syncthreads();
        suffix_sum(dcum, row, Qp, wsum);        // row now holds da
        if (tid < Q)
            ddt[(tok0 + tid) * H + h] = col[tid]
                                        + rr[tid] * expf(total - cum[tid])
                                        + A[h] * row[tid];
        if (tid < 32) {
            float s = 0.f;
            for (int i = tid; i < Q; i += 32) s += row[i] * dts[i];
            s = warp_sum(s);
            if (tid == 0) dA_part[((long long)b * nc + c) * H + h] = s;
        }
        __syncthreads();      // x, dy, g and the vectors are staged anew
    }
}

// ---------------------------------------------------------- passes 4, 5
// dB, dC (Bz S, N) = the groups' partials (Bz S, groups, N), summed in
// group order; one thread per element
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_groups_kernel(const float* __restrict__ dB_part,
                          const float* __restrict__ dC_part,
                          float* __restrict__ dB, float* __restrict__ dC,
                          long long rows, int groups, int N) {
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= rows * N) return;
    const long long r = e / N;
    const int n = static_cast<int>(e - r * N);
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < groups; ++g) {
        sb += dB_part[(r * groups + g) * N + n];
        sc += dC_part[(r * groups + g) * N + n];
    }
    dB[e] = sb;
    dC[e] = sc;
}

// dA[h] = the (batch, chunk) partials of head h, a warp a head
__global__ void __launch_bounds__(32)
ssd_bwd_sum_dA_kernel(const float* __restrict__ dA_part,
                      float* __restrict__ dA, long long rows, int H) {
    const int h = blockIdx.x;
    float s = 0.f;
    for (long long r = threadIdx.x; r < rows; r += 32)
        s += dA_part[r * H + h];
    s = warp_sum(s);
    if (threadIdx.x == 0) dA[h] = s;
}

unsigned blocks(long long threads) {
    return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// x, dy: (Bz, S, H, P); dt: (Bz, S, H); A: (H,); B, C: (Bz, S, N);
// dh_final: (Bz, H, P, N) or null (no gradient reaches the final state);
// states: the forward's scratch at this chunk -- (Bz, n_chunks, H, P, N)
// states entering each chunk (with walk set: each chunk's own state),
// then (Bz, n_chunks, H) exp(T_c) -- read only.  Outputs dx (Bz, S, H,
// P), ddt (Bz, S, H), dA (H,), dB, dC (Bz, S, N); scratch:
// ssd_bwd_scratch_floats in kernels/ssd_scan/kernel.py.  All contiguous
// float32; S % chunk == 0, chunk rounded up to 16 at most 128, H %
// heads_per_cta == 0, walk set iff 2 <= n_chunks <= kWalkChunks (checked
// here; the Python wrapper mirrors the last two), the staging within the
// opt-in shared memory (checked by the Python wrapper).
KERNEL_EXPORT int ssd_scan_bwd(const float* x, const float* dt,
                               const float* A, const float* B,
                               const float* C, const float* dy,
                               const float* dh_final, const float* states,
                               float* dx, float* ddt, float* dA, float* dB,
                               float* dC, float* scratch, int Bz, int S,
                               int H, int P, int N, int chunk,
                               int heads_per_cta, int walk, void* stream) {
    const int hpc = heads_per_cta;
    if (Bz <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 || S <= 0
        || S % chunk || hpc <= 0 || H % hpc || H / hpc > 65535
        || Bz > 65535 || (long long)Bz * H > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const int nc = S / chunk, groups = H / hpc;
    const Geometry gm(chunk, N, P);
    // walk says what the forward left, and sizes the scratch: it must be
    // the forward's own choice
    if (gm.Qp > kMaxQp || (walk != 0) != (nc > 1 && nc <= kWalkChunks))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long smem_chunk = gm.chunk_floats() * 4;
    const long long smem_main = gm.main_floats() * 4;
    static long long granted_chunk = 48 * 1024, granted_main = 48 * 1024;
    cudaError_t err = opt_in(
        reinterpret_cast<const void*>(ssd_bwd_chunk_kernel), smem_chunk,
        granted_chunk);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = opt_in(reinterpret_cast<const void*>(ssd_bwd_main_kernel),
                 smem_main, granted_main);
    if (err != cudaSuccess) return static_cast<int>(err);

    const int PN = P * N;
    const int V = PN % 4 == 0 ? 4 : 1;
    const int slices = (PN / V + kThreads - 1) / kThreads;
    const int parts = slices * kWarps;
    const long long state_floats = (long long)Bz * nc * H * PN;
    const float* decays = states + state_floats;
    float* gst = scratch;
    float* hin = gst + state_floats;
    float* dots = hin + (walk ? state_floats : 0);
    float* dB_part = dots + (long long)Bz * nc * H * parts;
    float* dC_part = dB_part + (long long)Bz * S * groups * N;
    float* dA_part = dC_part + (long long)Bz * S * groups * N;
    const float* h_in = walk ? hin : states;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);

    if (walk) {
        ssd_bwd_states_in_kernel<<<blocks(state_floats / nc), kThreads, 0,
                                   s>>>(states, decays, hin, Bz, nc, H, PN);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (nc > 1) {
        ssd_bwd_chunk_kernel<<<dim3(nc - 1, groups, Bz), kThreads,
                               static_cast<size_t>(smem_chunk), s>>>(
            dt, A, C, dy, gst, S, H, P, N, chunk, nc, hpc);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 sgrid(slices, Bz * H);
    if (V == 4)
        ssd_bwd_state_kernel<4, 4><<<sgrid, kThreads, 0, s>>>(
            h_in, decays, dh_final, gst, dots, nc, H, PN, parts);
    else
        ssd_bwd_state_kernel<1, 8><<<sgrid, kThreads, 0, s>>>(
            h_in, decays, dh_final, gst, dots, nc, H, PN, parts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_main_kernel<<<dim3(nc, groups, Bz), kThreads,
                          static_cast<size_t>(smem_main), s>>>(
        x, dt, A, B, C, dy, h_in, decays, gst, dots, parts, dx, ddt, dA_part,
        dB_part, dC_part, S, H, P, N, chunk, hpc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long rows = (long long)Bz * S;
    ssd_bwd_sum_groups_kernel<<<blocks(rows * N), kThreads, 0, s>>>(
        dB_part, dC_part, dB, dC, rows, groups, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_sum_dA_kernel<<<H, 32, 0, s>>>(dA_part, dA, (long long)Bz * nc,
                                           H);
    return static_cast<int>(cudaGetLastError());
}
