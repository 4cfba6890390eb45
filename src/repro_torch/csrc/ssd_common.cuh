// What csrc/ssd_scan.cu (the chunked SSD's forward) and
// csrc/ssd_scan_bwd.cu (its backward) share (sm_90a): the CTA's size, the
// chunk count up to which a chunk walks the states before it, the staging
// copies, the 3xTF32 warp-tile products and the chunk's cumulative
// log-decay.  One copy, so the two passes stage, multiply and scan alike
// (the backward reads the forward's cum bit for bit).
#pragma once

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// up to this many chunks the forward's output pass walks the chunk states
// itself (each CTA reads the states before its chunk, in chunk order) and
// the state pass is not launched; its scratch then holds each chunk's own
// state, from which the backward walks the states entering each chunk
constexpr int kWalkChunks = 8;

__host__ __device__ constexpr int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// ---------------------------------------------------------------- copies
// rows x cols of a row-major global block (row stride ld floats) into
// shared memory (row stride sld, a multiple of 4), zero-filled out to
// rows_p x cols_p (cols_p a multiple of 4): 16-byte copies when every row
// starts 16-byte aligned, 4-byte copies otherwise.
__device__ void stage(float* dst, int sld, const float* src, long long ld,
                      int rows, int cols, int rows_p, int cols_p) {
    const bool vec = ((reinterpret_cast<uintptr_t>(src)
                       | static_cast<uintptr_t>(ld * 4)
                       | static_cast<uintptr_t>(cols * 4)) & 15) == 0;
    if (vec) {
        const int units = cols_p / 4;
        for (int e = threadIdx.x; e < rows_p * units; e += kThreads) {
            const int r = e / units, c = (e - r * units) * 4;
            float* d = dst + r * sld + c;
            if (r < rows && c < cols)
                cp_async16(d, src + r * ld + c);
            else
                *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f,
                                                            0.f);
        }
    } else {
        for (int e = threadIdx.x; e < rows_p * cols_p; e += kThreads) {
            const int r = e / cols_p, c = e - r * cols_p;
            float* d = dst + r * sld + c;
            if (r < rows && c < cols)
                cp_async4(d, src + r * ld + c);
            else
                *d = 0.f;
        }
    }
}

// --------------------------------------------------------------- operands
// an operand of D = A . B^T in shared memory: element (row, k) at
// p[row * sr + k * sk]
struct Operand {
    const float* p;
    int sr, sk;
    __device__ __forceinline__ float at(int r, int k) const {
        return p[r * sr + k * sk];
    }
};

// ---------------------------------------------------------- tensor cores
// kLowerOut: 16 x 8 output tiles wholly above the diagonal are not formed
// (epi gets 0 there).  kLowerA: A(row, k) = 0 for row < k < ks, so that
// part of the depth stops at the warp tile's last row.  kUpperA:
// A(row, k) = 0 for k < row (k < ks), so the depth starts at the tile's
// first row.
enum Shape { kDense, kLowerOut, kLowerA, kUpperA };

// the value a product's sum starts from: 0, or (the backward's Partial)
// what a buffer holds, read before the depth loop so that its latency is
// hidden
struct Zero {
    __device__ __forceinline__ float at(int, int) const { return 0.f; }
};

// D (M x Nn) = init + A (M x K) . B (Nn x K)^T over warp tiles of 16 MT
// x 8 NT: one A fragment feeds NT mma columns, one B fragment MT mma
// rows, and the CTA's warps take tiles in turn; epi(row, col, value)
// takes each element with row < M and col < Nn.  M % 16 == 0, Nn % 8 ==
// 0, K % 8 == 0, ks % 16 == 0, operands zero-padded.  The three products
// of the split go to three accumulators, so no two successive mma wait on
// each other.  Without kSplitDepth (the forward's products: init 0, ks =
// K, no kUpperA) the depth is one loop: the two loops cost the forward
// 1.5-2% at model width on an H100, for the same bits.
template <int MT, int NT, bool kSplitDepth, class OpA, class OpB,
          class Init, class Epilogue>
__device__ void warp_tiles(OpA A, OpB B, int M, int Nn, int K, Shape shape,
                           int ks, Init init, Epilogue epi) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int tm = (M + 16 * MT - 1) / (16 * MT);
    const int tn = (Nn + 8 * NT - 1) / (8 * NT);
    for (int tile = warp; tile < tm * tn; tile += kWarps) {
        const int m0 = tile / tn * 16 * MT, n0 = tile % tn * 8 * NT;
        bool live[MT][NT];
        bool any = false;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int mi = m0 + 16 * i, nj = n0 + 8 * j;
                live[i][j] = mi < M && nj < Nn
                             && !(shape == kLowerOut && nj >= mi + 16);
                any = any || live[i][j];
            }
        }
        float acc[3][MT][NT][4];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[a][i][j][q] = 0.f;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int r = m0 + 16 * i + g, c = n0 + 8 * j + 2 * t;
                acc[0][i][j][0] = init.at(r, c);
                acc[0][i][j][1] = init.at(r, c + 1);
                acc[0][i][j][2] = init.at(r + 8, c);
                acc[0][i][j][3] = init.at(r + 8, c + 1);
            }
        }
        const auto step = [&](int k0) {
            uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const int r = min(m0 + 16 * i, M - 16) + g;
                split_tf32(A.at(r, k0 + t), ab[i][0], as[i][0]);
                split_tf32(A.at(r + 8, k0 + t), ab[i][1], as[i][1]);
                split_tf32(A.at(r, k0 + t + 4), ab[i][2], as[i][2]);
                split_tf32(A.at(r + 8, k0 + t + 4), ab[i][3], as[i][3]);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int c = min(n0 + 8 * j, Nn - 8) + g;
                split_tf32(B.at(c, k0 + t), bb[j][0], bs[j][0]);
                split_tf32(B.at(c, k0 + t + 4), bb[j][1], bs[j][1]);
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    if (!live[i][j]) continue;
                    mma_tf32(acc[0][i][j], ab[i], bb[j]);
                    mma_tf32(acc[1][i][j], ab[i], bs[j]);
                    mma_tf32(acc[2][i][j], as[i], bb[j]);
                }
            }
        };
        if constexpr (kSplitDepth) {
            // the depth runs over [0, skip_lo) and [skip_hi, K)
            int skip_lo = K, skip_hi = K;
            if (shape == kLowerA) {
                skip_lo = min(ks, m0 + 16 * MT);
                skip_hi = ks;
            } else if (shape == kUpperA) {
                skip_lo = 0;
                skip_hi = min(ks, m0);
            }
            if (any) {
#pragma unroll 2
                for (int k0 = 0; k0 < skip_lo; k0 += 8) step(k0);
#pragma unroll 2
                for (int k0 = skip_hi; k0 < K; k0 += 8) step(k0);
            }
        } else {
            const int k_end = !any                ? 0
                              : shape == kLowerA ? min(K, m0 + 16 * MT)
                                                 : K;
#pragma unroll 2
            for (int k0 = 0; k0 < k_end; k0 += 8) step(k0);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int mi = m0 + 16 * i, nj = n0 + 8 * j;
                if (mi >= M || nj >= Nn) continue;
                float v[4];
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    v[q] = acc[0][i][j][q]
                           + (acc[1][i][j][q] + acc[2][i][j][q]);
                epi(mi + g, nj + 2 * t, v[0]);
                epi(mi + g, nj + 2 * t + 1, v[1]);
                epi(mi + g + 8, nj + 2 * t, v[2]);
                epi(mi + g + 8, nj + 2 * t + 1, v[3]);
            }
        }
    }
}

// 16 x 32 warp tiles where they still give every warp one (the
// model-width products), else 16 x 8 tiles, which keep more warps busy on
// the small products of the DSE's geometry
template <bool kSplitDepth, class OpA, class OpB, class Init,
          class Epilogue>
__device__ void tiled_products(OpA A, OpB B, int M, int Nn, int K,
                               Shape shape, int ks, Init init, Epilogue epi) {
    if ((M / 16) * ((Nn + 31) / 32) >= kWarps)
        warp_tiles<1, 4, kSplitDepth>(A, B, M, Nn, K, shape, ks, init, epi);
    else
        warp_tiles<1, 1, kSplitDepth>(A, B, M, Nn, K, shape, ks, init, epi);
}

// from an initial sum, a depth that may skip [skip_lo, skip_hi)
template <class OpA, class OpB, class Init, class Epilogue>
__device__ void warp_products(OpA A, OpB B, int M, int Nn, int K,
                              Shape shape, int ks, Init init, Epilogue epi) {
    tiled_products<true>(A, B, M, Nn, K, shape, ks, init, epi);
}

template <class OpA, class OpB, class Epilogue>
__device__ void warp_products(OpA A, OpB B, int M, int Nn, int K,
                              Shape shape, int ks, Epilogue epi) {
    tiled_products<true>(A, B, M, Nn, K, shape, ks, Zero{}, epi);
}

// from 0 over the whole depth (kLowerA: up to the tile's last row)
template <class OpA, class OpB, class Epilogue>
__device__ void warp_products(OpA A, OpB B, int M, int Nn, int K,
                              Shape shape, Epilogue epi) {
    tiled_products<false>(A, B, M, Nn, K, shape, K, Zero{}, epi);
}

// ---------------------------------------------------------- chunk terms
// dt of the chunk (0 past Q) into dts, then cum[i] = sum_{k <= i} dt_k a
// for i < Qp: a shuffle scan in each warp, then the warps' totals (the
// backward's cum has the forward's bits).  Qp <= kThreads.  Ends with the block synchronised.
__device__ void chunk_cumsum(const float* __restrict__ dt, long long tok0,
                             int H, int h, int Q, int Qp, float a,
                             float* dts, float* cum, float* wsum) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float v = 0.f;
    if (tid < Qp) {
        const float d = tid < Q ? dt[(tok0 + tid) * H + h] : 0.f;
        dts[tid] = d;
        v = d * a;
    }
    if (warp * 32 < Qp) {           // whole warps: the shuffles need all
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
        cum[tid] = base + v;
    }
    __syncthreads();
}

cudaError_t opt_in(const void* kernel, long long bytes, long long& granted) {
    if (bytes <= granted) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err == cudaSuccess) granted = bytes;
    return err;
}

}  // namespace
