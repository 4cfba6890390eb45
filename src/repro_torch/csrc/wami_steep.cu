// WAMI steepest-descent images and Gauss-Newton Hessian for Hopper
// (sm_90a): the template side of inverse-compositional Lucas-Kanade.
//
// Replaces the Pallas kernels of src/repro/kernels/wami_steep/kernel.py:
//
//   steepest_descent_kernel -> wami_steepest_descent:
//     sd = (gx*x, gx*y, gx, gy*x, gy*y, gy), written in the (H, W, 6)
//     layout of the reference output.  Bound on an H100 SXM (published
//     peaks, 700 W limit): bytes, 8 B read and 24 B written per pixel
//     (524,288 B at tile 128: 0.16 us at 3.35 TB/s; 8.4 MB at 512 x 512:
//     2.5 us).  The pixel coordinates come from blockIdx and the tile
//     offsets, so no coordinate plane is read.  A thread owns a run of 4
//     adjacent pixels of a row (Run4Body, wami_common.cuh): one 16-byte
//     load from gx and one from gy, and the run's 24 results are 96
//     contiguous bytes of the output, six 16-byte stores; a CTA takes up
//     to 1,024 threads (run4_threads), so every Table-1 tile of the
//     128 x 128 frame is one pass and of the 512 x 512 frame at most two.
//     A thread's own six stores stride 96 bytes across the warp, so
//     above kScalarPixels pixels a tile, wherever every tile row is whole
//     runs, the warp stages them through shared memory in two halves, 48
//     bytes a thread (blockDim.x * 48 bytes a CTA, within the 48 KB a
//     launch gets without opting in): lanes 16 h .. 16 h + 15 write
//     their 24 floats, and the whole warp stores those 16 runs' 96 float4
//     in order, 512 contiguous bytes a store.  Tiles of at most
//     kScalarPixels pixels take one pixel a thread, and a row's pixels off
//     the runs (a tile off the 16-byte grid, W % 4 != 0, a pointer off the
//     grid) the scalar path.  Measured on an H100 (DSE walls, two runs
//     each): staged stores against direct ones 0.3-0.35 us faster a launch
//     at 512 pixels a tile, 0.8-1.8 us at 1,024-2,048, and 512 x 512 at
//     (1, 8) 4.8 against 10.1 us; at 256 pixels staged runs were 0.03-0.26
//     us faster than one pixel a thread, at 128 pixels 0.17-0.22 us slower
//     at two of four points.  Each result is one product or a copy: the
//     same bits as the plain version.
//
//   hessian_kernel -> wami_hessian:
//     H = sum_x sd(x) sd(x)^T, (6, 6).  Bound on an H100 SXM (published
//     peaks, 700 W limit): bytes, 24 B read per pixel for 42 flops
//     (393,216 B at tile 128: 0.12 us; 6.3 MB at 512 x 512: 1.9 us).
//     The TPU kernel walks its grid in sequence and accumulates into one
//     resident (6, 6) block; CTAs on the card run in no order, so the sum
//     crosses CTAs in one launch with no float atomics: each thread sums
//     the 21 distinct products of its pixels in a fixed order (a pixel's
//     24 bytes as three 8-byte loads, eight pixels' loads in flight at
//     once), each warp folds them by a fixed shuffle tree, the CTA adds
//     its warps in order and writes all 36 entries to
//     partials[i * ports + j]; then, after a __threadfence(),
//     it takes a ticket from an integer counter, and the CTA that draws
//     the last ticket sums the partials in index order, writes out and
//     sets the counter back to 0 for the next call.  The result is the
//     same bits from run to run; it depends on the knobs only through the
//     partition.  One launch, where two launches' latency set the time of
//     the earlier two-pass design at tile 128.
#include <cstdint>

#include "wami_common.cuh"

namespace {

constexpr int kHessThreads = 256;   // Hessian CTA size
constexpr int kHessWarps = kHessThreads / 32;
constexpr int kHessBatch = 8;       // pixels a thread loads at once
constexpr int kSyms = 21;           // distinct entries of a symmetric 6x6

// index of (a, b), a <= b, in the row-major upper triangle
__host__ __device__ constexpr int sym_index(int a, int b) {
    return a * 6 - a * (a - 1) / 2 + (b - a);
}

constexpr int kScalarPixels = 128;  // tiles up to this: one pixel a thread

// the six sd images of a pixel at (xf, yf) with gradients (a, b)
__device__ __forceinline__ void sd_px(float a, float b, float xf, float yf,
                                      float* o) {
    o[0] = a * xf;
    o[1] = a * yf;
    o[2] = a;
    o[3] = b * xf;
    o[4] = b * yf;
    o[5] = b;
}

template <int BODY>
__global__ void __launch_bounds__(1024)
steepest_descent_kernel(const float* __restrict__ gx,
                        const float* __restrict__ gy,
                        float* __restrict__ sd, int W, int bh, int bw,
                        int vec) {
    const WamiTile t(bh, bw);
    const RowSplit rs = body_split<BODY>(t, vec != 0);
    const int n_runs = bh * rs.runs;
    const int items = BODY == kStaged ? n_runs
                                      : n_runs + bh * (rs.head + rs.tail);
    extern __shared__ float4 stage4[];
    const int lane = threadIdx.x & 31;
    float* sb = reinterpret_cast<float*>(stage4) + (threadIdx.x - lane) * 12;
    for (int e = threadIdx.x; e < items; e += blockDim.x) {
        int r, c;
        const bool run = run4_item<BODY>(e, rs, n_runs, r, c);
        const int x = t.col0 + c;
        const float yf = static_cast<float>(t.row0 + r);
        const long long p = (long long)(t.row0 + r) * W + x;
        if (run) {
            float a[4], b[4], o[24];
            ld4(a, gx + p);
            ld4(b, gy + p);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                sd_px(a[i], b[i], static_cast<float>(x + i), yf, o + 6 * i);
            const long long off = 6 * p;
            if (BODY == kStaged && e - lane + 32 <= n_runs) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if ((lane >> 4) == h) {
#pragma unroll
                        for (int k = 0; k < 6; ++k)
                            st4(sb + 24 * (lane & 15) + 4 * k, o + 4 * k);
                    }
                    __syncwarp();
#pragma unroll
                    for (int k = 0; k < 3; ++k) {
                        const int f = lane + 32 * k, run_f = f / 6;
                        const long long at =
                            __shfl_sync(0xffffffffu, off, 16 * h + run_f);
                        *reinterpret_cast<float4*>(sd + at
                                                   + 4 * (f - 6 * run_f)) =
                            *reinterpret_cast<const float4*>(sb + 4 * f);
                    }
                    __syncwarp();
                }
            } else {
#pragma unroll
                for (int k = 0; k < 6; ++k) st4(sd + off + 4 * k, o + 4 * k);
            }
        } else {
            sd_px(__ldg(gx + p), __ldg(gy + p), static_cast<float>(x), yf,
                  sd + 6 * p);
        }
    }
}

__global__ void __launch_bounds__(kHessThreads)
hessian_kernel(const float* __restrict__ sd, float* __restrict__ partials,
               unsigned int* __restrict__ ticket, float* __restrict__ out,
               int W, int bh, int bw) {
    __shared__ float warp_sums[kHessWarps][kSyms];
    __shared__ float cta_sums[kSyms];
    __shared__ bool last;
    const WamiTile t(bh, bw);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float acc[kSyms];
#pragma unroll
    for (int k = 0; k < kSyms; ++k) acc[k] = 0.0f;
    // kHessBatch pixels' loads in flight, then their products in pixel
    // order
    for (int e0 = threadIdx.x; e0 < t.pixels();
         e0 += kHessBatch * kHessThreads) {
        float2 px[kHessBatch][3];
#pragma unroll
        for (int q = 0; q < kHessBatch; ++q) {
            const int e = e0 + q * kHessThreads;
            if (e < t.pixels()) {
                const int r = e / bw, c = e - r * bw;
                const float2* s = reinterpret_cast<const float2*>(
                    sd + 6 * ((long long)(t.row0 + r) * W + t.col0 + c));
                px[q][0] = s[0];
                px[q][1] = s[1];
                px[q][2] = s[2];
            }
        }
#pragma unroll
        for (int q = 0; q < kHessBatch; ++q) {
            if (e0 + q * kHessThreads < t.pixels()) {
                const float v[6] = {px[q][0].x, px[q][0].y, px[q][1].x,
                                    px[q][1].y, px[q][2].x, px[q][2].y};
#pragma unroll
                for (int a = 0; a < 6; ++a) {
#pragma unroll
                    for (int b = a; b < 6; ++b)
                        acc[sym_index(a, b)] += v[a] * v[b];
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < kSyms; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    }
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kSyms; ++k) warp_sums[warp][k] = acc[k];
    }
    __syncthreads();
    if (threadIdx.x < kSyms) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kHessWarps; ++w) s += warp_sums[w][threadIdx.x];
        cta_sums[threadIdx.x] = s;
    }
    __syncthreads();
    const int n_blocks = gridDim.x * gridDim.y;
    if (threadIdx.x < 36) {
        const int a = threadIdx.x / 6, b = threadIdx.x % 6;
        const int blk = blockIdx.x * gridDim.y + blockIdx.y;
        partials[blk * 36 + threadIdx.x] =
            cta_sums[sym_index(min(a, b), max(a, b))];
        __threadfence();     // the partials reach L2 before the ticket
    }
    __syncthreads();
    if (threadIdx.x == 0)
        last = atomicAdd(ticket, 1u) == static_cast<unsigned>(n_blocks - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (threadIdx.x < 36) {
        float s = 0.0f;
#pragma unroll 8
        for (int blk = 0; blk < n_blocks; ++blk)
            s += __ldcg(partials + blk * 36 + threadIdx.x);
        out[threadIdx.x] = s;
    }
    if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace

// gx, gy: (H, W) float32 -> sd: (H, W, 6) float32; W % ports == 0 and
// H % unrolls == 0 (checked by the Python wrapper).  Threads per CTA: one
// a pixel up to kScalarPixels pixels a tile, else run4_threads
// (wami_common.cuh) -- kernels/wami_steep/kernel.py's
// steepest_descent_geometry is the same formula.
WAMI_EXPORT int wami_steepest_descent(const float* gx, const float* gy,
                                      float* sd, int H, int W, int ports,
                                      int unrolls, void* stream) {
    const int bh = unrolls, bw = W / ports;
    const bool vec = W % 4 == 0
                     && ((reinterpret_cast<uintptr_t>(gx)
                          | reinterpret_cast<uintptr_t>(gy)
                          | reinterpret_cast<uintptr_t>(sd)) & 15) == 0;
    const dim3 grid(H / unrolls, ports);
    const int threads = run4_threads(ports, bh, bw, vec);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    // whole runs above kScalarPixels always stage (stage_px 0)
    switch (run4_body(bh, bw, vec, kScalarPixels, 0)) {
        case kScalar:
            steepest_descent_kernel<kScalar>
                <<<grid, wami_threads(bh * bw), 0, s>>>(gx, gy, sd, W, bh,
                                                         bw, 0);
            break;
        case kStaged:
            steepest_descent_kernel<kStaged>
                <<<grid, threads, threads * 48, s>>>(gx, gy, sd, W, bh, bw,
                                                     1);
            break;
        default:
            steepest_descent_kernel<kMixed><<<grid, threads, 0, s>>>(
                gx, gy, sd, W, bh, bw, vec ? 1 : 0);
            break;
    }
    return static_cast<int>(cudaGetLastError());
}

// sd: (H, W, 6) float32 -> out: (6, 6) float32, in one launch, through
// partials ((H / unrolls) * ports, 36) float32 and a ticket counter that
// is 0 before the call and 0 again after it (scratch the wrapper keeps;
// calls that share it run on one stream).
WAMI_EXPORT int wami_hessian(const float* sd, float* partials,
                             unsigned int* ticket, float* out, int H, int W,
                             int ports, int unrolls, void* stream) {
    const int bh = unrolls, bw = W / ports;
    const dim3 grid(H / unrolls, ports);
    hessian_kernel<<<grid, kHessThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        sd, partials, ticket, out, W, bh, bw);
    return static_cast<int>(cudaGetLastError());
}
