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
//     offsets, so no coordinate plane is read, and the six results of a
//     pixel are one 24-byte run (a warp writes one contiguous 768-byte
//     run).
//
//   hessian_kernel -> wami_hessian:
//     H = sum_x sd(x) sd(x)^T, (6, 6).  Bound on an H100 SXM (published
//     peaks, 700 W limit): bytes, 24 B read per pixel for 42 flops
//     (393,216 B at tile 128: 0.12 us; 6.3 MB at 512 x 512: 1.9 us).
//     The TPU kernel walks its grid in sequence and accumulates into one
//     resident (6, 6) block; CTAs on the card run in no order, so the sum
//     takes two passes with no float atomics: pass 1 has every CTA reduce
//     its tile to the 21 distinct sums (each thread in its own fixed
//     element order, then a fixed shared-memory tree) and write all 36
//     entries to partials[i * ports + j]; pass 2 is one CTA that sums the
//     partials in index order.  The result is the same bits from run to
//     run; it depends on the knobs only through the partition.
#include "wami_common.cuh"

namespace {

constexpr int kHessThreads = 256;   // pass-1 CTA size (the tree's width)
constexpr int kSyms = 21;           // distinct entries of a symmetric 6x6

// index of (a, b), a <= b, in the row-major upper triangle
__host__ __device__ constexpr int sym_index(int a, int b) {
    return a * 6 - a * (a - 1) / 2 + (b - a);
}

__global__ void steepest_descent_kernel(const float* __restrict__ gx,
                                        const float* __restrict__ gy,
                                        float* __restrict__ sd, int W,
                                        int bh, int bw) {
    const WamiTile t(bh, bw);
    for (int e = threadIdx.x; e < t.pixels(); e += blockDim.x) {
        const int r = e / bw, c = e - r * bw;
        const float yf = static_cast<float>(t.row0 + r);
        const float xf = static_cast<float>(t.col0 + c);
        const long long p = (long long)(t.row0 + r) * W + t.col0 + c;
        const float a = gx[p], b = gy[p];
        float* o = sd + 6 * p;
        o[0] = a * xf;
        o[1] = a * yf;
        o[2] = a;
        o[3] = b * xf;
        o[4] = b * yf;
        o[5] = b;
    }
}

__global__ void __launch_bounds__(kHessThreads)
hessian_partials_kernel(const float* __restrict__ sd,
                        float* __restrict__ partials, int W, int bh,
                        int bw) {
    __shared__ float sums[kSyms][kHessThreads];
    const WamiTile t(bh, bw);
    float acc[kSyms];
#pragma unroll
    for (int k = 0; k < kSyms; ++k) acc[k] = 0.0f;
    for (int e = threadIdx.x; e < t.pixels(); e += kHessThreads) {
        const int r = e / bw, c = e - r * bw;
        const float* s = sd + 6 * ((long long)(t.row0 + r) * W + t.col0 + c);
        float v[6];
#pragma unroll
        for (int a = 0; a < 6; ++a) v[a] = s[a];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
            for (int b = a; b < 6; ++b) acc[sym_index(a, b)] += v[a] * v[b];
        }
    }
#pragma unroll
    for (int k = 0; k < kSyms; ++k) sums[k][threadIdx.x] = acc[k];
    __syncthreads();
    for (int half = kHessThreads / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half) {
#pragma unroll
            for (int k = 0; k < kSyms; ++k)
                sums[k][threadIdx.x] += sums[k][threadIdx.x + half];
        }
        __syncthreads();
    }
    if (threadIdx.x < 36) {
        const int a = threadIdx.x / 6, b = threadIdx.x % 6;
        const int blk = blockIdx.x * gridDim.y + blockIdx.y;
        partials[blk * 36 + threadIdx.x] =
            sums[sym_index(min(a, b), max(a, b))][0];
    }
}

__global__ void hessian_reduce_kernel(const float* __restrict__ partials,
                                      float* __restrict__ out, int n) {
    const int k = threadIdx.x;
    if (k < 36) {
        float s = 0.0f;
        for (int blk = 0; blk < n; ++blk) s += partials[blk * 36 + k];
        out[k] = s;
    }
}

}  // namespace

// gx, gy: (H, W) float32 -> sd: (H, W, 6) float32; W % ports == 0 and
// H % unrolls == 0 (checked by the Python wrapper).
WAMI_EXPORT int wami_steepest_descent(const float* gx, const float* gy,
                                      float* sd, int H, int W, int ports,
                                      int unrolls, void* stream) {
    const int bh = unrolls, bw = W / ports;
    const dim3 grid(H / unrolls, ports);
    steepest_descent_kernel<<<grid, wami_threads(bh * bw), 0,
                              static_cast<cudaStream_t>(stream)>>>(
        gx, gy, sd, W, bh, bw);
    return static_cast<int>(cudaGetLastError());
}

// sd: (H, W, 6) float32 -> out: (6, 6) float32, through partials:
// ((H / unrolls) * ports, 36) float32 scratch the wrapper allocates.
WAMI_EXPORT int wami_hessian(const float* sd, float* partials, float* out,
                             int H, int W, int ports, int unrolls,
                             void* stream) {
    const int bh = unrolls, bw = W / ports;
    const dim3 grid(H / unrolls, ports);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    hessian_partials_kernel<<<grid, kHessThreads, 0, s>>>(sd, partials, W,
                                                          bh, bw);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    hessian_reduce_kernel<<<1, 64, 0, s>>>(partials, out,
                                           static_cast<int>(grid.x * grid.y));
    return static_cast<int>(cudaGetLastError());
}
