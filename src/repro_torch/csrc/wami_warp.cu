// WAMI affine warp with bilinear resampling, for Hopper (sm_90a):
// x' = (1 + p1) x + p2 y + p3, y' = p4 x + (1 + p5) y + p6, the source
// cell clamped into the frame, then a 4-neighbour bilinear blend.
//
// Replaces the Pallas kernel src/repro/kernels/wami_warp/kernel.py
// (warp_blend_kernel), which only blends six (H, W) planes -- four
// gathered neighbours and the two fractions -- that XLA computes and
// gathers before the call (warp_gather).
//
// Bound on an H100 SXM (published peaks, 700 W limit): bytes.  Per pixel
// it must read 4 B and write 4 B for about 20 flops, so at 3.35 TB/s the
// tile-128 frame (131,072 B) needs 0.04 us and the 512 x 512 frame
// 0.63 us, below a launch: at the PLM tile the wall is launch latency.
// The design fuses the gather: each thread computes its pixel's source
// address, clamps the cell to [0, W-2] x [0, H-2], and loads the four
// neighbours through the read-only cache, so none of the six planes is
// written to device memory.  p stays in device memory (no copy to the
// host, so the wrapper never waits for the card).  Every product and sum
// is rounded on its own (__fmul_rn / __fadd_rn, in the plain version's
// order): nvcc would otherwise contract a * b + c into one FMA, and a
// differently rounded source coordinate can flip the floor() cell.
#include "wami_common.cuh"

namespace {

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
    // a * (1 - f) + b * f, each operation rounded on its own
    return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

__global__ void warp_kernel(const float* __restrict__ img,
                            const float* __restrict__ p,
                            float* __restrict__ out, int H, int W, int bh,
                            int bw) {
    const WamiTile t(bh, bw);
    const float a = __fadd_rn(1.0f, __ldg(p + 0)), b = __ldg(p + 1);
    const float tx = __ldg(p + 2), c = __ldg(p + 3);
    const float d = __fadd_rn(1.0f, __ldg(p + 4)), ty = __ldg(p + 5);
    const float xmax = static_cast<float>(W - 2);
    const float ymax = static_cast<float>(H - 2);
    for (int e = threadIdx.x; e < t.pixels(); e += blockDim.x) {
        const int r = e / bw, cc = e - r * bw;
        const int y = t.row0 + r, x = t.col0 + cc;
        const float xf = static_cast<float>(x), yf = static_cast<float>(y);
        const float sx = __fadd_rn(__fadd_rn(__fmul_rn(a, xf),
                                             __fmul_rn(b, yf)), tx);
        const float sy = __fadd_rn(__fadd_rn(__fmul_rn(c, xf),
                                             __fmul_rn(d, yf)), ty);
        const float x0 = fminf(fmaxf(floorf(sx), 0.0f), xmax);
        const float y0 = fminf(fmaxf(floorf(sy), 0.0f), ymax);
        const float fx = fminf(fmaxf(__fsub_rn(sx, x0), 0.0f), 1.0f);
        const float fy = fminf(fmaxf(__fsub_rn(sy, y0), 0.0f), 1.0f);
        const float* row = img + (long long)static_cast<int>(y0) * W
                           + static_cast<int>(x0);
        const float top = lerp_rn(__ldg(row), __ldg(row + 1), fx);
        const float bot = lerp_rn(__ldg(row + W), __ldg(row + W + 1), fx);
        out[(long long)y * W + x] = lerp_rn(top, bot, fy);
    }
}

}  // namespace

// img: (H, W) float32, H >= 2 and W >= 2; p: (6,) float32 on the card;
// out: (H, W) float32; W % ports == 0 and H % unrolls == 0 (checked by
// the Python wrapper).
WAMI_EXPORT int wami_warp(const float* img, const float* p, float* out,
                          int H, int W, int ports, int unrolls,
                          void* stream) {
    const int bh = unrolls, bw = W / ports;
    const dim3 grid(H / unrolls, ports);
    warp_kernel<<<grid, wami_threads(bh * bw), 0,
                  static_cast<cudaStream_t>(stream)>>>(img, p, out, H, W,
                                                       bh, bw);
    return static_cast<int>(cudaGetLastError());
}
