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
// The design fuses the gather: each thread computes its pixels' source
// addresses, clamps each cell to [0, W-2] x [0, H-2], and loads the four
// neighbours through the read-only cache, so none of the six planes is
// written to device memory.  p stays in device memory (no copy to the
// host, so the wrapper never waits for the card).
//
// What limits it at the knobs' tiles is the chain of dependent trips to
// memory: p, then the gathers, then the store, in every pass a thread
// makes over its tile.  So every tile takes one pass where it can: a
// tile of at most kScalarPixels (1,024) pixels takes one pixel a thread
// and a thread a pixel, up to 1,024 threads a CTA (four gathers, one
// store); a larger tile gives a thread a run of 4 adjacent output pixels
// of a row: it computes the four source cells first, then issues all 16
// gathers (16 independent loads in flight), then blends, and writes the
// run as one 16-byte store, so every Table-1 tile of the 128 x 128 frame
// is one pass.  On an H100 (700 W) runs measured 0.3-0.7 us slower than
// a thread a pixel at 128-1,024-pixel DSE tiles, where a run's longer
// per-thread chain outweighs its 16 loads in flight, and 0.17 us faster
// at 2,048 pixels, where a thread a pixel takes two passes.  At the DSE's
// near-identity p the four taps of a pixel, and a run's, fall in the
// same one or two 128-byte lines, which the L1 serves, so the taps are
// not staged through shared memory (grayscale's loads measured faster
// direct).  The bodies (Run4Body, wami_common.cuh): kScalar as above; a
// row's pixels before its first aligned run and after its last whole
// run, and every pixel when W % 4 != 0 or the output is off the 16-byte
// grid, take the scalar path; where every tile is whole runs a body
// without that path runs.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, in
// the plain version's order): nvcc would otherwise contract a * b + c
// into one FMA, and a differently rounded source coordinate can flip the
// floor() cell.  So the result is the plain version's bits.
#include <cstdint>

#include "wami_common.cuh"

namespace {

// tiles up to this: one pixel a thread, up to 1,024 threads a CTA
constexpr int kScalarPixels = 1024;

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
    // a * (1 - f) + b * f, each operation rounded on its own
    return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

// The affine map of p and the frame's clamp limits (load_affine)
struct Affine {
    float a, b, tx, c, d, ty, xmax, ymax;

    // output pixel (x, y) -> offset of its source cell's top-left tap,
    // and the cell's two fractions, as the plain version rounds them
    __device__ __forceinline__ long long cell(int x, int y, int W,
                                              float& fx, float& fy) const {
        const float xf = static_cast<float>(x), yf = static_cast<float>(y);
        const float sx = __fadd_rn(__fadd_rn(__fmul_rn(a, xf),
                                             __fmul_rn(b, yf)), tx);
        const float sy = __fadd_rn(__fadd_rn(__fmul_rn(c, xf),
                                             __fmul_rn(d, yf)), ty);
        const float x0 = fminf(fmaxf(floorf(sx), 0.0f), xmax);
        const float y0 = fminf(fmaxf(floorf(sy), 0.0f), ymax);
        fx = fminf(fmaxf(__fsub_rn(sx, x0), 0.0f), 1.0f);
        fy = fminf(fmaxf(__fsub_rn(sy, y0), 0.0f), 1.0f);
        return (long long)static_cast<int>(y0) * W + static_cast<int>(x0);
    }
};

__device__ __forceinline__ Affine load_affine(const float* __restrict__ p,
                                             int H, int W) {
    Affine m;
    m.a = __fadd_rn(1.0f, __ldg(p + 0));
    m.b = __ldg(p + 1);
    m.tx = __ldg(p + 2);
    m.c = __ldg(p + 3);
    m.d = __fadd_rn(1.0f, __ldg(p + 4));
    m.ty = __ldg(p + 5);
    m.xmax = static_cast<float>(W - 2);
    m.ymax = static_cast<float>(H - 2);
    return m;
}

// the blend of a cell's taps i00, i01, i10, i11
__device__ __forceinline__ float blend(const float* v, float fx, float fy) {
    return lerp_rn(lerp_rn(v[0], v[1], fx), lerp_rn(v[2], v[3], fx), fy);
}

template <int BODY>
__global__ void __launch_bounds__(1024)
warp_kernel(const float* __restrict__ img, const float* __restrict__ p,
            float* __restrict__ out, int H, int W, int bh, int bw,
            int vec) {
    const WamiTile t(bh, bw);
    const Affine m = load_affine(p, H, W);
    const RowSplit rs = body_split<BODY>(t, vec != 0);
    const int n_runs = bh * rs.runs;
    const int items = BODY == kRuns ? n_runs
                                    : n_runs + bh * (rs.head + rs.tail);
    for (int e = threadIdx.x; e < items; e += blockDim.x) {
        int r, c;
        const bool run = run4_item<BODY>(e, rs, n_runs, r, c);
        const int y = t.row0 + r, x = t.col0 + c;
        const long long o = (long long)y * W + x;
        if (run) {
            long long cell[4];
            float fx[4], fy[4], v[16];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                cell[i] = m.cell(x + i, y, W, fx[i], fy[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float* s = img + cell[i];
                v[4 * i] = __ldg(s);
                v[4 * i + 1] = __ldg(s + 1);
                v[4 * i + 2] = __ldg(s + W);
                v[4 * i + 3] = __ldg(s + W + 1);
            }
            float res[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                res[i] = blend(v + 4 * i, fx[i], fy[i]);
            st4(out + o, res);
        } else {
            float fx, fy, v[4];
            const float* s = img + m.cell(x, y, W, fx, fy);
            v[0] = __ldg(s);
            v[1] = __ldg(s + 1);
            v[2] = __ldg(s + W);
            v[3] = __ldg(s + W + 1);
            out[o] = blend(v, fx, fy);
        }
    }
}

}  // namespace

// img: (H, W) float32, H >= 2 and W >= 2; p: (6,) float32 on the card;
// out: (H, W) float32; W % ports == 0 and H % unrolls == 0 (checked by
// the Python wrapper).  Threads per CTA: one a pixel up to kScalarPixels
// pixels a tile, else run4_threads (wami_common.cuh) --
// kernels/wami_warp/kernel.py's warp_geometry is the same formula.
WAMI_EXPORT int wami_warp(const float* img, const float* p, float* out,
                          int H, int W, int ports, int unrolls,
                          void* stream) {
    const int bh = unrolls, bw = W / ports;
    // the gathers take any address; only the runs' stores need the grid
    const bool vec = W % 4 == 0
                     && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    const dim3 grid(H / unrolls, ports);
    const int threads = run4_threads(ports, bh, bw, vec);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (run4_body(bh, bw, vec, kScalarPixels, kNoStaging)) {
        case kScalar:
            warp_kernel<kScalar><<<grid, wami_threads(bh * bw, 1024), 0,
                                   s>>>(img, p, out, H, W, bh, bw, 0);
            break;
        case kRuns:
            warp_kernel<kRuns><<<grid, threads, 0, s>>>(img, p, out, H, W,
                                                        bh, bw, 1);
            break;
        default:
            warp_kernel<kMixed><<<grid, threads, 0, s>>>(
                img, p, out, H, W, bh, bw, vec ? 1 : 0);
            break;
    }
    return static_cast<int>(cudaGetLastError());
}
