// WAMI grayscale, y = 0.299 R + 0.587 G + 0.114 B, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/wami_grayscale/kernel.py
// (grayscale_kernel), which reads the R, G and B planes that XLA splits out
// of the (H, W, 3) frame before the call.
//
// Bound on an H100 SXM (published peaks, 700 W limit): bytes.  Per pixel it
// reads 12 B and writes 4 B for 5 flops, so at 3.35 TB/s the tile-128 frame
// (262,144 B) needs 0.08 us and the 512 x 512 frame 1.25 us, both below the
// few microseconds a launch costs: at the PLM tile the wall is launch
// latency, whatever the knobs.  The design moves each byte once: it reads
// the interleaved (H, W, 3) input directly, with no split into planes.
//
// What limits it at the knobs' tiles is the chain of round trips to
// memory, one per pass of a thread over its tile.  So a thread owns a run
// of 4 adjacent pixels of a row: their RGB is 48 contiguous bytes, on the
// 16-byte grid (the run's first pixel index is a multiple of 4), read as
// three 16-byte loads before any arithmetic, and their luma one 16-byte
// store.  A CTA takes up to 1,024 threads (run4_threads), so every Table-1
// tile of the 128 x 128 frame is one pass and of the 512 x 512 frame at
// most four.  The bodies (Run4Body, wami_common.cuh): tiles of at most
// kScalarPixels pixels, where runs would leave 32-64 threads, take one
// pixel a thread; a row's pixels before its first aligned run and after
// its last whole run, and every pixel when W % 4 != 0 or a pointer is
// off the 16-byte grid, take the scalar path; where every tile is whole
// runs a body without that path runs.  The three loads of a run stride
// 48 bytes across the warp, but they fall in the same 128-byte lines,
// which the L1 serves: on an H100, loading a warp's 1,536 bytes in warp
// order through shared memory (kStaged) measured 0.08-0.33 us slower a
// launch from 1,024 pixels a tile (512 x 512 at (1, 8): 3.34 against
// 3.01 us), so it is not used here.  The arithmetic is the plain
// version's, in its order and rounded at each step (no contraction into
// an FMA), so the result is the same bits.
#include <cstdint>

#include "wami_common.cuh"

namespace {

constexpr int kScalarPixels = 256;  // tiles up to this: one pixel a thread

// luma as grayscale_ref computes it: float32 products by the float32
// constants, summed left to right
__device__ __forceinline__ float luma(float r, float g, float b) {
    return __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                     __fmul_rn(0.114f, b));
}

template <int BODY>
__global__ void __launch_bounds__(1024)
grayscale_kernel(const float* __restrict__ rgb, float* __restrict__ y,
                 int W, int bh, int bw, int vec) {
    const WamiTile t(bh, bw);
    const RowSplit rs = body_split<BODY>(t, vec != 0);
    const int n_runs = bh * rs.runs;
    const int items = BODY == kRuns ? n_runs
                                    : n_runs + bh * (rs.head + rs.tail);
    for (int e = threadIdx.x; e < items; e += blockDim.x) {
        int r, c;
        const bool run = run4_item<BODY>(e, rs, n_runs, r, c);
        const long long p = (long long)(t.row0 + r) * W + t.col0 + c;
        if (run) {
            float px[12];
            ld4(px, rgb + 3 * p);
            ld4(px + 4, rgb + 3 * p + 4);
            ld4(px + 8, rgb + 3 * p + 8);
            float o[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                o[i] = luma(px[3 * i], px[3 * i + 1], px[3 * i + 2]);
            st4(y + p, o);
        } else {
            const float* s = rgb + 3 * p;
            y[p] = luma(__ldg(s), __ldg(s + 1), __ldg(s + 2));
        }
    }
}

}  // namespace

// rgb: (H, W, 3) float32, y: (H, W) float32; W % ports == 0 and
// H % unrolls == 0 (checked by the Python wrapper).  Threads per CTA: one
// a pixel up to kScalarPixels pixels a tile, else run4_threads
// (wami_common.cuh) -- kernels/wami_grayscale/kernel.py's
// grayscale_geometry is the same formula.
WAMI_EXPORT int wami_grayscale(const float* rgb, float* y, int H, int W,
                               int ports, int unrolls, void* stream) {
    const int bh = unrolls, bw = W / ports;
    const bool vec = W % 4 == 0
                     && ((reinterpret_cast<uintptr_t>(rgb)
                          | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
    const dim3 grid(H / unrolls, ports);
    const int threads = run4_threads(ports, bh, bw, vec);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (run4_body(bh, bw, vec, kScalarPixels, kNoStaging)) {
        case kScalar:
            grayscale_kernel<kScalar><<<grid, wami_threads(bh * bw), 0, s>>>(
                rgb, y, W, bh, bw, 0);
            break;
        case kRuns:
            grayscale_kernel<kRuns><<<grid, threads, 0, s>>>(rgb, y, W, bh,
                                                             bw, 1);
            break;
        default:
            grayscale_kernel<kMixed><<<grid, threads, 0, s>>>(
                rgb, y, W, bh, bw, vec ? 1 : 0);
            break;
    }
    return static_cast<int>(cudaGetLastError());
}
