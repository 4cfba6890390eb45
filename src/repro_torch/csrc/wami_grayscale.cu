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
// the interleaved (H, W, 3) input directly (a pixel's three floats are one
// 12-byte run, and a warp's 32 pixels one 384-byte run), with no split into
// planes and no staging through shared memory.
#include "wami_common.cuh"

__global__ void grayscale_kernel(const float* __restrict__ rgb,
                                 float* __restrict__ y, int W, int bh,
                                 int bw) {
    const WamiTile t(bh, bw);
    for (int e = threadIdx.x; e < t.pixels(); e += blockDim.x) {
        const int r = e / bw, c = e - r * bw;
        const long long p = (long long)(t.row0 + r) * W + t.col0 + c;
        const float* px = rgb + 3 * p;
        y[p] = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
    }
}

// rgb: (H, W, 3) float32, y: (H, W) float32; W % ports == 0 and
// H % unrolls == 0 (checked by the Python wrapper).
WAMI_EXPORT int wami_grayscale(const float* rgb, float* y, int H, int W,
                               int ports, int unrolls, void* stream) {
    const int bh = unrolls, bw = W / ports;
    const dim3 grid(H / unrolls, ports);
    grayscale_kernel<<<grid, wami_threads(bh * bw), 0,
                       static_cast<cudaStream_t>(stream)>>>(rgb, y, W, bh,
                                                            bw);
    return static_cast<int>(cudaGetLastError());
}
