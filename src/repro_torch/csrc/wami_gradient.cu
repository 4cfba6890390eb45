// WAMI central-difference gradient for Hopper (sm_90a):
// gx = (right - left) / 2, gy = (down - up) / 2 on an edge-padded frame.
//
// Replaces the Pallas kernel src/repro/kernels/wami_gradient/kernel.py
// (gradient_kernel), whose wrapper pads the frame and builds the four
// shifted views with XLA before the call.
//
// Bound on an H100 SXM (published peaks, 700 W limit): bytes.  Per
// pixel it must read 4 B and write 8 B for 4 flops, so at 3.35 TB/s the
// tile-128 frame (196,608 B) needs 0.06 us and the 512 x 512 frame
// 0.94 us, below a launch: at the PLM
// tile the wall is launch latency.  The design reads the unpadded frame
// once: edge padding is a clamp of the neighbour index, and the halo
// rows and columns of a tile are served by the L1/L2 caches, so no pad
// and no shifted view is ever written to device memory.
#include "wami_common.cuh"

__global__ void gradient_kernel(const float* __restrict__ g,
                                float* __restrict__ gx,
                                float* __restrict__ gy, int H, int W,
                                int bh, int bw) {
    const WamiTile t(bh, bw);
    for (int e = threadIdx.x; e < t.pixels(); e += blockDim.x) {
        const int r = e / bw, c = e - r * bw;
        const int y = t.row0 + r, x = t.col0 + c;
        const long long p = (long long)y * W + x;
        const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
        const int yu = max(y - 1, 0), yd = min(y + 1, H - 1);
        const float* row = g + (long long)y * W;
        gx[p] = (row[xr] - row[xl]) * 0.5f;
        gy[p] = (g[(long long)yd * W + x] - g[(long long)yu * W + x]) * 0.5f;
    }
}

// g: (H, W) float32; gx, gy: (H, W) float32; W % ports == 0 and
// H % unrolls == 0 (checked by the Python wrapper).
WAMI_EXPORT int wami_gradient(const float* g, float* gx, float* gy, int H,
                              int W, int ports, int unrolls, void* stream) {
    const int bh = unrolls, bw = W / ports;
    const dim3 grid(H / unrolls, ports);
    gradient_kernel<<<grid, wami_threads(bh * bw), 0,
                      static_cast<cudaStream_t>(stream)>>>(g, gx, gy, H, W,
                                                           bh, bw);
    return static_cast<int>(cudaGetLastError());
}
