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
// 0.94 us, below a launch: at the PLM tile the wall is launch latency.
// The design reads the unpadded frame once: edge padding is a clamp of
// the neighbour index, and the halo rows and columns of a tile are
// served by the L1/L2 caches, so no pad and no shifted view is ever
// written to device memory.
//
// What limits it at the knobs' tiles is the chain of round trips to
// memory, one per pass of a thread over its tile.  So a thread owns a run
// of 4 adjacent pixels of a row: it loads the run's centre, upper and
// lower rows as three 16-byte vectors and the centre row's left and
// right neighbour with one scalar load at each end (they lie in the
// adjacent runs' vectors, which the L1 serves), all five loads before
// any arithmetic, and writes gx and gy as one 16-byte store each.  A CTA
// takes up to 1,024 threads (run4_threads), so every Table-1 tile of the
// 128 x 128 frame is one pass and of the 512 x 512 frame at most four.
// A row's pixels before its first aligned run and after its last whole
// run, and every pixel when W % 4 != 0 or a pointer is off the 16-byte
// grid, take the scalar path, one pixel a thread; where every tile is
// whole runs (the knobs' tiles of the 128 and 512 frames), a second
// instantiation has no scalar path (on an H100 the shorter kernel
// measured 0.1-0.2 us faster a launch at the smallest tiles).  Each pixel's arithmetic
// is the plain version's: a difference, then a halving.
#include <cstdint>

#include "wami_common.cuh"

namespace {

// ALIGNED: every tile row is whole runs (vec and bw % 4 == 0), so the
// scalar path is compiled out
template <bool ALIGNED>
__global__ void __launch_bounds__(1024)
gradient_kernel(const float* __restrict__ g, float* __restrict__ gx,
                float* __restrict__ gy, int H, int W, int bh, int bw,
                int vec) {
    const WamiTile t(bh, bw);
    const RowSplit rs = ALIGNED ? RowSplit{0, bw / 4, 0}
                                : row_split(t.col0, bw, vec != 0);
    const int n_runs = bh * rs.runs, n_scalar = rs.head + rs.tail;
    const int items = ALIGNED ? n_runs : n_runs + bh * n_scalar;
    for (int e = threadIdx.x; e < items; e += blockDim.x) {
        int r, c;
        if (ALIGNED || e < n_runs) {
            r = e / rs.runs;
            c = rs.head + 4 * (e - r * rs.runs);
        } else {
            const int s = e - n_runs;
            r = s / n_scalar;
            const int k = s - r * n_scalar;
            c = k < rs.head ? k : k + 4 * rs.runs;
        }
        const int y = t.row0 + r, x = t.col0 + c;
        const long long p = (long long)y * W + x;
        const float* row = g + (long long)y * W;
        const float* up = g + (long long)max(y - 1, 0) * W;
        const float* dn = g + (long long)min(y + 1, H - 1) * W;
        if (ALIGNED || e < n_runs) {
            // the centre row at columns x - 1 .. x + 4, clamped
            float ctr[6], u[4], d[4];
            ld4(ctr + 1, row + x);
            ld4(u, up + x);
            ld4(d, dn + x);
            ctr[0] = __ldg(row + max(x - 1, 0));
            ctr[5] = __ldg(row + min(x + 4, W - 1));
            float ox[4], oy[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                ox[i] = (ctr[i + 2] - ctr[i]) * 0.5f;
                oy[i] = (d[i] - u[i]) * 0.5f;
            }
            st4(gx + p, ox);
            st4(gy + p, oy);
        } else {
            const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
            gx[p] = (row[xr] - row[xl]) * 0.5f;
            gy[p] = (dn[x] - up[x]) * 0.5f;
        }
    }
}

}  // namespace

// g: (H, W) float32; gx, gy: (H, W) float32; W % ports == 0 and
// H % unrolls == 0 (checked by the Python wrapper).  Threads per CTA:
// run4_threads (wami_common.cuh).
WAMI_EXPORT int wami_gradient(const float* g, float* gx, float* gy, int H,
                              int W, int ports, int unrolls, void* stream) {
    const int bh = unrolls, bw = W / ports;
    const bool vec = W % 4 == 0
                     && ((reinterpret_cast<uintptr_t>(g)
                          | reinterpret_cast<uintptr_t>(gx)
                          | reinterpret_cast<uintptr_t>(gy)) & 15) == 0;
    const dim3 grid(H / unrolls, ports);
    const int threads = run4_threads(ports, bh, bw, vec);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec && bw % 4 == 0)
        gradient_kernel<true><<<grid, threads, 0, s>>>(g, gx, gy, H, W, bh,
                                                       bw, 1);
    else
        gradient_kernel<false><<<grid, threads, 0, s>>>(g, gx, gy, H, W, bh,
                                                        bw, vec ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}
