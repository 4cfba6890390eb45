// WAMI debayer, a bilinear RGGB demosaic, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/wami_debayer/kernel.py
// (debayer_kernel), whose wrapper writes a reflect-padded copy of the
// mosaic and nine shifted views of it with XLA before the call, and
// stacks the three output planes after it.
//
// Bound on an H100 SXM (published peaks, 700 W limit): bytes.  Per pixel
// it must read 4 B and write 12 B for at most 8 flops, so at 3.35 TB/s
// the tile-128 frame (262,144 B) needs 0.08 us and the 512 x 512 frame
// 1.25 us, below a launch: at the PLM tile the wall is launch latency.
// The design reads the unpadded mosaic once: reflect padding is an index
// map (-1 -> 1, n -> n - 2; not the clamp of the gradient), the 3 x 3
// neighbourhood comes from the L1/L2 caches, and a pixel's R, G, B are
// one 12-byte run of the (H, W, 3) output, so no pad, no view and no
// plane is ever written to device memory.  The RGGB parity comes from the
// global coordinates, so a tile that does not align to the 2 x 2 quad
// (an odd unroll count) is still right.  The sums keep the plain
// version's order and contain no product to contract.
//
// What limits it at the knobs' tiles is the chain of round trips to
// memory, one per pass of a thread over its tile.  So a thread owns a run
// of 4 adjacent pixels of a row: it loads the run's upper, centre and
// lower rows as three 16-byte vectors and each row's left and right
// neighbour with one scalar load at each end (six; the neighbours lie in
// the adjacent runs' vectors, which the L1 serves), all nine loads before
// any arithmetic, and writes the run's (4, 3) RGB as three 16-byte
// stores.  A CTA takes up to 1,024 threads (run4_threads), so every
// Table-1 tile of the 128 x 128 frame is one pass and of the 512 x 512
// frame at most four.  A row's pixels before its first aligned run and
// after its last whole run, and every pixel when W % 4 != 0 or a pointer
// is off the 16-byte grid, take the scalar path, one pixel a thread.
// Three things measured on an H100 shape the launch: where every tile is
// whole runs (the knobs' tiles of the 128 and 512 frames) a body without
// the scalar path runs, 0.1-0.2 us faster a launch at the smallest
// tiles; tiles of at most 256 pixels, where runs of 4 leave 32-64
// threads, run one pixel a thread in a body of its own (runs were
// 0.2-0.3 us slower there, at two ports or more); and from 1,024 pixels
// a tile the warps write their RGB through shared memory in order
// (512-byte stores in place of three 48-byte-strided ones: 512 x 512 at
// (1, 8) measured 5.9 -> 4.2 us).  Below 1,024 pixels the detour through
// shared memory measured slower, and the direct stores stay.
#include <cstdint>

#include "wami_common.cuh"

namespace {

// tiles of at most this many pixels take one pixel a thread
constexpr int kScalarPixels = 256;

// reflect padding by one pixel: -1 -> 1, n -> n - 2
__device__ __forceinline__ int reflect(int i, int n) {
    return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// One pixel at (y, x) from its 3 x 3 neighbourhood: u, m and d are the
// upper, centre and lower rows at columns x - 1, x, x + 1 (padded);
// o gets R, G, B.
__device__ __forceinline__ void debayer_px(int y, int x, const float* u,
                                           const float* m, const float* d,
                                           float* o) {
    const float ctr = m[1];
    const float n = u[1], s = d[1];
    const float w = m[0], e_ = m[2];
    const float nw = u[0], ne = u[2];
    const float sw = d[0], se = d[2];
    const float cross = (((n + s) + w) + e_) * 0.25f;
    const float diag = (((nw + ne) + sw) + se) * 0.25f;
    const float horiz = (w + e_) * 0.5f;
    const float vert = (n + s) * 0.5f;
    const bool even_y = (y & 1) == 0, even_x = (x & 1) == 0;
    if (even_y && even_x) {             // R site
        o[0] = ctr; o[1] = cross; o[2] = diag;
    } else if (even_y) {                // G site on an R row
        o[0] = horiz; o[1] = ctr; o[2] = vert;
    } else if (even_x) {                // G site on a B row
        o[0] = vert; o[1] = ctr; o[2] = horiz;
    } else {                            // B site
        o[0] = diag; o[1] = cross; o[2] = ctr;
    }
}

// The bodies: kScalar, one pixel a thread; kMixed, runs with a scalar
// head and tail (or every pixel scalar when !vec); kRuns, every tile row
// whole runs (vec and bw % 4 == 0), the scalar path compiled out; and
// kStaged, kRuns where a warp whose lanes all take runs writes its 32
// runs' 96 float4 of RGB in order through shared memory (blockDim.x * 48
// bytes), lane l storing float4 l, l + 32 and l + 64: 512 contiguous
// bytes a store where a run's own three stores stride 48 bytes across
// the warp.
enum Body { kScalar, kMixed, kRuns, kStaged };

template <int BODY>
__global__ void __launch_bounds__(1024)
debayer_kernel(const float* __restrict__ bayer, float* __restrict__ rgb,
               int H, int W, int bh, int bw, int vec) {
    constexpr bool ALIGNED = BODY == kRuns || BODY == kStaged;
    constexpr bool SCALAR = BODY == kScalar, STAGE = BODY == kStaged;
    const WamiTile t(bh, bw);
    const RowSplit rs = ALIGNED  ? RowSplit{0, bw / 4, 0}
                        : SCALAR ? RowSplit{bw, 0, 0}
                                 : row_split(t.col0, bw, vec != 0);
    const int n_runs = bh * rs.runs, n_scalar = rs.head + rs.tail;
    const int items = ALIGNED ? n_runs : n_runs + bh * n_scalar;
    extern __shared__ float4 stage4[];
    const int lane = threadIdx.x & 31;
    float* sb = reinterpret_cast<float*>(stage4) + (threadIdx.x - lane) * 12;
    for (int e = threadIdx.x; e < items; e += blockDim.x) {
        int r, c;
        if (!SCALAR && (ALIGNED || e < n_runs)) {
            r = e / rs.runs;
            c = rs.head + 4 * (e - r * rs.runs);
        } else {
            const int s = e - n_runs;
            r = s / n_scalar;
            const int k = s - r * n_scalar;
            c = k < rs.head ? k : k + 4 * rs.runs;
        }
        const int y = t.row0 + r, x = t.col0 + c;
        const float* up = bayer + (long long)reflect(y - 1, H) * W;
        const float* mid = bayer + (long long)y * W;
        const float* dn = bayer + (long long)reflect(y + 1, H) * W;
        if (!SCALAR && (ALIGNED || e < n_runs)) {
            // columns x - 1 .. x + 4 of each row: neighbour, run, neighbour
            const int xl = reflect(x - 1, W), xr = reflect(x + 4, W);
            float u[6], m[6], d[6];
            ld4(u + 1, up + x);
            ld4(m + 1, mid + x);
            ld4(d + 1, dn + x);
            u[0] = __ldg(up + xl);
            m[0] = __ldg(mid + xl);
            d[0] = __ldg(dn + xl);
            u[5] = __ldg(up + xr);
            m[5] = __ldg(mid + xr);
            d[5] = __ldg(dn + xr);
            float o[12];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                debayer_px(y, x + i, u + i, m + i, d + i, o + 3 * i);
            const long long off = 3 * ((long long)y * W + x);
            if (STAGE && e - lane + 32 <= n_runs) {
                st4(sb + 12 * lane, o);
                st4(sb + 12 * lane + 4, o + 4);
                st4(sb + 12 * lane + 8, o + 8);
                __syncwarp();
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    const int f = lane + 32 * k, src = f / 3;
                    const long long at = __shfl_sync(0xffffffffu, off, src);
                    *reinterpret_cast<float4*>(rgb + at + 4 * (f - 3 * src)) =
                        *reinterpret_cast<const float4*>(sb + 4 * f);
                }
                __syncwarp();
            } else {
                st4(rgb + off, o);
                st4(rgb + off + 4, o + 4);
                st4(rgb + off + 8, o + 8);
            }
        } else {
            const int xl = reflect(x - 1, W), xr = reflect(x + 1, W);
            const float u[3] = {__ldg(up + xl), __ldg(up + x), __ldg(up + xr)};
            const float m[3] = {__ldg(mid + xl), __ldg(mid + x),
                                __ldg(mid + xr)};
            const float d[3] = {__ldg(dn + xl), __ldg(dn + x), __ldg(dn + xr)};
            debayer_px(y, x, u, m, d, rgb + 3 * ((long long)y * W + x));
        }
    }
}

}  // namespace

// bayer: (H, W) float32, H >= 2 and W >= 2; rgb: (H, W, 3) float32;
// W % ports == 0 and H % unrolls == 0 (checked by the Python wrapper).
// Threads per CTA: one a pixel up to kScalarPixels pixels a tile, else
// run4_threads (wami_common.cuh) -- kernels/wami_debayer/kernel.py's
// debayer_geometry is the same formula.
WAMI_EXPORT int wami_debayer(const float* bayer, float* rgb, int H, int W,
                             int ports, int unrolls, void* stream) {
    const int bh = unrolls, bw = W / ports;
    const bool vec = W % 4 == 0
                     && ((reinterpret_cast<uintptr_t>(bayer)
                          | reinterpret_cast<uintptr_t>(rgb)) & 15) == 0;
    const dim3 grid(H / unrolls, ports);
    const int threads = run4_threads(ports, bh, bw, vec);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bh * bw <= kScalarPixels)
        debayer_kernel<kScalar><<<grid, wami_threads(bh * bw), 0, s>>>(
            bayer, rgb, H, W, bh, bw, 0);
    else if (vec && bw % 4 == 0 && bh * bw >= 1024)
        debayer_kernel<kStaged><<<grid, threads, threads * 48, s>>>(
            bayer, rgb, H, W, bh, bw, 1);
    else if (vec && bw % 4 == 0)
        debayer_kernel<kRuns><<<grid, threads, 0, s>>>(bayer, rgb, H, W, bh,
                                                       bw, 1);
    else
        debayer_kernel<kMixed><<<grid, threads, 0, s>>>(
            bayer, rgb, H, W, bh, bw, vec ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}
