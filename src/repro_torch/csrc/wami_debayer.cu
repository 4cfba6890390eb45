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
#include "wami_common.cuh"

namespace {

// reflect padding by one pixel: -1 -> 1, n -> n - 2
__device__ __forceinline__ int reflect(int i, int n) {
    return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__global__ void debayer_kernel(const float* __restrict__ bayer,
                               float* __restrict__ rgb, int H, int W,
                               int bh, int bw) {
    const WamiTile t(bh, bw);
    for (int e = threadIdx.x; e < t.pixels(); e += blockDim.x) {
        const int r = e / bw, c = e - r * bw;
        const int y = t.row0 + r, x = t.col0 + c;
        const float* up = bayer + (long long)reflect(y - 1, H) * W;
        const float* mid = bayer + (long long)y * W;
        const float* dn = bayer + (long long)reflect(y + 1, H) * W;
        const int xl = reflect(x - 1, W), xr = reflect(x + 1, W);
        const float ctr = __ldg(mid + x);
        const float n = __ldg(up + x), s = __ldg(dn + x);
        const float w = __ldg(mid + xl), e_ = __ldg(mid + xr);
        const float nw = __ldg(up + xl), ne = __ldg(up + xr);
        const float sw = __ldg(dn + xl), se = __ldg(dn + xr);
        const float cross = (((n + s) + w) + e_) * 0.25f;
        const float diag = (((nw + ne) + sw) + se) * 0.25f;
        const float horiz = (w + e_) * 0.5f;
        const float vert = (n + s) * 0.5f;
        const bool even_y = (y & 1) == 0, even_x = (x & 1) == 0;
        float red, green, blue;
        if (even_y && even_x) {             // R site
            red = ctr; green = cross; blue = diag;
        } else if (even_y) {                // G site on an R row
            red = horiz; green = ctr; blue = vert;
        } else if (even_x) {                // G site on a B row
            red = vert; green = ctr; blue = horiz;
        } else {                            // B site
            red = diag; green = cross; blue = ctr;
        }
        float* o = rgb + 3 * ((long long)y * W + x);
        o[0] = red;
        o[1] = green;
        o[2] = blue;
    }
}

}  // namespace

// bayer: (H, W) float32, H >= 2 and W >= 2; rgb: (H, W, 3) float32;
// W % ports == 0 and H % unrolls == 0 (checked by the Python wrapper).
WAMI_EXPORT int wami_debayer(const float* bayer, float* rgb, int H, int W,
                             int ports, int unrolls, void* stream) {
    const int bh = unrolls, bw = W / ports;
    const dim3 grid(H / unrolls, ports);
    debayer_kernel<<<grid, wami_threads(bh * bw), 0,
                     static_cast<cudaStream_t>(stream)>>>(bayer, rgb, H, W,
                                                          bh, bw);
    return static_cast<int>(cudaGetLastError());
}
