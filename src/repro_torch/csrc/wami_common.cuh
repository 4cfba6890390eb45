// Shared launch geometry of the COSMOS-knob WAMI kernels (sm_90a).
//
// The two knobs are the launch grid: grid (H / unrolls, ports), and CTA
// (i, j) covers rows [i * unrolls, (i + 1) * unrolls) of column bank j,
// which is W / ports columns wide.  Threads of a CTA stride over its tile
// in row-major order, so neighbouring threads touch neighbouring pixels:
// one pixel a thread, at most 256 threads a CTA (wami_threads), or one
// run of 4 adjacent pixels a thread, at most 1,024 (RowSplit,
// run4_threads).  Every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().
#pragma once

#include "kernel_export.cuh"

#define WAMI_EXPORT KERNEL_EXPORT

// threads of an elementwise CTA: the tile's pixel count rounded up to a
// whole warp, at most 256
static inline int wami_threads(int pixels) {
    const int warps = (pixels + 31) / 32;
    return warps >= 8 ? 256 : 32 * warps;
}

// CTA (blockIdx.x, blockIdx.y)'s tile: its first row and column
struct WamiTile {
    int row0, col0, bh, bw;
    __device__ WamiTile(int bh_, int bw_)
        : row0(blockIdx.x * bh_), col0(blockIdx.y * bw_), bh(bh_), bw(bw_) {}
    __device__ int pixels() const { return bh * bw; }
};

// A tile row's pixels for a thread per run of 4: `head` scalar ones up
// to the first 16-byte-aligned run (the tile's first column not a
// multiple of 4), `runs` runs of 4, then `tail` scalar ones (bw % 4 !=
// 0).  Every pixel is scalar when !vec (W % 4 != 0, or a pointer off the
// 16-byte grid).  Work items of a CTA: bh * runs runs first, then
// bh * (head + tail) scalar pixels.
struct RowSplit {
    int head, runs, tail;
};

__host__ __device__ __forceinline__ RowSplit row_split(int col0, int bw,
                                                       bool vec) {
    if (!vec) return {bw, 0, 0};
    const int lead = (4 - col0 % 4) % 4;
    const int head = lead < bw ? lead : bw;
    const int runs = (bw - head) / 4;
    return {head, runs, bw - head - 4 * runs};
}

// threads of a run-of-4 CTA: the most work items any tile of the launch
// has (a tile's first column j * bw takes at most four values mod 4),
// rounded up to a whole warp, at most 1,024 -- the formula of
// run4_geometry in kernels/wami_common.py
static inline int run4_threads(int ports, int bh, int bw, bool vec) {
    int items = 0;
    for (int j = 0; j < ports && j < 4; ++j) {
        const RowSplit rs = row_split(j * bw, bw, vec);
        const int n = bh * (rs.runs + rs.head + rs.tail);
        if (n > items) items = n;
    }
    const int warps = (items + 31) / 32;
    return warps < 32 ? 32 * warps : 1024;
}

__device__ __forceinline__ void ld4(float* d, const float* s) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(s));
    d[0] = t.x;
    d[1] = t.y;
    d[2] = t.z;
    d[3] = t.w;
}

__device__ __forceinline__ void st4(float* d, const float* s) {
    *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
}
