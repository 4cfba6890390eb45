// Shared launch geometry of the COSMOS-knob WAMI kernels (sm_90a).
//
// The two knobs are the launch grid: grid (H / unrolls, ports), and CTA
// (i, j) covers rows [i * unrolls, (i + 1) * unrolls) of column bank j,
// which is W / ports columns wide.  Threads of a CTA stride over its tile
// in row-major order, so neighbouring threads touch neighbouring pixels.
// Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError().
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
