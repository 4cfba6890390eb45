// WAMI change detection for Hopper (sm_90a): a per-pixel Gaussian
// mixture (K = 3) background model.  A component matches when
// (x - mu)^2 / max(var, 1e-4) < 6.25; the best match (first index among
// ties) moves towards x at rate 0.05; with no match the weakest
// component (first index among ties) is replaced by one at x with
// variance 25 and weight 0.05; the weights are renormalized, and the
// pixel is foreground when nothing matched or the matched weight is
// below 1 - 0.7.
//
// Replaces the Pallas kernel src/repro/kernels/wami_change_det/kernel.py
// (change_detection_kernel), whose wrapper transposes the three state
// tensors (H, W, K) -> (K, H, W) with XLA before the call and back after
// it.
//
// Bound on an H100 SXM (published peaks, 700 W limit): bytes.  Per pixel
// it must read 40 B (x and three K = 3 state tensors) and write 37 B (a
// 1-byte mask and three state tensors) for about 50 flops, so at
// 3.35 TB/s the tile-128 frame (1,261,568 B) needs 0.38 us and the
// 512 x 512 frame 6.0 us.  The design reads and writes the (H, W, 3)
// layout in place of the transposes: a pixel's mu, var and w are one
// 12-byte run each, so every state byte moves once.
//
// What limits it is the chain of dependent round trips to memory, one
// per pass of a thread over its tile, not the bytes.  So a thread owns a
// run of 4 adjacent pixels of a row and starts all ten of its loads --
// x as one float4, and mu, var and w as three float4 each (4 pixels x 3
// components = 48 bytes, 16-byte aligned when the run's first pixel
// index is a multiple of 4) -- before any arithmetic; it stores the
// state the same way and the 4 mask bytes as one 4-byte store.  A CTA
// takes up to 1,024 threads (its own count, not wami_threads), so every
// Table-1 tile of the 128 x 128 frame is one pass and of the 512 x 512
// frame at most two.  A row's pixels before its first aligned run (the
// tile's first column not a multiple of 4) and after its last whole run
// (bw % 4 != 0), and every pixel when W % 4 != 0 or a pointer is not
// 16-byte aligned, take the scalar path, one pixel a thread.
//
// The argmins over K are unrolled by hand with the plain version's
// first-index tie-break.  The match and the mask are discrete choices and
// must equal the plain version's bit for bit, so every operation is
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, IEEE __fdiv_rn: no
// contraction into FMA, no approximate division), in the plain version's
// order, with the factors 0/1 of its one-hots kept as multiplications.
// The rate and thresholds are the plain version's defaults, compiled in.
#include <cstdint>

#include "wami_common.cuh"

namespace {

constexpr float kLr = 0.05f;                       // learning rate
constexpr float kKeep = static_cast<float>(1.0 - 0.05);   // 1 - lr
constexpr float kMahal = 6.25f;                    // squared distance
constexpr float kFgCut = static_cast<float>(1.0 - 0.7);   // 1 - fg
constexpr float kVarFloor = 1e-4f;
constexpr float kFreshVar = 25.0f;

// first index of the least of (v0, v1, v2), as a one-hot of 0/1 floats
__device__ __forceinline__ void first_min_onehot(float v0, float v1,
                                                 float v2, float oh[3]) {
    const bool b0 = (v0 <= v1) && (v0 <= v2);
    const bool b1 = !b0 && (v1 <= v2);
    oh[0] = b0 ? 1.0f : 0.0f;
    oh[1] = b1 ? 1.0f : 0.0f;
    oh[2] = (b0 || b1) ? 0.0f : 1.0f;
}

// one pixel: x and its three components in, the updated components and
// the foreground bit out
__device__ __forceinline__ bool gmm_pixel(float x, const float* m,
                                          const float* v, const float* wt,
                                          float* mo, float* vo, float* wo) {
    float dx[3], sq[3], d2m[3];
    bool any = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        dx[k] = __fsub_rn(x, m[k]);
        sq[k] = __fmul_rn(dx[k], dx[k]);
        const float d2 = __fdiv_rn(sq[k], fmaxf(v[k], kVarFloor));
        const bool match = d2 < kMahal;
        any = any || match;
        d2m[k] = match ? d2 : __int_as_float(0x7f800000);   // +inf
    }
    float oh[3], wh[3];
    first_min_onehot(d2m[0], d2m[1], d2m[2], oh);
    first_min_onehot(wt[0], wt[1], wt[2], wh);
    const float hit = any ? 1.0f : 0.0f, miss = any ? 0.0f : 1.0f;
    float wn[3];
    float matched_w = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float o = __fmul_rn(oh[k], hit);
        const float ol = __fmul_rn(o, kLr);
        const float h = __fmul_rn(wh[k], miss);
        const float keep = __fsub_rn(1.0f, h);
        float mn = __fadd_rn(m[k], __fmul_rn(ol, dx[k]));
        float vn = __fadd_rn(v[k], __fmul_rn(ol, __fsub_rn(sq[k], v[k])));
        wn[k] = __fadd_rn(__fmul_rn(kKeep, wt[k]), __fmul_rn(kLr, o));
        mo[k] = __fadd_rn(__fmul_rn(mn, keep), __fmul_rn(h, x));
        vo[k] = __fadd_rn(__fmul_rn(vn, keep), __fmul_rn(h, kFreshVar));
        wn[k] = __fadd_rn(__fmul_rn(wn[k], keep), __fmul_rn(h, kLr));
        matched_w = __fadd_rn(matched_w, __fmul_rn(o, wt[k]));
    }
    const float total = __fadd_rn(__fadd_rn(wn[0], wn[1]), wn[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) wo[k] = __fdiv_rn(wn[k], total);
    return !any || (matched_w < kFgCut);
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

// A tile row's pixels: `head` scalar ones up to the first 16-byte-aligned
// run, `runs` runs of 4, then `tail` scalar ones.  Work items of a CTA:
// bh * runs runs first, then bh * (head + tail) scalar pixels.
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

__global__ void __launch_bounds__(1024)
change_det_kernel(const float* __restrict__ gray,
                  const float* __restrict__ mu,
                  const float* __restrict__ var,
                  const float* __restrict__ w, bool* __restrict__ mask,
                  float* __restrict__ mu_o, float* __restrict__ var_o,
                  float* __restrict__ w_o, int W, int bh, int bw, int vec) {
    const WamiTile t(bh, bw);
    const RowSplit rs = row_split(t.col0, bw, vec != 0);
    const int n_runs = bh * rs.runs, n_scalar = rs.head + rs.tail;
    const int items = n_runs + bh * n_scalar;
    for (int e = threadIdx.x; e < items; e += blockDim.x) {
        if (e < n_runs) {
            const int r = e / rs.runs;
            const int c = rs.head + 4 * (e - r * rs.runs);
            const long long p = (long long)(t.row0 + r) * W + t.col0 + c;
            // all ten loads first: x, then 12 floats each of mu, var, w
            float x[4], m[12], v[12], wt[12];
            ld4(x, gray + p);
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                ld4(m + 4 * i, mu + 3 * p + 4 * i);
                ld4(v + 4 * i, var + 3 * p + 4 * i);
                ld4(wt + 4 * i, w + 3 * p + 4 * i);
            }
            // each float4 of the new state is stored as soon as its
            // pixels are done, so the outputs do not all stay live
            float mo[12], vo[12], wo[12];
            uchar4 fg;
            fg.x = gmm_pixel(x[0], m, v, wt, mo, vo, wo);
            fg.y = gmm_pixel(x[1], m + 3, v + 3, wt + 3, mo + 3, vo + 3,
                             wo + 3);
            st4(mu_o + 3 * p, mo);
            st4(var_o + 3 * p, vo);
            st4(w_o + 3 * p, wo);
            fg.z = gmm_pixel(x[2], m + 6, v + 6, wt + 6, mo + 6, vo + 6,
                             wo + 6);
            st4(mu_o + 3 * p + 4, mo + 4);
            st4(var_o + 3 * p + 4, vo + 4);
            st4(w_o + 3 * p + 4, wo + 4);
            fg.w = gmm_pixel(x[3], m + 9, v + 9, wt + 9, mo + 9, vo + 9,
                             wo + 9);
            st4(mu_o + 3 * p + 8, mo + 8);
            st4(var_o + 3 * p + 8, vo + 8);
            st4(w_o + 3 * p + 8, wo + 8);
            *reinterpret_cast<uchar4*>(mask + p) = fg;
        } else {
            const int s = e - n_runs;
            const int r = s / n_scalar, k = s - r * n_scalar;
            const int c = k < rs.head ? k : k + 4 * rs.runs;
            const long long p = (long long)(t.row0 + r) * W + t.col0 + c;
            float m[3], v[3], wt[3], mo[3], vo[3], wo[3];
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                m[i] = mu[3 * p + i];
                v[i] = var[3 * p + i];
                wt[i] = w[3 * p + i];
            }
            mask[p] = gmm_pixel(gray[p], m, v, wt, mo, vo, wo);
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                mu_o[3 * p + i] = mo[i];
                var_o[3 * p + i] = vo[i];
                w_o[3 * p + i] = wo[i];
            }
        }
    }
}

}  // namespace

// gray: (H, W) float32; mu, var, w: (H, W, 3) float32 -> mask: (H, W)
// bool, mu_o, var_o, w_o: (H, W, 3) float32; W % ports == 0 and
// H % unrolls == 0 (checked by the Python wrapper).  Threads per CTA: the
// tile's work items (runs of 4 plus scalar pixels) rounded up to a whole
// warp, at most 1,024 -- kernels/wami_change_det/kernel.py's
// change_det_geometry is the same formula.
WAMI_EXPORT int wami_change_det(const float* gray, const float* mu,
                                const float* var, const float* w,
                                bool* mask, float* mu_o, float* var_o,
                                float* w_o, int H, int W, int ports,
                                int unrolls, void* stream) {
    const int bh = unrolls, bw = W / ports;
    const uintptr_t any16 =
        reinterpret_cast<uintptr_t>(gray) | reinterpret_cast<uintptr_t>(mu)
        | reinterpret_cast<uintptr_t>(var) | reinterpret_cast<uintptr_t>(w)
        | reinterpret_cast<uintptr_t>(mu_o)
        | reinterpret_cast<uintptr_t>(var_o)
        | reinterpret_cast<uintptr_t>(w_o);
    const bool vec = W % 4 == 0 && (any16 & 15) == 0
                     && (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
    // a tile's first column j * bw takes at most four values mod 4: the
    // most items any CTA has
    int items = 0;
    for (int j = 0; j < ports && j < 4; ++j) {
        const RowSplit rs = row_split(j * bw, bw, vec);
        const int n = bh * (rs.runs + rs.head + rs.tail);
        if (n > items) items = n;
    }
    const int warps = (items + 31) / 32;
    const int threads = warps < 32 ? 32 * warps : 1024;
    const dim3 grid(H / unrolls, ports);
    change_det_kernel<<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        gray, mu, var, w, mask, mu_o, var_o, w_o, W, bh, bw, vec ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}
