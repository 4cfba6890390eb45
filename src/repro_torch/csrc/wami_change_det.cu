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
// 12-byte run each, so every state byte moves once.  The argmins over K
// are unrolled by hand with the plain version's first-index tie-break.
// The match and the mask are discrete choices and must equal the plain
// version's bit for bit, so every operation is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, IEEE __fdiv_rn: no contraction into
// FMA, no approximate division), in the plain version's order, with
// the factors 0/1 of its one-hots kept as multiplications.  The rate
// and thresholds are the plain version's defaults, compiled in.
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

__global__ void change_det_kernel(const float* __restrict__ gray,
                                  const float* __restrict__ mu,
                                  const float* __restrict__ var,
                                  const float* __restrict__ w,
                                  bool* __restrict__ mask,
                                  float* __restrict__ mu_o,
                                  float* __restrict__ var_o,
                                  float* __restrict__ w_o, int W, int bh,
                                  int bw) {
    const WamiTile t(bh, bw);
    for (int e = threadIdx.x; e < t.pixels(); e += blockDim.x) {
        const int r = e / bw, c = e - r * bw;
        const long long p = (long long)(t.row0 + r) * W + t.col0 + c;
        const float x = gray[p];
        float m[3], v[3], wt[3], dx[3], sq[3], d2m[3];
        bool any = false;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            m[k] = mu[3 * p + k];
            v[k] = var[3 * p + k];
            wt[k] = w[3 * p + k];
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
        float mn[3], vn[3], wn[3];
        float matched_w = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float o = __fmul_rn(oh[k], hit);
            const float ol = __fmul_rn(o, kLr);
            const float h = __fmul_rn(wh[k], miss);
            const float keep = __fsub_rn(1.0f, h);
            mn[k] = __fadd_rn(m[k], __fmul_rn(ol, dx[k]));
            vn[k] = __fadd_rn(v[k], __fmul_rn(ol, __fsub_rn(sq[k], v[k])));
            wn[k] = __fadd_rn(__fmul_rn(kKeep, wt[k]), __fmul_rn(kLr, o));
            mn[k] = __fadd_rn(__fmul_rn(mn[k], keep), __fmul_rn(h, x));
            vn[k] = __fadd_rn(__fmul_rn(vn[k], keep),
                              __fmul_rn(h, kFreshVar));
            wn[k] = __fadd_rn(__fmul_rn(wn[k], keep), __fmul_rn(h, kLr));
            matched_w = __fadd_rn(matched_w, __fmul_rn(o, wt[k]));
        }
        const float total = __fadd_rn(__fadd_rn(wn[0], wn[1]), wn[2]);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            mu_o[3 * p + k] = mn[k];
            var_o[3 * p + k] = vn[k];
            w_o[3 * p + k] = __fdiv_rn(wn[k], total);
        }
        mask[p] = !any || (matched_w < kFgCut);
    }
}

}  // namespace

// gray: (H, W) float32; mu, var, w: (H, W, 3) float32 -> mask: (H, W)
// bool, mu_o, var_o, w_o: (H, W, 3) float32; W % ports == 0 and
// H % unrolls == 0 (checked by the Python wrapper).
WAMI_EXPORT int wami_change_det(const float* gray, const float* mu,
                                const float* var, const float* w,
                                bool* mask, float* mu_o, float* var_o,
                                float* w_o, int H, int W, int ports,
                                int unrolls, void* stream) {
    const int bh = unrolls, bw = W / ports;
    const dim3 grid(H / unrolls, ports);
    change_det_kernel<<<grid, wami_threads(bh * bw), 0,
                        static_cast<cudaStream_t>(stream)>>>(
        gray, mu, var, w, mask, mu_o, var_o, w_o, W, bh, bw);
    return static_cast<int>(cudaGetLastError());
}
