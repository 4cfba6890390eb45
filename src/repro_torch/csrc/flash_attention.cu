// Flash attention forward for Hopper (sm_90a): streaming softmax over KV
// blocks, f32 running (m, l, acc) per query row, GQA through KV head
// h / (H / K), causal mask, sliding window, tanh soft-cap and q_offset.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, pl.pallas_call at :107).  The TPU kernel walks its
// grid (B, H, Sq / block_q, Skv / block_kv) with the KV axis sequential,
// carrying (m, l, acc) in VMEM scratch from one grid step to the next.
// CTAs on the card run in no order, so the sequential axis becomes a loop
// inside the CTA: grid (Sq / block_q, H, B), and each CTA walks its KV
// blocks of block_kv rows in order.  q, k, v and o are read and written
// in the model layout (B, S, heads, d) through its strides: no
// transposes.
//
// Numerics are the TPU kernel's, not the plain version's: masked scores
// are -1e30 (not -inf), q is scaled before the dot, the soft-cap
// tanhf(s / softcap) * softcap comes before the mask, p is zeroed where
// masked, and the output is acc / max(l, 1e-30).  expf and tanhf, no
// fast math.  A KV block in which every (row, column) pair is masked is
// skipped, which is exact: with m_prev > -1e30 its scores leave m as it
// is, so corr = 1 and p = 0; with m_prev = -1e30 nothing accumulates
// (p = 0 where masked).  A row masked everywhere gives 0, as on the TPU.
//
// Bound on an H100 SXM (published peaks, 700 W limit): operations for a
// long sequence -- one gemma2-9b local layer (S 4096, H 16, K 8, d 256,
// bf16) moves ~100 MB (~30 us at 3.35 TB/s) but needs ~137 GFLOP causal
// (~0.14 ms on the bf16 tensor cores); bytes at the fleet DSE's 128
// tokens, where the launch dominates.  This first kernel does its math
// in f32 FMA on the CUDA cores (tensor cores, TMA and wgmma come later):
// the Q tile (pre-scaled), the K and V tiles, the score tile and acc are
// staged in dynamic shared memory as f32, and both products run as 4 x 4
// register micro-tiles read as float4 from rows padded by 4 floats (so a
// quarter-warp's 16-byte reads fall in distinct banks).  The wrapper
// refuses a block whose staging exceeds the opt-in shared memory.
#include <cuda_bf16.h>

#include "kernel_export.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr int kPad = 4;             // floats of padding per staged row

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// floor(a / b) for b > 0
__host__ __device__ __forceinline__ int floor_div(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ bool unmasked(int dist, int causal, int window) {
    return (!causal || dist >= 0) && (window <= 0 || dist < window);
}

// Shared memory, in floats: Q, K, V and acc tiles of (rows, D + kPad),
// the score tile (block_q, block_kv + 1), and m, l, corr per row.
__host__ __device__ __forceinline__ long long smem_floats(int D, int bq,
                                                          int bkv) {
    return (2LL * bq + 2LL * bkv) * (D + kPad) + (long long)bq * (bkv + 1)
           + 3LL * bq;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq,
                 int Skv, int H, int K, int bq, int bkv, float scale,
                 int causal, int window, float softcap, int q_offset) {
    extern __shared__ float4 smem4[];
    constexpr int LD = D + kPad;
    const int ldS = bkv + 1;
    float* Qs = reinterpret_cast<float*>(smem4);
    float* Ks = Qs + bq * LD;
    float* Vs = Ks + bkv * LD;
    float* As = Vs + bkv * LD;
    float* Ss = As + bq * LD;
    float* m_s = Ss + bq * ldS;
    float* l_s = m_s + bq;
    float* c_s = l_s + bq;

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * bq, h = blockIdx.y, b = blockIdx.z;
    const int kh = h / (H / K);
    // strides of the (B, S, heads, D) layout: one token of q / o, of k / v
    const long long q_tok = (long long)H * D, kv_tok = (long long)K * D;
    const T* qb = q + ((long long)b * Sq + q0) * q_tok + (long long)h * D;
    T* ob = o + ((long long)b * Sq + q0) * q_tok + (long long)h * D;
    const T* kb = k + (long long)b * Skv * kv_tok + (long long)kh * D;
    const T* vb = v + (long long)b * Skv * kv_tok + (long long)kh * D;

    for (int e = tid; e < bq * D; e += kThreads) {
        const int r = e / D, c = e - r * D;
        Qs[r * LD + c] = to_f32(qb[r * q_tok + c]) * scale;
        As[r * LD + c] = 0.0f;
    }
    for (int r = tid; r < bq; r += kThreads) {
        m_s[r] = kNegInf;
        l_s[r] = 0.0f;
    }

    // the KV blocks holding an unmasked pair: causal keeps kv <= the last
    // row's position, the window keeps kv >= the first row's position
    // - window + 1; every other block is masked throughout (skipped)
    const int n_kv = Skv / bkv;
    const int pos_lo = q0 + q_offset, pos_hi = q0 + bq - 1 + q_offset;
    int kb_lo = 0, kb_hi = n_kv;
    if (causal) kb_hi = min(n_kv, max(0, floor_div(pos_hi, bkv) + 1));
    if (window > 0) kb_lo = max(0, floor_div(pos_lo - window + 1, bkv));

    // the row pass: gsz lanes (a power of two, <= 32) share one row
    int gsz = 1;
    while (gsz < 32 && 2 * gsz * bq <= kThreads) gsz *= 2;
    const int rows_per_pass = kThreads / gsz, lane_g = tid & (gsz - 1);
    const int rq = bq / 4, cq = bkv / 4, cd = D / 4;

    for (int kbi = kb_lo; kbi < kb_hi; ++kbi) {
        const int k0 = kbi * bkv;
        __syncthreads();        // the last block's readers are done
        for (int e = tid; e < bkv * D; e += kThreads) {
            const int r = e / D, c = e - r * D;
            const long long g = (long long)(k0 + r) * kv_tok + c;
            Ks[r * LD + c] = to_f32(kb[g]);
            Vs[r * LD + c] = to_f32(vb[g]);
        }
        __syncthreads();

        // s = (q * scale) . k; soft-cap; mask.  Thread tile: rows
        // rt + i * rq, columns ct + j * cq (neighbouring threads read
        // neighbouring K rows).
        for (int t = tid; t < rq * cq; t += kThreads) {
            const int rt = t / cq, ct = t - rt * cq;
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
            for (int e = 0; e < D; e += 4) {
                float4 a[4], w[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    a[i] = *reinterpret_cast<const float4*>(
                        Qs + (rt + i * rq) * LD + e);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    w[j] = *reinterpret_cast<const float4*>(
                        Ks + (ct + j * cq) * LD + e);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        float s = acc[i][j];
                        s = fmaf(a[i].x, w[j].x, s);
                        s = fmaf(a[i].y, w[j].y, s);
                        s = fmaf(a[i].z, w[j].z, s);
                        s = fmaf(a[i].w, w[j].w, s);
                        acc[i][j] = s;
                    }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int r = rt + i * rq, c = ct + j * cq;
                    float s = acc[i][j];
                    if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
                    const int dist = (q0 + r + q_offset) - (k0 + c);
                    Ss[r * ldS + c] =
                        unmasked(dist, causal, window) ? s : kNegInf;
                }
        }
        __syncthreads();

        // per row: m_new, corr, p (zeroed where masked), l
        for (int base = 0; base < bq; base += rows_per_pass) {
            const int r = base + tid / gsz;
            const bool active = r < bq;
            const float m_prev = active ? m_s[r] : kNegInf;
            float mx = kNegInf;
            if (active)
                for (int c = lane_g; c < bkv; c += gsz)
                    mx = fmaxf(mx, Ss[r * ldS + c]);
            for (int off = gsz / 2; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m_prev, mx);
            const float corr = expf(m_prev - m_new);
            float sum = 0.0f;
            if (active)
                for (int c = lane_g; c < bkv; c += gsz) {
                    const int dist = (q0 + r + q_offset) - (k0 + c);
                    const float p = unmasked(dist, causal, window)
                                        ? expf(Ss[r * ldS + c] - m_new)
                                        : 0.0f;
                    Ss[r * ldS + c] = p;
                    sum += p;
                }
            for (int off = gsz / 2; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (active && lane_g == 0) {
                l_s[r] = l_s[r] * corr + sum;
                m_s[r] = m_new;
                c_s[r] = corr;
            }
        }
        __syncthreads();

        // acc = acc * corr + p . v.  Thread tile: rows rt + i * rq, the
        // four columns 4 ct .. 4 ct + 3.
        for (int t = tid; t < rq * cd; t += kThreads) {
            const int rt = t / cd, ct = t - rt * cd;
            float4 pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int j = 0; j < bkv; ++j) {
                const float4 w =
                    *reinterpret_cast<const float4*>(Vs + j * LD + 4 * ct);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p = Ss[(rt + i * rq) * ldS + j];
                    pv[i].x = fmaf(p, w.x, pv[i].x);
                    pv[i].y = fmaf(p, w.y, pv[i].y);
                    pv[i].z = fmaf(p, w.z, pv[i].z);
                    pv[i].w = fmaf(p, w.w, pv[i].w);
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = rt + i * rq;
                const float cr = c_s[r];
                float4* a = reinterpret_cast<float4*>(As + r * LD + 4 * ct);
                float4 cur = *a;
                cur.x = cur.x * cr + pv[i].x;
                cur.y = cur.y * cr + pv[i].y;
                cur.z = cur.z * cr + pv[i].z;
                cur.w = cur.w * cr + pv[i].w;
                *a = cur;
            }
        }
    }
    __syncthreads();
    for (int e = tid; e < bq * D; e += kThreads) {
        const int r = e / D, c = e - r * D;
        ob[r * q_tok + c] =
            from_f32<T>(As[r * LD + c] / fmaxf(l_s[r], 1e-30f));
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int K, int bq, int bkv, int causal,
           int window, float softcap, int q_offset, float scale,
           cudaStream_t stream) {
    auto kern = flash_fwd_kernel<T, D>;
    const long long smem = smem_floats(D, bq, bkv) * 4;
    static long long opted_in = 48 * 1024;   // per instantiation
    if (smem > opted_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        opted_in = smem;
    }
    const dim3 grid(Sq / bq, H, B);
    kern<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, K, bq, bkv,
        scale, causal, window, softcap, q_offset);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Skv, int H, int K, int bq, int bkv,
             int causal, int window, float softcap, int q_offset,
             float scale, cudaStream_t s) {
    switch (D) {
        case 32:
            return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, K, bq, bkv,
                                 causal, window, softcap, q_offset, scale, s);
        case 64:
            return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, K, bq, bkv,
                                 causal, window, softcap, q_offset, scale, s);
        case 256:
            return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, K, bq, bkv,
                                  causal, window, softcap, q_offset, scale, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// q: (B, Sq, H, D); k, v: (B, Skv, K, D); o: (B, Sq, H, D); all
// contiguous, float32 (bf16 == 0) or bfloat16 (bf16 == 1).  D in
// {32, 64, 256}; H % K == 0; Sq % block_q == 0, Skv % block_kv == 0,
// block_q and block_kv multiples of 4, and the staging within the opt-in
// shared memory (all checked by the Python wrapper).
KERNEL_EXPORT int flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int K, int D, int bf16,
                                      int block_q, int block_kv, int causal,
                                      int window, float softcap,
                                      int q_offset, float scale,
                                      void* stream) {
    if (block_q % 4 || block_kv % 4 || Sq % block_q || Skv % block_kv
        || H % K)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16)
        return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, H, K,
                                       block_q, block_kv, causal, window,
                                       softcap, q_offset, scale, s);
    return launch_d<float>(D, q, k, v, o, B, Sq, Skv, H, K, block_q,
                           block_kv, causal, window, softcap, q_offset,
                           scale, s);
}
