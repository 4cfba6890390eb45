// Flash attention forward for Hopper (sm_90a): streaming softmax over KV
// blocks, f32 running (m, l, acc) per query row, GQA through KV head
// h / (H / K), causal mask, sliding window, tanh soft-cap and q_offset.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, pl.pallas_call at :107).  The TPU kernel walks its
// grid (B, H, Sq / block_q, Skv / block_kv) with the KV axis sequential,
// carrying (m, l, acc) in VMEM scratch from one grid step to the next.
// CTAs on the card run in no order, so the sequential axis becomes a loop
// inside the CTA: grid (Sq / tile_q, H, B), and each CTA walks its KV
// tiles of tile_kv rows in order (the tiles are the caller's blocks
// wherever the body takes them; see "Shapes" below).  q, k, v and o are
// read and written in the model layout (B, S, heads, d) through its
// strides: no transposes.  With a causal mask the query blocks launch longest first
// (blockIdx.x 0 takes the last block), so the CTAs with the most KV
// blocks do not finish last.
//
// Numerics are the TPU kernel's: masked scores are -1e30 (not -inf), the
// soft-cap tanh(s / softcap) * softcap comes before the mask, p is zeroed
// where masked, and the output is acc / max(l, 1e-30).  The mask is
// applied only on a KV block that straddles the causal diagonal or the
// window's edge for the rows at hand.  A KV block in which every (row,
// column) pair is masked is skipped, which is exact: with m_prev > -1e30
// its scores leave m as it is, so corr = 1 and p = 0; with m_prev = -1e30
// nothing accumulates (p = 0 where masked).  A row masked everywhere
// gives 0, as on the TPU.
//
// Bound on an H100 SXM (published peaks, 700 W limit): operations for a
// long sequence -- one gemma2-9b local layer (S 4096, H 16, K 8, d 256,
// bf16) moves ~100 MB (~30 us at 3.35 TB/s) but needs ~137 GFLOP causal
// (~0.14 ms on the bf16 tensor cores); bytes at the fleet DSE's 128
// tokens (f32), where the launch and the chain of dependent steps per KV
// block dominate.  Two bodies, one entry point, dispatched on the type:
//
// bf16 (the model-width path): wgmma fed by TMA.  One consumer warpgroup
// per 64 query rows (tile_q <= 128: one or two; one at d 256) and one
// producer warp, whose lane 0 loads the Q tile once and the K and V
// tiles of each KV block by TMA (rank-4 tensor maps over the (B, S,
// heads, d) layout, 64-column boxes) into a ring of two stages,
// completed on mbarriers: block j + 1 is in flight while block j is
// computed, and a stage is refilled once every consumer warp has released
// it.  S = Q . K^T is wgmma m64nNk16 (N = tile_kv) with Q and K read
// from 128-byte-swizzled shared memory (64-byte at d 32), K-major; S
// stays in registers as f32, is multiplied by 1/sqrt(d) (S is formed
// unscaled: the same bits as the TPU kernel's pre-scaled q at d 64 and
// 256, where the scale is a power of two), soft-capped, masked, and the
// online softmax runs on the registers with quad shuffles for the row max
// and sum, exp through ex2.approx (__expf) and the soft-cap's tanh as
// tanh.approx.f32.  P is rounded to bf16 in registers -- the one
// departure from the TPU kernel's numerics, as in every Hopper flash
// kernel -- and is
// the A operand of O += P . V (wgmma m64n{d}k16), with V's tile read as
// an MN-major B operand, so no transpose is staged.  l sums the f32 p.
// A tile_q below 64 pads the m64 tile with zeroed rows of Q that are
// never read from device memory nor written back.  Register budget: the
// O accumulator at d 256 is 128 f32 registers a thread, S at tile_kv 64
// another 32 and P 16.  With one consumer warpgroup and the producer warp
// (160 threads) a thread may hold 255 and nothing spills; two warpgroups
// (288 threads) leave 224, which spills at d 256, so d 256 takes
// tile_q <= 64.  At d 128, O is 64 registers and two warpgroups fit.
//
// f32 (the fleet DSE's path): tensor cores with the 3xTF32 split of
// csrc/tf32_mma.cuh on mma.sync m16n8k8 (wgmma needs 64-row tiles; the
// DSE's ports 4 gives 32).  Each warp owns 16 query rows; S stays in the
// mma's C fragments and the softmax runs there; P goes to the A-fragment
// layout with no data movement, by permuting the order in which a k8
// step takes its 8 KV rows (A column t <- P column 2t, t + 4 <- 2t + 1,
// and V's rows likewise), which leaves the sum unchanged.  Q is staged
// once and the K/V tiles double-buffered by cp.async, rows padded by 4
// floats so fragment loads fall in distinct banks; one __syncthreads per
// KV block.  q is scaled before the dot, as on the TPU; expf and tanhf.
//
// Shapes.  Each body is built for native head dims D in {32, 64, 128,
// 256} and KV tiles in {16, 32, 64, 128}; the wrapper's flash_plan
// (kernels/flash_attention/kernel.py) maps a call onto them, and its
// flash_smem_bytes is the formula of f32_smem_floats and
// Bf16Layout::BYTES below.  A head dim d below D runs in the D body:
// columns d..D load as zeros (cp.async with a source size of 0; TMA
// fills what lies outside the tensor map's d extent), so they add
// nothing to Q . K^T, and they are never stored; q, k, v and o are
// addressed with the real d, and the scale is 1/sqrt(d).  The query and
// KV axes are walked in whole tiles (tile_q rows a CTA, tile_kv rows a
// step), and the rows of a last tile past Sq or Skv load as zeros (the
// bf16 maps are rank 4, (d, heads, S, B), so TMA zero-fills past S
// within each batch) and are masked like a causal miss: no such score
// enters a softmax, no such query row is stored.  These zero-filling
// copies, the per-key check against Skv and the stores that stop at d
// are compiled only into the general bodies (tile_kv 16, one warpgroup
// in bf16: dispatch below); whole tiles at a native d run the exact
// bodies, whose code is the fixed-shape kernel's.  A tensor map needs
// 16-byte strides, so in bf16 a d with d % 8 != 0 (or a pointer off the
// 16-byte grid) takes no TMA (flash_plan's tma): the producer warp then
// copies the tiles with 2-byte loads into the same swizzled layout,
// fences them into the async proxy and arrives on the same mbarriers.
// In f32 such a d copies with 4-byte cp.async.
#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "kernel_export.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr int kPad = 4;             // floats of padding per staged f32 row
constexpr int kStages = 2;          // the bf16 path's ring of K/V tiles

// floor(a / b) for b > 0
__host__ __device__ __forceinline__ int floor_div(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool unmasked(int dist, int causal, int window) {
    return (!causal || dist >= 0) && (window <= 0 || dist < window);
}

// Where rows at positions [lo, hi] meet the KV block [k0, k0 + bkv) of
// a sequence of kv_len keys: no pair unmasked (dead), every pair
// unmasked (full), or a mix.
struct BlockMask {
    bool dead, full;
    __device__ __forceinline__ BlockMask(int lo, int hi, int k0, int bkv,
                                         int kv_len, int causal,
                                         int window) {
        const int k1 = k0 + bkv - 1;
        dead = (causal && hi < k0) || (window > 0 && lo - k1 >= window);
        full = (!causal || lo >= k1) && (window <= 0 || hi - k0 < window)
               && k1 < kv_len;
    }
};

// the KV blocks holding an unmasked pair for the rows at positions
// [pos_lo, pos_hi]: causal keeps kv <= pos_hi, the window keeps
// kv >= pos_lo - window + 1; every other block is masked throughout
__device__ __forceinline__ void kv_range(int pos_lo, int pos_hi, int n_kv,
                                         int bkv, int causal, int window,
                                         int& lo, int& hi) {
    lo = 0;
    hi = n_kv;
    if (causal) hi = min(n_kv, max(0, floor_div(pos_hi, bkv) + 1));
    if (window > 0) lo = max(0, floor_div(pos_lo - window + 1, bkv));
}

// max and sum over the four lanes (a quad) that share an mma row
__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp and tanh: the accurate expf and tanhf (f32 path), or exp through
// ex2.approx and tanh.approx.f32 (bf16 path, FAST: one MUFU operation
// each, so the softmax does not outlast the block's two products)
template <bool FAST>
__device__ __forceinline__ float exp_(float x) {
    return FAST ? __expf(x) : expf(x);
}

template <bool FAST>
__device__ __forceinline__ float tanh_(float x) {
    if constexpr (FAST) {
        float y;
        asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
        return y;
    } else {
        return tanhf(x);
    }
}

// Whether the score at row position pos and key col is live: unmasked,
// and (TAIL: the walk has a last tile past the kv_len keys) col < kv_len.
template <bool TAIL>
__device__ __forceinline__ bool live(int pos, int col, int kv_len,
                                     int causal, int window) {
    return (!TAIL || col < kv_len) && unmasked(pos - col, causal, window);
}

// The online softmax over one KV block of a thread's S fragments: NT
// tiles of 8 columns, s[4 j + e] at row pos0 + (e < 2 ? 0 : 8) and
// column col0 + 8 j + (e & 1) (col0: the block's first column plus the
// thread's 2 t).  Soft-cap, mask (only when the block straddles the
// mask or the end of the kv_len keys), the row max, corr, p (0 where
// masked, in place of s) and the row sums; m and l updated, corr
// returned per row.  The check against kv_len is compiled in only for
// TAIL (the general bodies).
template <int NT, bool FAST, bool TAIL>
__device__ __forceinline__ void online_softmax(
    float* s, float scale, float softcap, bool need_mask, int pos0, int col0,
    int kv_len, int causal, int window, float (&m)[2], float (&l)[2],
    float (&corr)[2]) {
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float v = s[4 * j + e] * scale;
            if (softcap > 0.0f) v = tanh_<FAST>(v / softcap) * softcap;
            if (need_mask)
                v = live<TAIL>(pos0 + (e < 2 ? 0 : 8), col0 + 8 * j + (e & 1),
                               kv_len, causal, window) ? v : kNegInf;
            s[4 * j + e] = v;
            mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
    }
    float m_new[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = exp_<FAST>(m[r] - m_new[r]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float p = exp_<FAST>(s[4 * j + e] - m_new[e >> 1]);
            if (need_mask)
                p = live<TAIL>(pos0 + (e < 2 ? 0 : 8), col0 + 8 * j + (e & 1),
                               kv_len, causal, window) ? p : 0.0f;
            s[4 * j + e] = p;
            sum[e >> 1] += p;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * corr[r] + quad_sum(sum[r]);
        m[r] = m_new[r];
    }
}

// ------------------------------------------------------------ f32 path
// Shared memory, in floats: the Q tile (tile_q, D + kPad) and two
// stages of K and V tiles (tile_kv, D + kPad).
__host__ __device__ __forceinline__ long long f32_smem_floats(int D, int bq,
                                                              int bkv) {
    return ((long long)bq + 2LL * 2 * bkv) * (D + kPad);
}

// cp.async of 16 or 4 bytes that reads src_bytes of them (all or 0) and
// zero-fills the rest
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}

// Rows [0, rows) of a tile of D columns into shared rows of D + kPad
// floats, row r from src + r * stride, by zero-filling cp.async: rows >=
// valid and columns >= d read as zeros.  16-byte copies where vec (d % 4
// == 0, 16-byte aligned tensors), else 4-byte ones.  (Whole tiles at the
// native width take plain 16-byte copies in the exact bodies: the
// zero-filling ones measured slower at the fleet DSE on an H100.)
template <int D, int W>
__device__ __forceinline__ void stage_units(float* dst, const float* src,
                                            long long stride, int rows,
                                            int valid, int d, int tid,
                                            int nthr) {
    constexpr int LD = D + kPad, U = D / W;    // units of W floats a row
    for (int e = tid; e < rows * U; e += nthr) {
        const int r = e / U, c = (e - r * U) * W;
        const bool ok = r < valid && c < d;
        const float* s = ok ? src + r * stride + c : src;
        if constexpr (W == 4)
            cp_async16_zfill(dst + r * LD + c, s, ok ? 16 : 0);
        else
            cp_async4_zfill(dst + r * LD + c, s, ok ? 4 : 0);
    }
}

template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int rows,
                                           int valid, int d, bool vec,
                                           int tid, int nthr) {
    if (vec)
        stage_units<D, 4>(dst, src, stride, rows, valid, d, tid, nthr);
    else
        stage_units<D, 1>(dst, src, stride, rows, valid, d, tid, nthr);
}

// a row's outputs at columns c and c + 1, those below d only
__device__ __forceinline__ void store_pair(float* row, int c, int d,
                                           float a, float b) {
    if ((d & 1) == 0 && c < d) {
        *reinterpret_cast<float2*>(row + c) = make_float2(a, b);
    } else {
        if (c < d) row[c] = a;
        if (c + 1 < d) row[c + 1] = b;
    }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int d,
                                           float a, float b) {
    if ((d & 1) == 0 && c < d) {
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(a, b);
    } else {
        if (c < d) row[c] = __float2bfloat16_rn(a);
        if (c + 1 < d) row[c + 1] = __float2bfloat16_rn(b);
    }
}

// the three products of the split on one accumulator, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
    mma_tf32(d, as, bb);
    mma_tf32(d, ab, bs);
    mma_tf32(d, ab, bb);
}

// One CTA: tile_q / 16 warps, each owning 16 query rows.  Scores of
// tile_kv <= 32 columns go to three accumulators (one per product of
// the split: short dependent chains where there are few tiles), wider
// ones to one.
template <int D, int BKV, bool GENERAL>
__global__ void __launch_bounds__(256)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Skv, int H, int K, int d, int bq, float scale,
                 int causal, int window, float softcap, int q_offset,
                 int vec) {
    constexpr int LD = D + kPad;
    constexpr int NT = BKV / 8;            // 8-column tiles of S
    constexpr int ND = D / 8;              // 8-column tiles of O
    constexpr int NACC = (BKV <= 32 && D <= 64) ? 3 : 1;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);
    float* KVs = Qs + bq * LD;             // stage s: K, then V

    const int tid = threadIdx.x, nthr = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int qblk = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int q0 = qblk * bq, h = blockIdx.y, b = blockIdx.z;
    const int qrows = GENERAL ? min(bq, Sq - q0) : bq;   // rows below Sq
    const int kh = h / (H / K);
    const int dd = GENERAL ? d : D;        // the real head dim
    // strides of the (B, S, heads, d) layout: one token of q / o, of k / v
    const long long q_tok = (long long)H * dd, kv_tok = (long long)K * dd;
    const float* qb = q + ((long long)b * Sq + q0) * q_tok
                      + (long long)h * dd;
    float* ob = o + ((long long)b * Sq + q0) * q_tok + (long long)h * dd;
    const float* kb = k + (long long)b * Skv * kv_tok + (long long)kh * dd;
    const float* vb = v + (long long)b * Skv * kv_tok + (long long)kh * dd;

    int kb_lo, kb_hi;
    kv_range(q0 + q_offset, q0 + qrows - 1 + q_offset, (Skv + BKV - 1) / BKV,
             BKV, causal, window, kb_lo, kb_hi);

    // the exact body: whole aligned tiles, plain 16-byte copies, K and V
    // in one loop; the general one zero-fills what lies past Sq, Skv, d
    constexpr int U = D / 4;               // 16-byte units per row
    if constexpr (GENERAL) {
        stage_rows<D>(Qs, qb, q_tok, bq, qrows, d, vec, tid, nthr);
    } else {
        for (int e = tid; e < bq * U; e += nthr) {
            const int r = e / U, c = (e - r * U) * 4;
            cp_async16(Qs + r * LD + c, qb + r * q_tok + c);
        }
    }
    auto stage_kv = [&](int kbi, int s) {
        float* Kt = KVs + s * 2 * BKV * LD;
        float* Vt = Kt + BKV * LD;
        const long long g0 = (long long)kbi * BKV * kv_tok;
        if constexpr (GENERAL) {
            const int valid = min(BKV, Skv - kbi * BKV);
            stage_rows<D>(Kt, kb + g0, kv_tok, BKV, valid, d, vec, tid,
                          nthr);
            stage_rows<D>(Vt, vb + g0, kv_tok, BKV, valid, d, vec, tid,
                          nthr);
        } else {
            for (int e = tid; e < BKV * U; e += nthr) {
                const int r = e / U, c = (e - r * U) * 4;
                cp_async16(Kt + r * LD + c, kb + g0 + r * kv_tok + c);
                cp_async16(Vt + r * LD + c, vb + g0 + r * kv_tok + c);
            }
        }
    };
    if (kb_lo < kb_hi) stage_kv(kb_lo, 0);
    cp_async_commit();

    const int r0 = warp * 16;              // the warp's first row
    const int pos0 = q0 + r0 + g + q_offset;   // position of row g
    const int wlo = q0 + r0 + q_offset, whi = wlo + 15;
    float oacc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    for (int kbi = kb_lo; kbi < kb_hi; ++kbi) {
        const int s = (kbi - kb_lo) & 1;
        // this block has landed, and every warp is done with the other
        // stage (the last block), which the next copy overwrites
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        if (kbi + 1 < kb_hi) stage_kv(kbi + 1, s ^ 1);
        cp_async_commit();

        const int k0 = kbi * BKV;
        const BlockMask bm(wlo, whi, k0, BKV, Skv, causal, window);
        if (bm.dead) continue;
        const float* Kt = KVs + s * 2 * BKV * LD;
        const float* Vt = Kt + BKV * LD;

        // S = (q * scale) . k^T
        float sacc[NACC][NT][4];
#pragma unroll
        for (int a = 0; a < NACC; ++a)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) sacc[a][j][e] = 0.0f;
#pragma unroll 2
        for (int kk = 0; kk < D / 8; ++kk) {
            const float* qr = Qs + (r0 + g) * LD + 8 * kk + t;
            uint32_t ab[4], as[4];
            split_tf32(qr[0] * scale, ab[0], as[0]);
            split_tf32(qr[8 * LD] * scale, ab[1], as[1]);
            split_tf32(qr[4] * scale, ab[2], as[2]);
            split_tf32(qr[8 * LD + 4] * scale, ab[3], as[3]);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const float* kr = Kt + (8 * j + g) * LD + 8 * kk + t;
                uint32_t bb[2], bs[2];
                split_tf32(kr[0], bb[0], bs[0]);
                split_tf32(kr[4], bb[1], bs[1]);
                if constexpr (NACC == 3) {
                    mma_tf32(sacc[0][j], ab, bb);
                    mma_tf32(sacc[1][j], ab, bs);
                    mma_tf32(sacc[2][j], as, bb);
                } else {
                    mma_3xtf32(sacc[0][j], ab, as, bb, bs);
                }
            }
        }
        float p[NT * 4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if constexpr (NACC == 3)
                    p[4 * j + e] = sacc[0][j][e]
                                   + (sacc[1][j][e] + sacc[2][j][e]);
                else
                    p[4 * j + e] = sacc[0][j][e];
            }
        float corr[2];
        online_softmax<NT, false, GENERAL>(p, 1.0f, softcap, !bm.full,
                                           pos0, k0 + 2 * t, Skv, causal,
                                           window, m, l, corr);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            oacc[n][0] *= corr[0];
            oacc[n][1] *= corr[0];
            oacc[n][2] *= corr[1];
            oacc[n][3] *= corr[1];
        }
        // O += P . V, k8 step jj taking KV rows in the order 2t, 2t + 1:
        // A (row, t) <- P column 2t, (row, t + 4) <- 2t + 1 -- exactly
        // the C fragment this thread holds -- and V's rows to match
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
            uint32_t ab[4], as[4];
            split_tf32(p[4 * jj + 0], ab[0], as[0]);
            split_tf32(p[4 * jj + 2], ab[1], as[1]);
            split_tf32(p[4 * jj + 1], ab[2], as[2]);
            split_tf32(p[4 * jj + 3], ab[3], as[3]);
            const float* vr = Vt + (8 * jj + 2 * t) * LD + g;
#pragma unroll
            for (int n = 0; n < ND; ++n) {
                uint32_t bb[2], bs[2];
                split_tf32(vr[8 * n], bb[0], bs[0]);
                split_tf32(vr[LD + 8 * n], bb[1], bs[1]);
                mma_3xtf32(oacc[n], ab, as, bb, bs);
            }
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");

    const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
    const int row = r0 + g;
    float* o0 = ob + (long long)row * q_tok;
    float* o1 = o0 + 8 * q_tok;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
        if constexpr (GENERAL) {
            if (row < qrows)
                store_pair(o0, 8 * n + 2 * t, d, oacc[n][0] / l0,
                           oacc[n][1] / l0);
            if (row + 8 < qrows)
                store_pair(o1, 8 * n + 2 * t, d, oacc[n][2] / l1,
                           oacc[n][3] / l1);
        } else {
            *reinterpret_cast<float2*>(o0 + 8 * n + 2 * t) =
                make_float2(oacc[n][0] / l0, oacc[n][1] / l0);
            *reinterpret_cast<float2*>(o1 + 8 * n + 2 * t) =
                make_float2(oacc[n][2] / l1, oacc[n][3] / l1);
        }
    }
}

// ----------------------------------------------------------- bf16 path
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// one box of a rank-4 tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
        : "memory");
}

// the producer warp's generic-proxy writes of a tile made visible to
// wgmma (the async proxy), then one arrival on bar
__device__ __forceinline__ void publish(uint64_t* bar, int lane) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
    asm volatile("wgmma.commit_group.sync.aligned;\n"
                 "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses to wgmma's registers across
// the asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle (1: 128 B, 2: 64 B).  K-major
// (Q, K): SBO steps 8 rows, LBO is unused.  MN-major (V): LBO steps one
// swizzle atom's width along d, SBO 8 rows of the KV block.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
           | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
           | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
           | static_cast<uint64_t>(swizzle) << 62;
}

template <int N>
struct Wgmma;
template <>
struct Wgmma<16> {
    // d (+)= A . B, A and B K-major in shared memory
    static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                              uint64_t db, int acc) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %10, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7"
            "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
            : "l"(da), "l"(db), "r"(acc));
    }
};

template <>
struct Wgmma<32> {
    // d (+)= A . B, A and B K-major in shared memory
    static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                              uint64_t db, int acc) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15"
            "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "l"(da), "l"(db), "r"(acc));
    }
    // d += A . B, A (bf16 pairs) in registers, B MN-major in shared memory
    static __device__ __forceinline__ void rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15"
            "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
};

template <>
struct Wgmma<64> {
    // d (+)= A . B, A and B K-major in shared memory
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31"
            "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "l"(da), "l"(db), "r"(acc));
    }
    // d += A . B, A (bf16 pairs) in registers, B MN-major in shared memory
    static __device__ __forceinline__ void rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31"
            "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
};

template <>
struct Wgmma<128> {
    // d (+)= A . B, A and B K-major in shared memory
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63"
            "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
              "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
              "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(da), "l"(db), "r"(acc));
    }
    // d += A . B, A (bf16 pairs) in registers, B MN-major in shared memory
    static __device__ __forceinline__ void rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63"
            "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
              "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
              "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
};

template <>
struct Wgmma<256> {
    // d += A . B, A (bf16 pairs) in registers, B MN-major in shared memory
    static __device__ __forceinline__ void rs(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %133, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63, "
            "%64, %65, %66, %67, %68, %69, %70, %71, "
            "%72, %73, %74, %75, %76, %77, %78, %79, "
            "%80, %81, %82, %83, %84, %85, %86, %87, "
            "%88, %89, %90, %91, %92, %93, %94, %95, "
            "%96, %97, %98, %99, %100, %101, %102, %103, "
            "%104, %105, %106, %107, %108, %109, %110, %111, "
            "%112, %113, %114, %115, %116, %117, %118, %119, "
            "%120, %121, %122, %123, %124, %125, %126, %127"
            "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
              "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
              "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
              "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
              "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
              "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
              "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
              "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
              "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
              "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
              "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
              "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
              "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
              "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
              "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
              "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
              "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
              "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
};


// The bf16 CTA's shared memory, from a 1024-byte-aligned base: the Q
// tile (64 rows per consumer warpgroup), kStages stages of a K and a V
// tile, then the mbarriers.  Each tile is D / ATOM column atoms of
// (rows, ATOM) bf16, each row one swizzled 128-byte line (64 bytes at
// D 32), as the TMA boxes land them.
template <int D, int BKV, int NWG>
struct Bf16Layout {
    static constexpr int ATOM = D >= 64 ? 64 : 32;   // columns per atom
    static constexpr int RB = ATOM * 2;              // bytes per row
    static constexpr int NA = D / ATOM;
    static constexpr int SWIZZLE = D >= 64 ? 1 : 2;  // 128 B : 64 B
    static constexpr int QROWS = 64 * NWG;
    static constexpr int Q_BYTES = QROWS * D * 2;
    static constexpr int KV_BYTES = BKV * D * 2;     // one tile
    static constexpr int STAGE_BYTES = 2 * KV_BYTES;
    static constexpr int BAR_OFF = Q_BYTES + kStages * STAGE_BYTES;
    // with the slack that aligns the base and 64 bytes of barriers
    static constexpr int BYTES = 1024 + BAR_OFF + 64;
};

// The producer warp's copy of a tile where no tensor map can be built:
// rows [0, rows) into the column atoms of tile_rows rows at dst (a
// multiple of 1,024 bytes from the aligned base), swizzled as TMA lands
// them (byte offset o within an atom goes to o ^ ((o >> 3) & 0x70) at a
// 128-byte swizzle, & 0x30 at 64); row r from src + r * stride, with rows
// >= valid and columns >= d as zeros.  2-byte loads: d may be odd.
template <int D, class L>
__device__ __forceinline__ void load_tile(uint8_t* dst, int tile_rows,
                                          const __nv_bfloat16* src,
                                          long long stride, int rows,
                                          int valid, int d, int lane) {
    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
    constexpr uint32_t kMask = L::SWIZZLE == 1 ? 0x70 : 0x30;
    for (int e = lane; e < rows * D; e += 32) {
        const int r = e / D, c = e - r * D;
        const uint16_t x = (r < valid && c < d) ? s16[r * stride + c] : 0;
        const int a = c / L::ATOM;
        uint32_t off = r * L::RB + (c - a * L::ATOM) * 2;
        off ^= (off >> 3) & kMask;
        *reinterpret_cast<uint16_t*>(dst + a * tile_rows * L::RB + off) = x;
    }
}

template <int D, int BKV, int NWG, bool GENERAL>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv,
                  const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                  int K, int d, int bq, float scale, int causal, int window,
                  float softcap, int q_offset, int tma) {
    using L = Bf16Layout<D, BKV, NWG>;
    constexpr int RB = L::RB;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* Qs = base;
    uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
    uint64_t* empty = full + kStages;
    uint64_t* qbar = empty + kStages;

    const int tid = threadIdx.x;
    const int qblk = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int q0 = qblk * bq, h = blockIdx.y, b = blockIdx.z;
    const int qrows = GENERAL ? min(bq, Sq - q0) : bq;   // rows below Sq
    const int kh = h / (H / K);
    int kb_lo, kb_hi;
    kv_range(q0 + q_offset, q0 + qrows - 1 + q_offset, (Skv + BKV - 1) / BKV,
             BKV, causal, window, kb_lo, kb_hi);
    const int dd = GENERAL ? d : D;        // the real head dim
    // strides of the (B, S, heads, d) layout: one token of q / o, of k / v
    const long long q_tok = (long long)H * dd, kv_tok = (long long)K * dd;

    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * NWG);     // one arrival per warp
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // zero the rows of Q past tile_q that pad the last m64 tile (the
    // async proxy, wgmma, reads them)
    if (bq < L::QROWS) {
        const int units = (L::QROWS - bq) * RB / 16;   // per atom
        for (int e = tid; e < L::NA * units; e += blockDim.x) {
            const int a = e / units, u = e - a * units;
            *reinterpret_cast<uint4*>(Qs + a * L::QROWS * RB + bq * RB
                                      + 16 * u) = make_uint4(0, 0, 0, 0);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= 128 * NWG) {
        // ---- producer warp: lane 0 starts every TMA load, or (general
        // body without a tensor map) the whole warp copies the tiles
        const int lane = tid & 31;
        if (!GENERAL || tma) {
            if (lane != 0) return;
            mbar_expect_tx(qbar, static_cast<uint32_t>(bq) * D * 2);
            for (int a = 0; a < L::NA; ++a)
                tma_load(Qs + a * L::QROWS * RB, &tmq, a * L::ATOM, h, q0, b,
                         qbar);
            for (int i = 0, kbi = kb_lo; kbi < kb_hi; ++i, ++kbi) {
                const int s = i % kStages;
                // the stage's last use released by every consumer warp
                if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
                mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
                uint8_t* Kt = base + L::Q_BYTES + s * L::STAGE_BYTES;
                uint8_t* Vt = Kt + L::KV_BYTES;
                for (int a = 0; a < L::NA; ++a) {
                    tma_load(Kt + a * BKV * RB, &tmk, a * L::ATOM, kh,
                             kbi * BKV, b, &full[s]);
                    tma_load(Vt + a * BKV * RB, &tmv, a * L::ATOM, kh,
                             kbi * BKV, b, &full[s]);
                }
            }
        } else {
            load_tile<D, L>(Qs, L::QROWS, q + ((long long)b * Sq + q0) * q_tok
                            + (long long)h * d, q_tok, bq, qrows, d, lane);
            publish(qbar, lane);
            for (int i = 0, kbi = kb_lo; kbi < kb_hi; ++i, ++kbi) {
                const int s = i % kStages;
                if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
                uint8_t* Kt = base + L::Q_BYTES + s * L::STAGE_BYTES;
                const long long off = ((long long)b * Skv + kbi * BKV) * kv_tok
                                      + (long long)kh * d;
                const int valid = min(BKV, Skv - kbi * BKV);
                load_tile<D, L>(Kt, BKV, k + off, kv_tok, BKV, valid, d, lane);
                load_tile<D, L>(Kt + L::KV_BYTES, BKV, v + off, kv_tok, BKV,
                                valid, d, lane);
                publish(&full[s], lane);
            }
        }
        return;
    }

    // ---- consumer warpgroups: wg owns query rows [64 wg, 64 wg + 64)
    const int wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 64 * wg + 16 * wi;                // the warp's first row
    const int pos0 = q0 + r0 + g + q_offset;         // position of row g
    const int wg_lo = q0 + 64 * wg + q_offset;
    const int wg_hi = q0 + min(64 * wg + 63, qrows - 1) + q_offset;
    float oacc[D / 2], sacc[BKV / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sacc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    mbar_wait(qbar, 0);
    for (int i = 0, kbi = kb_lo; kbi < kb_hi; ++i, ++kbi) {
        const int s = i % kStages;
        mbar_wait(&full[s], (i / kStages) & 1);
        const int k0 = kbi * BKV;
        const BlockMask bm(wg_lo, wg_hi, k0, BKV, Skv, causal, window);
        if (!bm.dead) {
            const uint8_t* Kt = base + L::Q_BYTES + s * L::STAGE_BYTES;
            const uint8_t* Vt = Kt + L::KV_BYTES;
            // S = Q . K^T, k16 steps along d: atom, then 32 bytes in it
            fence_regs(sacc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int a = 16 * kk / L::ATOM, off = 16 * kk % L::ATOM * 2;
                const uint64_t da = make_desc(
                    Qs + a * L::QROWS * RB + 64 * wg * RB + off, 16, 8 * RB,
                    L::SWIZZLE);
                const uint64_t db = make_desc(Kt + a * BKV * RB + off, 16,
                                              8 * RB, L::SWIZZLE);
                Wgmma<BKV>::ss(sacc, da, db, kk > 0);
            }
            wgmma_commit_and_wait();
            fence_regs(sacc);

            float corr[2];
            online_softmax<BKV / 8, true, GENERAL>(
                sacc, scale, softcap, !bm.full, pos0, k0 + 2 * t, Skv, causal,
                window, m, l, corr);
            // P in bf16 as the A fragments of O += P . V: k16 step kk
            // takes S's 8-column tiles 2 kk and 2 kk + 1
            uint32_t pa[BKV / 16][4];
#pragma unroll
            for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                        sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
                    pa[kk][r] = *reinterpret_cast<const uint32_t*>(&v2);
                }
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                oacc[4 * j + 0] *= corr[0];
                oacc[4 * j + 1] *= corr[0];
                oacc[4 * j + 2] *= corr[1];
                oacc[4 * j + 3] *= corr[1];
            }
            fence_regs(oacc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BKV / 16; ++kk)
                Wgmma<D>::rs(oacc, pa[kk],
                             make_desc(Vt + 16 * kk * RB, BKV * RB, 8 * RB,
                                       L::SWIZZLE));
            wgmma_commit_and_wait();
            fence_regs(oacc);
        }
        if (lane == 0) mbar_arrive(&empty[s]);
    }

    const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
    __nv_bfloat16* ob = o + ((long long)b * Sq + q0) * q_tok
                        + (long long)h * dd;
    const int row = r0 + g;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        if constexpr (GENERAL) {
            if (row < qrows)
                store_pair(ob + row * q_tok, 8 * j + 2 * t, d,
                           oacc[4 * j] / l0, oacc[4 * j + 1] / l0);
            if (row + 8 < qrows)
                store_pair(ob + (row + 8) * q_tok, 8 * j + 2 * t, d,
                           oacc[4 * j + 2] / l1, oacc[4 * j + 3] / l1);
        } else {
            if (row < bq)
                *reinterpret_cast<__nv_bfloat162*>(ob + row * q_tok + 8 * j
                                                   + 2 * t) =
                    __floats2bfloat162_rn(oacc[4 * j] / l0,
                                          oacc[4 * j + 1] / l0);
            if (row + 8 < bq)
                *reinterpret_cast<__nv_bfloat162*>(ob + (row + 8) * q_tok
                                                   + 8 * j + 2 * t) =
                    __floats2bfloat162_rn(oacc[4 * j + 2] / l1,
                                          oacc[4 * j + 3] / l1);
        }
    }
}

// ------------------------------------------------------------ launches
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point
// query (no -lcuda)
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A map over a bf16 (B, S, heads, d) tensor, dims innermost first,
// whose boxes are (atom, 1, box_rows, 1): box_rows tokens of one head
// and batch, atom columns of d, swizzled as wgmma reads them.  What a
// box holds past d or past S reads as zeros.  Needs d % 8 == 0 (16-byte
// strides) and a 16-byte-aligned ptr; false where it cannot be built.
bool encode_map(CUtensorMap* map, const void* ptr, int d, int heads,
                int S, int B, int atom, int box_rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t row = static_cast<cuuint64_t>(d) * 2;
    const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(atom), 1,
                               static_cast<cuuint32_t>(box_rows), 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
              const_cast<void*>(ptr), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE,
              atom == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// raise the kernel's dynamic shared memory limit to bytes, once
template <class Kernel>
cudaError_t opt_in(Kernel kern, long long bytes, long long& opted) {
    if (bytes <= opted) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err == cudaSuccess) opted = bytes;
    return err;
}

struct Args {
    const void *q, *k, *v;
    void* o;
    int B, Sq, Skv, H, K, d, bq, causal, window;
    float softcap;
    int q_offset;
    float scale;
    bool tma;
    cudaStream_t stream;
};

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int D, int BKV, bool GENERAL>
int launch_f32(const Args& a) {
    auto kern = flash_f32_kernel<D, BKV, GENERAL>;
    static long long opted = 48 * 1024;   // per instantiation
    const long long smem = f32_smem_floats(D, a.bq, BKV) * 4;
    const cudaError_t err = opt_in(kern, smem, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec = a.d % 4 == 0 && aligned16(a.q) && aligned16(a.k)
                     && aligned16(a.v);
    kern<<<dim3((a.Sq + a.bq - 1) / a.bq, a.H, a.B), 2 * a.bq, smem,
           a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o), a.Sq,
        a.Skv, a.H, a.K, a.d, a.bq, a.scale, a.causal, a.window, a.softcap,
        a.q_offset, vec ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}

template <int D, int BKV, int NWG, bool GENERAL>
int launch_bf16(const Args& a) {
    using L = Bf16Layout<D, BKV, NWG>;
    CUtensorMap tq{}, tk{}, tv{};
    if (a.tma
        && !(encode_map(&tq, a.q, a.d, a.H, a.Sq, a.B, L::ATOM, a.bq)
             && encode_map(&tk, a.k, a.d, a.K, a.Skv, a.B, L::ATOM, BKV)
             && encode_map(&tv, a.v, a.d, a.K, a.Skv, a.B, L::ATOM, BKV)))
        return static_cast<int>(cudaErrorInvalidValue);
    auto kern = flash_bf16_kernel<D, BKV, NWG, GENERAL>;
    static long long opted = 48 * 1024;
    const cudaError_t err = opt_in(kern, L::BYTES, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3((a.Sq + a.bq - 1) / a.bq, a.H, a.B), 128 * NWG + 32,
           L::BYTES, a.stream>>>(
        tq, tk, tv, static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<__nv_bfloat16*>(a.o), a.Sq, a.Skv, a.H, a.K, a.d, a.bq,
        a.scale, a.causal, a.window, a.softcap, a.q_offset, a.tma ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}

// The instantiated bodies.  Exact (whole tiles of both sequences, d ==
// D, 16-byte aligned tensors, in bf16 K/V by TMA): the (D, tile_kv)
// pairs whose staging can fit the card at some tile_q (f32: D 128 up to
// tile_kv 64, D 256 up to 32; bf16: D 256 up to 64).  General (any
// shape): tile_kv 16 and, in bf16, one warpgroup -- the only bodies with
// the zero-filling copies and the per-key check against Skv, which
// measured up to 1.9x slower on an H100 (gemma layer, fleet DSE) when
// every body carried them; kept few for the build's sake.  The wrapper's
// flash_plan chooses the body and whether TMA runs; this only refuses a
// choice the bodies cannot take.
template <int D>
int dispatch(const Args& a, int bf16, int bkv, int general) {
    const bool whole = a.d == D && a.Sq % a.bq == 0 && a.Skv % bkv == 0
                       && aligned16(a.q) && aligned16(a.k)
                       && aligned16(a.v) && aligned16(a.o);
    if (general) {
        if (bkv != 16 || (bf16 && a.bq > 64))
            return static_cast<int>(cudaErrorInvalidValue);
        return bf16 ? launch_bf16<D, 16, 1, true>(a)
                    : launch_f32<D, 16, true>(a);
    }
    if (!whole || (bf16 && !a.tma))
        return static_cast<int>(cudaErrorInvalidValue);
    if (bf16) {
        // D 256 takes one warpgroup (tile_q <= 64): its 128 registers
        // of O a thread do not fit the 224 that 288 threads leave
        const int nwg = (a.bq + 63) / 64;
        if (D == 256 && nwg > 1)
            return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_BF16(BKV)                                                  \
    if constexpr (D == 256) return launch_bf16<D, BKV, 1, false>(a);     \
    else return nwg == 1 ? launch_bf16<D, BKV, 1, false>(a)             \
                         : launch_bf16<D, BKV, 2, false>(a)
        switch (bkv) {
            case 16: FLASH_BF16(16);
            case 32: FLASH_BF16(32);
            case 64: FLASH_BF16(64);
            case 128:
                if constexpr (D != 256) { FLASH_BF16(128); }
                break;
        }
#undef FLASH_BF16
    } else {
        switch (bkv) {
            case 16: return launch_f32<D, 16, false>(a);
            case 32: return launch_f32<D, 32, false>(a);
            case 64:
                if constexpr (D <= 128) return launch_f32<D, 64, false>(a);
                break;
            case 128:
                if constexpr (D <= 64) return launch_f32<D, 128, false>(a);
                break;
        }
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, Sq, H, d); k, v: (B, Skv, K, d); o: (B, Sq, H, d); all
// contiguous, float32 (bf16 == 0) or bfloat16 (bf16 == 1).  D is the
// native head dim the call runs at (32, 64, 128 or 256, d <= D), tile_q
// the query rows a CTA takes (a multiple of 16 up to 128; 64 in bf16 at
// D 256), tile_kv the KV rows of a step (16, 32, 64 or 128), general
// the body (0: the exact one, which needs whole tiles, d == D and
// 16-byte aligned tensors) and tma whether bf16 K/V come by TMA (needs
// d % 8 == 0 and 16-byte aligned tensors); H % K == 0 and the staging
// within the opt-in shared memory.  The Python wrapper's flash_plan
// picks them all; a choice the bodies cannot take is refused.
KERNEL_EXPORT int flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int K, int d, int D,
                                      int bf16, int tile_q, int tile_kv,
                                      int general, int tma, int causal,
                                      int window, float softcap,
                                      int q_offset, float scale,
                                      void* stream) {
    if (tile_q % 16 || tile_q < 16 || tile_q > 128 || d < 1 || d > D
        || Sq < 1 || Skv < 1 || K < 1 || H % K
        || (tma && (!bf16 || d % 8 || !aligned16(q) || !aligned16(k)
                    || !aligned16(v))))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, k, v, o, B, Sq, Skv, H, K, d, tile_q, causal, window,
                 softcap, q_offset, scale, tma != 0,
                 static_cast<cudaStream_t>(stream)};
    switch (D) {
        case 32: return dispatch<32>(a, bf16, tile_kv, general);
        case 64: return dispatch<64>(a, bf16, tile_kv, general);
        case 128: return dispatch<128>(a, bf16, tile_kv, general);
        case 256: return dispatch<256>(a, bf16, tile_kv, general);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
