// The Mamba2 mixer's epilogue, forward and backward (sm_90a): from the
// chunked SSD's float32 output y to the input of the mixer's out_proj,
//
//   v = y + D_h x,   g = v silu(z),   r = rsqrt(mean(g^2) + eps),
//   out = g r (1 + scale),
//
// one token at a time, a row of W = d_inner = H P features (x the conv's
// output per head, z the gate, D per head, scale per feature).  Replaces
// no TPU kernel: the JAX package leaves these lines of models/ssm.py
// (mamba_sequence) to XLA, which fuses them.  Run eagerly they are a chain
// of float32 and bf16 elementwise kernels, two roundings to bf16 in the
// middle, and twice as many again in autograd's backward.
// kernels/mamba_gate_norm/grad.py wraps the two entry points in one
// torch.autograd.Function.
//
// Bound on an H100 SXM (published peaks, 700 W limit): bytes.  A feature
// is a few dozen flops against 10 bytes forward (y f32, x, z in, out
// written, in bf16) and 18 backward (y, x, z, dout in; dy f32, dx, dz out):
// at 3.35 TB/s one mamba2-780m layer (40,960 rows of 3,072) needs 0.376 ms
// forward and 0.676 ms backward, one zamba2-2.7b layer (32,768 rows of
// 5,120) 0.501 and 0.902 ms.  So every byte is moved once and nothing
// else: the whole chain lives in registers, in float32, and rounds once,
// at each output.  A thread moves 8 features at a time, as 16-byte loads
// and stores (two for float32); x and z are read in place through their
// row strides (views of the conv's output and of in_proj's); outputs are
// stored as streaming (evict-first) writes.  A row's sum of squares goes
// through a warp butterfly, then through shared memory across the row's
// warps, in a fixed order.  Threads per row are the warps that give each
// thread at most kFwdVecs (kBwdVecs) vectors of the row, rows share a CTA
// up to kCtaThreads threads: 3 warps a row and 2 rows a CTA forward at
// d_inner 3,072, 5 warps forward at 5,120, 6 and 10 warps backward.  The
// forward holds g (32 floats) across the row's sum; 64 registers, no
// spills.
//
// Backward, per row, from the saved r: v, g and n = g r again; dn = dout
// (1 + scale); c = mean(dn n) (the row's second sum); dg = r (dn - n c);
// dv = dg silu(z), written as dy (float32, the SSD backward's input);
// dx = D_h dv; dz = dg v silu'(z).  What bounds it is how many rows are in
// flight on an SM while each waits at its sum: holding a row's inputs
// across the barrier took 126 registers a thread, one CTA an SM at
// zamba2's width, 54% of the bound on an H100.  So a thread reads its
// vectors twice, for the sum and again for the gradients, the second time
// from the L1 (the CTA read them a moment before): 84 registers, 2-4 CTAs
// an SM, 73-77% of the bound.  The parameters' gradients, dscale = sum
// over rows of dout n and dD_h = sum of dv x over the head's features,
// are summed per slot (a row of a CTA walks rows slot, slot + slots, ...)
// into a scratch of partials, which a second kernel sums in slot order.
// No float atomics: one input gives the same bits in every run.
#include <cuda_bf16.h>

#include <cstdint>

#include "kernel_export.cuh"

namespace {

constexpr int kVec = 8;            // features a thread moves at once
constexpr int kFwdVecs = 4;        // vectors of a row a forward thread holds
constexpr int kBwdVecs = 2;        // and a backward thread
constexpr int kCtaThreads = 256;   // rows share a CTA up to this many threads
constexpr int kMaxThreads = 512;   // a CTA's threads, at most
constexpr int kSumCols = 32;       // the sum pass: columns a CTA,
constexpr int kSumGroups = 8;      // groups of slots (and heads) a CTA

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float sigmoid(float z) {
    return 1.f / (1.f + expf(-z));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
           | (static_cast<uint32_t>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
              << 16);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// kVec features of a row as 16-byte words, read and written as such, and
// their float32 values
template <typename T>
struct Pack;

template <>
struct Pack<float> {
    float4 lo, hi;
    __device__ void load(const float* p) {
        lo = __ldg(reinterpret_cast<const float4*>(p));
        hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    }
    __device__ void store(float* p) const {
        __stcs(reinterpret_cast<float4*>(p), lo);
        __stcs(reinterpret_cast<float4*>(p) + 1, hi);
    }
    __device__ void get(float (&f)[kVec]) const {
        f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
        f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
    }
    __device__ void set(const float (&f)[kVec]) {
        lo = make_float4(f[0], f[1], f[2], f[3]);
        hi = make_float4(f[4], f[5], f[6], f[7]);
    }
};

template <>
struct Pack<__nv_bfloat16> {
    uint4 w;
    __device__ void load(const __nv_bfloat16* p) {
        w = __ldg(reinterpret_cast<const uint4*>(p));
    }
    __device__ void store(__nv_bfloat16* p) const {
        __stcs(reinterpret_cast<uint4*>(p), w);
    }
    __device__ void get(float (&f)[kVec]) const {
        const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = __uint_as_float(u[i] << 16);
            f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
        }
    }
    __device__ void set(const float (&f)[kVec]) {
        w = make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                       bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
    }
};

// a (Bz, S, W) operand read in place: row r = b S + s at p + b sb + s ss
// (strides in elements, features contiguous)
template <typename T>
struct Rows {
    const T* p;
    long long sb, ss;
    __device__ const T* row(long long r, int S) const {
        const long long b = r / S;
        return p + b * sb + (r - b * S) * ss;
    }
};

// the sum of v over the threads of this thread's row (threadIdx.y), the
// same bits in each: every warp's butterfly, then the warps' sums in warp
// order through part (a slot per warp of the CTA)
__device__ float row_sum(float v, float* part) {
    const int wpr = blockDim.x / 32;
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) part[threadIdx.y * wpr + threadIdx.x / 32] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < wpr; ++w) s += part[threadIdx.y * wpr + w];
    return s;
}

// ---------------------------------------------------------------- forward
// a row per threadIdx.y, blockDim.x threads a row, each holding g of its
// vectors threadIdx.x + i blockDim.x (i < kFwdVecs) between the two sweeps
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gate_norm_fwd_kernel(Rows<float> y, Rows<T> x, Rows<T> z,
                     const float* __restrict__ D,
                     const T* __restrict__ scale, T* __restrict__ out,
                     float* __restrict__ rstd, long long rows, int S, int W,
                     int P, float eps) {
    __shared__ float part[kMaxThreads / 32];
    const int tpr = blockDim.x, vecs = W / kVec;
    const long long r = static_cast<long long>(blockIdx.x) * blockDim.y
                        + threadIdx.y;
    const bool live = r < rows;
    float g[kFwdVecs][kVec];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kFwdVecs; ++i) {
        const int c = threadIdx.x + i * tpr;
        if (live && c < vecs) {
            const int col = c * kVec;
            Pack<float> yp;
            Pack<T> xp, zp;
            yp.load(y.row(r, S) + col);
            xp.load(x.row(r, S) + col);
            zp.load(z.row(r, S) + col);
            float yv[kVec], xv[kVec], zv[kVec];
            yp.get(yv);
            xp.get(xv);
            zp.get(zv);
            const float d = __ldg(D + col / P);
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
                g[i][e] = (yv[e] + d * xv[e]) * (zv[e] * sigmoid(zv[e]));
                ss += g[i][e] * g[i][e];
            }
        } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) g[i][e] = 0.f;
        }
    }
    const float rr = rsqrtf(row_sum(ss, part) / W + eps);
    if (!live) return;
    if (rstd != nullptr && threadIdx.x == 0) rstd[r] = rr;
    T* o = out + r * W;
#pragma unroll
    for (int i = 0; i < kFwdVecs; ++i) {
        const int c = threadIdx.x + i * tpr;
        if (c < vecs) {
            const int col = c * kVec;
            Pack<T> sp, op;
            sp.load(scale + col);
            float sv[kVec], ov[kVec];
            sp.get(sv);
#pragma unroll
            for (int e = 0; e < kVec; ++e) ov[e] = g[i][e] * rr * (1.f + sv[e]);
            op.set(ov);
            op.store(o + col);
        }
    }
}

// --------------------------------------------------------------- backward
// the backward's inputs at features col .. col + kVec of row r, as float32
template <typename T>
struct BwdInputs {
    float y[kVec], x[kVec], z[kVec], dout[kVec], scale[kVec];
    __device__ BwdInputs(const Rows<float>& yr, const Rows<T>& xr,
                         const Rows<T>& zr, const T* dout_p,
                         const T* scale_p, long long r, int S, int W,
                         int col) {
        Pack<float> yp;
        Pack<T> xp, zp, op, sp;
        yp.load(yr.row(r, S) + col);
        xp.load(xr.row(r, S) + col);
        zp.load(zr.row(r, S) + col);
        op.load(dout_p + r * W + col);
        sp.load(scale_p + col);
        yp.get(y);
        xp.get(x);
        zp.get(z);
        op.get(dout);
        sp.get(scale);
    }
};

// blockDim.y slots a CTA, blockDim.x threads a slot's row; the slot walks
// rows slot, slot + slots, ... (the same count for every row of the CTA,
// so all reach each barrier), each thread reading its vectors
// threadIdx.x + i blockDim.x (i < kBwdVecs) once for the row's sum and
// once for the gradients, and keeping their sums of dout n and of dv x;
// then writes those to its rows of part_scale (slots, W) and part_D
// (slots, W / kVec)
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gate_norm_bwd_kernel(Rows<float> y, Rows<T> x, Rows<T> z,
                     const T* __restrict__ dout,
                     const float* __restrict__ D,
                     const T* __restrict__ scale,
                     const float* __restrict__ rstd, float* __restrict__ dy,
                     T* __restrict__ dx, T* __restrict__ dz,
                     float* __restrict__ part_scale,
                     float* __restrict__ part_D, long long rows, int S,
                     int W, int P) {
    __shared__ float part[2][kMaxThreads / 32];
    const int tpr = blockDim.x, vecs = W / kVec;
    const long long first = static_cast<long long>(blockIdx.x) * blockDim.y;
    const long long slots = static_cast<long long>(gridDim.x) * blockDim.y;
    float acc_s[kBwdVecs][kVec], acc_d[kBwdVecs];
#pragma unroll
    for (int i = 0; i < kBwdVecs; ++i) {
        acc_d[i] = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc_s[i][e] = 0.f;
    }
    int buf = 0;
    for (long long base = first; base < rows; base += slots, buf ^= 1) {
        const long long r = base + threadIdx.y;
        const bool live = r < rows;
        const float rr = live ? __ldg(rstd + r) : 0.f;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kBwdVecs; ++i) {
            const int c = threadIdx.x + i * tpr;
            if (live && c < vecs) {
                const BwdInputs<T> in(y, x, z, dout, scale, r, S, W,
                                      c * kVec);
                const float d = __ldg(D + c * kVec / P);
#pragma unroll
                for (int e = 0; e < kVec; ++e) {
                    const float v = in.y[e] + d * in.x[e];
                    const float n = v * (in.z[e] * sigmoid(in.z[e])) * rr;
                    dot += in.dout[e] * (1.f + in.scale[e]) * n;
                    acc_s[i][e] += in.dout[e] * n;
                }
            }
        }
        const float cm = row_sum(dot, part[buf]) / W;
        if (!live) continue;
#pragma unroll
        for (int i = 0; i < kBwdVecs; ++i) {
            const int c = threadIdx.x + i * tpr;
            if (c < vecs) {
                // the same reads again: the L1 serves them
                const int col = c * kVec;
                const BwdInputs<T> in(y, x, z, dout, scale, r, S, W, col);
                const float d = __ldg(D + col / P);
                float dyv[kVec], dxv[kVec], dzv[kVec];
#pragma unroll
                for (int e = 0; e < kVec; ++e) {
                    const float sg = sigmoid(in.z[e]);
                    const float v = in.y[e] + d * in.x[e];
                    const float n = v * (in.z[e] * sg) * rr;
                    const float dg = rr * (in.dout[e] * (1.f + in.scale[e])
                                           - n * cm);
                    const float dv = dg * (in.z[e] * sg);
                    dyv[e] = dv;
                    dxv[e] = d * dv;
                    dzv[e] = dg * v * (sg * (1.f + in.z[e] * (1.f - sg)));
                    acc_d[i] += dv * in.x[e];
                }
                Pack<float> yo;
                Pack<T> xo, zo;
                yo.set(dyv);
                xo.set(dxv);
                zo.set(dzv);
                yo.store(dy + r * W + col);
                xo.store(dx + r * W + col);
                zo.store(dz + r * W + col);
            }
        }
    }
    const long long slot = first + threadIdx.y;
#pragma unroll
    for (int i = 0; i < kBwdVecs; ++i) {
        const int c = threadIdx.x + i * tpr;
        if (c < vecs) {
            Pack<float> ps;
            ps.set(acc_s[i]);
            ps.store(part_scale + slot * W + c * kVec);
            part_D[slot * vecs + c] = acc_d[i];
        }
    }
}

// dscale (W) and dD (H) from the partials of `slots` slots, in a fixed
// order.  CTAs below ceil(W / kSumCols): kSumCols columns by kSumGroups
// groups of slots, each thread summing slots g, g + kSumGroups, ... of its
// column, then the groups in order.  The rest: a warp a head, its lanes
// over the head's (slot, vector) partials, then a butterfly.
template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumGroups)
gate_norm_sum_kernel(const float* __restrict__ part_scale,
                     const float* __restrict__ part_D, T* __restrict__ dscale,
                     float* __restrict__ dD, int slots, int W, int H, int P) {
    __shared__ float acc[kSumGroups][kSumCols];
    const int col_ctas = (W + kSumCols - 1) / kSumCols;
    const int vecs = W / kVec;
    if (static_cast<int>(blockIdx.x) < col_ctas) {
        const int cx = threadIdx.x % kSumCols, g = threadIdx.x / kSumCols;
        const int col = blockIdx.x * kSumCols + cx;
        float s = 0.f;
        if (col < W)
            for (int k = g; k < slots; k += kSumGroups)
                s += part_scale[static_cast<long long>(k) * W + col];
        acc[g][cx] = s;
        __syncthreads();
        if (g == 0 && col < W) {
            float t = 0.f;
            for (int j = 0; j < kSumGroups; ++j) t += acc[j][cx];
            put(dscale + col, t);
        }
        return;
    }
    const int h = (blockIdx.x - col_ctas) * kSumGroups + threadIdx.x / 32;
    if (h >= H) return;
    const int lane = threadIdx.x & 31, vph = P / kVec;
    float s = 0.f;
    for (int e = lane; e < slots * vph; e += 32) {
        const int k = e / vph;
        s += part_D[static_cast<long long>(k) * vecs + h * vph + (e - k * vph)];
    }
    s = warp_sum(s);
    if (lane == 0) dD[h] = s;
}

// threads a row (whole warps) and rows a CTA at width W, for threads that
// hold at most `per_thread` vectors each; {0, 0} beyond kMaxThreads
struct Geometry {
    int tpr, rpc;
    Geometry(int W, int per_thread) {
        const int per_warp = 32 * per_thread;
        tpr = (W / kVec + per_warp - 1) / per_warp * 32;
        rpc = tpr > kCtaThreads ? 1 : kCtaThreads / tpr;
        if (tpr > kMaxThreads) tpr = rpc = 0;
    }
};

bool aligned(const void* p, long long sb, long long ss, int esize) {
    return ((reinterpret_cast<uintptr_t>(p)
             | static_cast<uintptr_t>(sb * esize)
             | static_cast<uintptr_t>(ss * esize)) & 15) == 0;
}

// the shapes and layouts both entry points take
bool valid(const float* y, long long y_sb, long long y_ss, const void* x,
           long long x_sb, long long x_ss, const void* z, long long z_sb,
           long long z_ss, const void* scale, int Bz, int S, int H, int P,
           int esize) {
    return Bz > 0 && S > 0 && H > 0 && P > 0 && P % kVec == 0
           && aligned(y, y_sb, y_ss, 4) && aligned(x, x_sb, x_ss, esize)
           && aligned(z, z_sb, z_ss, esize) && aligned(scale, 0, 0, esize);
}

// the backward's CTAs resident on the card at once at width W (the most
// it launches: each CTA's slots keep their partials to the end), or the
// CUDA error of the query
template <typename T>
cudaError_t resident_ctas(const Geometry& gm, long long* ctas) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, gate_norm_bwd_kernel<T>, gm.tpr * gm.rpc, 0);
    *ctas = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
    return err;
}

// a slot's partials: the sums of dout n (W) and of dv x per vector (W / 8)
long long slot_floats(int W) { return W + W / kVec; }

template <typename T>
int launch_fwd(const float* y, long long y_sb, long long y_ss, const void* x,
               long long x_sb, long long x_ss, const void* z, long long z_sb,
               long long z_ss, const float* D, const void* scale, void* out,
               float* rstd, int Bz, int S, int H, int P, float eps,
               cudaStream_t stream) {
    const int W = H * P;
    const Geometry gm(W, kFwdVecs);
    if (gm.tpr == 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long rows = static_cast<long long>(Bz) * S;
    const long long ctas = (rows + gm.rpc - 1) / gm.rpc;
    if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    gate_norm_fwd_kernel<T><<<static_cast<unsigned>(ctas),
                              dim3(gm.tpr, gm.rpc), 0, stream>>>(
        Rows<float>{y, y_sb, y_ss},
        Rows<T>{static_cast<const T*>(x), x_sb, x_ss},
        Rows<T>{static_cast<const T*>(z), z_sb, z_ss}, D,
        static_cast<const T*>(scale), static_cast<T*>(out), rstd, rows, S, W,
        P, eps);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const float* y, long long y_sb, long long y_ss, const void* x,
               long long x_sb, long long x_ss, const void* z, long long z_sb,
               long long z_ss, const void* dout, const float* D,
               const void* scale, const float* rstd, float* dy, void* dx,
               void* dz, float* dD, void* dscale, float* scratch,
               long long scratch_floats, int Bz, int S, int H, int P,
               cudaStream_t stream) {
    const int W = H * P;
    const Geometry gm(W, kBwdVecs);
    if (gm.tpr == 0) return static_cast<int>(cudaErrorInvalidValue);
    long long resident = 0;
    cudaError_t err = resident_ctas<T>(gm, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long rows = static_cast<long long>(Bz) * S;
    long long ctas = (rows + gm.rpc - 1) / gm.rpc;
    if (ctas > resident) ctas = resident;
    if (ctas > scratch_floats / (gm.rpc * slot_floats(W)))
        ctas = scratch_floats / (gm.rpc * slot_floats(W));
    if (ctas <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int slots = static_cast<int>(ctas) * gm.rpc;
    float* part_scale = scratch;
    float* part_D = scratch + static_cast<long long>(slots) * W;
    gate_norm_bwd_kernel<T><<<static_cast<unsigned>(ctas),
                              dim3(gm.tpr, gm.rpc), 0, stream>>>(
        Rows<float>{y, y_sb, y_ss},
        Rows<T>{static_cast<const T*>(x), x_sb, x_ss},
        Rows<T>{static_cast<const T*>(z), z_sb, z_ss},
        static_cast<const T*>(dout), D, static_cast<const T*>(scale), rstd,
        dy, static_cast<T*>(dx), static_cast<T*>(dz), part_scale, part_D,
        rows, S, W, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int sum_ctas = (W + kSumCols - 1) / kSumCols
                         + (H + kSumGroups - 1) / kSumGroups;
    gate_norm_sum_kernel<T><<<sum_ctas, kSumCols * kSumGroups, 0, stream>>>(
        part_scale, part_D, static_cast<T*>(dscale), dD, slots, W, H, P);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: (Bz, S, H, P) float32; x: (Bz, S, H, P) and z: (Bz, S, H P) in the
// model dtype (bf16 with bf16 set, else float32), each read at (b, s) from
// b * sb + s * ss elements (its features contiguous); D (H,) float32;
// scale (H P,) model dtype.  Writes out (Bz, S, H P) contiguous, model
// dtype, and, unless rstd is null, r (Bz S,) float32.  P % 8 == 0, every
// row start and scale 16-byte aligned, H P at most 8 kMaxThreads kFwdVecs.
KERNEL_EXPORT int mamba_gate_norm_fwd(const float* y, long long y_sb,
                                      long long y_ss, const void* x,
                                      long long x_sb, long long x_ss,
                                      const void* z, long long z_sb,
                                      long long z_ss, const float* D,
                                      const void* scale, void* out,
                                      float* rstd, int Bz, int S, int H,
                                      int P, float eps, int bf16,
                                      void* stream) {
    const int esize = bf16 ? 2 : 4;
    if (!valid(y, y_sb, y_ss, x, x_sb, x_ss, z, z_sb, z_ss, scale, Bz, S, H,
               P, esize))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16)
        return launch_fwd<__nv_bfloat16>(y, y_sb, y_ss, x, x_sb, x_ss, z,
                                         z_sb, z_ss, D, scale, out, rstd, Bz,
                                         S, H, P, eps, s);
    return launch_fwd<float>(y, y_sb, y_ss, x, x_sb, x_ss, z, z_sb, z_ss, D,
                             scale, out, rstd, Bz, S, H, P, eps, s);
}

// The forward's inputs as it read them, its r, and dout (Bz, S, H P)
// contiguous in the model dtype (16-byte aligned) -> dy (Bz, S, H, P)
// float32, dx (Bz, S, H, P) and dz (Bz, S, H P) contiguous in the model
// dtype, dD (H,) float32, dscale (H P,) model dtype.  scratch: partials of
// scratch_floats floats, a slot per row of each CTA, (H P + H P / 8)
// floats a slot; the CTAs are the fewest of the rows' CTAs, those resident
// on the card at once and those the scratch holds, so
// mamba_gate_norm_bwd_scratch_floats floats never limit them.
KERNEL_EXPORT int mamba_gate_norm_bwd(const float* y, long long y_sb,
                                      long long y_ss, const void* x,
                                      long long x_sb, long long x_ss,
                                      const void* z, long long z_sb,
                                      long long z_ss, const void* dout,
                                      const float* D, const void* scale,
                                      const float* rstd, float* dy, void* dx,
                                      void* dz, float* dD, void* dscale,
                                      float* scratch,
                                      long long scratch_floats, int Bz,
                                      int S, int H, int P, int bf16,
                                      void* stream) {
    const int esize = bf16 ? 2 : 4;
    if (!valid(y, y_sb, y_ss, x, x_sb, x_ss, z, z_sb, z_ss, scale, Bz, S, H,
               P, esize)
        || !aligned(dout, 0, 0, esize))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16)
        return launch_bwd<__nv_bfloat16>(
            y, y_sb, y_ss, x, x_sb, x_ss, z, z_sb, z_ss, dout, D, scale,
            rstd, dy, dx, dz, dD, dscale, scratch, scratch_floats, Bz, S, H,
            P, s);
    return launch_bwd<float>(y, y_sb, y_ss, x, x_sb, x_ss, z, z_sb, z_ss,
                             dout, D, scale, rstd, dy, dx, dz, dD, dscale,
                             scratch, scratch_floats, Bz, S, H, P, s);
}

// The backward's scratch in floats at H heads of P features (bf16 set: in
// bf16, else float32) on the current device: the partials of every CTA
// resident at once.  0 for heads the kernels do not take (P % 8 != 0, or a
// row wider than one CTA holds: 8 kMaxThreads kBwdVecs features backward,
// twice that forward); minus the CUDA error where the query failed.
KERNEL_EXPORT long long mamba_gate_norm_bwd_scratch_floats(int H, int P,
                                                           int bf16) {
    if (H <= 0 || P <= 0 || P % kVec != 0) return 0;
    const int W = H * P;
    const Geometry gm(W, kBwdVecs);
    if (gm.tpr == 0 || Geometry(W, kFwdVecs).tpr == 0) return 0;
    long long ctas = 0;
    const cudaError_t err = bf16 ? resident_ctas<__nv_bfloat16>(gm, &ctas)
                                 : resident_ctas<float>(gm, &ctas);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    return ctas * gm.rpc * slot_floats(W);
}
