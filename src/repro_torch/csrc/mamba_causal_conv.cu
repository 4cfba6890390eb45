// The Mamba2 mixer's depthwise causal conv, forward and backward (sm_90a):
// over xbc (Bz, S, C), the columns of in_proj's output that hold x, B and C
// (C = d_inner + 2 N channels), with K taps w (K, C), a bias b (C) and the
// K - 1 rows before t = 0 taken from an incoming conv state (Bz, K - 1, C)
// or as zeros,
//
//   pre[t] = sum_k w[k] ext[t + k] + b,   y[t] = silu(pre[t]),
//
// ext = [state, xbc] along time.  Replaces no TPU kernel: the JAX package
// leaves these lines of models/ssm.py (_causal_conv) to XLA, which fuses
// them.  Run eagerly they are a cat of the zero pad, K strided multiplies
// and K + 1 adds over the whole tensor in bf16 (each partial sum rounded),
// and a SiLU, all again under remat and about twice as many in autograd's
// backward.  kernels/causal_conv/grad.py wraps the two entry points in one
// torch.autograd.Function.
//
// Bound on an H100 SXM (published peaks, 700 W limit): bytes.  A channel
// is 4 taps, a handful of flops against 4 bytes forward (x read, y written,
// in bf16) and 6 backward (x and dy read, dx written): at 3.35 TB/s one
// mamba2-780m layer (20 x 2048 rows of 3,328) needs 0.163 ms forward and
// 0.244 ms backward, one zamba2-2.7b layer (8 x 4096 rows of 5,248) 0.205
// and 0.308 ms.  So every byte is moved once and nothing else: the whole
// chain lives in registers, in float32, and rounds once, at each output.
//
// Forward: a thread owns kFwdVec channels (one 16-byte word of bf16) of
// kFwdRows time rows and walks them in order, keeping the inputs of the
// last K - 1 rows in registers: each input is read once, plus a halo of
// K - 1 rows a block, which its neighbour has just read (the L2 serves
// it).  Neighbouring threads own neighbouring channels of a row, so a
// warp reads 512 contiguous bytes a row.  What bounds the rate is the
// bytes in flight: rows loaded into registers ahead of their use took 140
// registers a thread and reached 55% of the bound.  So each thread keeps
// kFwdRing bytes of rows in flight in a ring of its own in shared memory,
// filled by cp.async (8 rows of bf16), and holds one row in registers.
// w and b stay in registers.  x is read in place through its batch and
// row strides (a column slice of in_proj's output).
//
// Backward, from the saved x, w, b, the state and the incoming dy: a warp
// owns 32 x kBwdVec channels of kBwdRows rows.  It recomputes pre in
// registers, forms g = dy silu'(pre), and writes dx[t] = sum_k w[k]
// g[t + K - 1 - k] once, with g's K - 1 rows past its block as the halo
// (recomputed from x and dy there), and the state's gradient from the
// first block; x and dy come through rings as the forward's x does.
// dw[k] = sum_t g[t] ext[t + k] and db = sum_t g[t] are
// summed per thread over its rows, then over the CTA's kBwdWarps warps in
// a fixed tree through shared memory, into one float32 partial per CTA
// row of the grid; a second kernel sums the partials in a fixed order.  No
// float atomics: one input gives the same bits in every run.
//
// K taps run as a conv of NW = 4 or 8 taps (the smallest that holds K)
// whose first NW - K taps are zero, so every register array has a size
// known at compile time.  Where C % 8 == 0 every operand is read and
// written in 8- and 16-byte words and must start (with each row) on the
// 16-byte grid; other widths take the same kernels element by element.
#include <cuda_bf16.h>

#include <cstdint>

#include "kernel_export.cuh"

namespace {

constexpr int kMaxTaps = 8;        // K, at most
constexpr int kFwdVec = 8;         // channels a forward thread owns
constexpr int kFwdRows = 64;       // time rows a forward thread walks
constexpr int kFwdThreads = 128;   // a forward CTA's threads
constexpr int kFwdRing = 128;      // bytes of x a forward thread has in flight
constexpr int kBwdVec = 4;         // channels a backward thread owns
constexpr int kBwdRows = 64;       // time rows a backward warp walks
constexpr int kBwdWarps = 8;       // warps (blocks of rows) a backward CTA
constexpr int kBwdRing = 64;       // bytes of x, and of dy, in flight a thread
constexpr int kSumCols = 32;       // the sum pass: columns a CTA,
constexpr int kSumGroups = 8;      // groups of partials a CTA

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
           | (static_cast<uint32_t>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
              << 16);
}

__device__ __forceinline__ float sigmoid(float p) {
    return 1.f / (1.f + expf(-p));
}

// CV channels of a row as loaded, and their float32 values: 32-bit words
// read as one 8- or 16-byte load (two for 32 bytes) where V, else element
// by element, the channels at or past the row's end (n of them are real)
// read as 0
template <typename T, int CV, bool V>
struct Raw;

template <typename T, int CV>
struct Raw<T, CV, true> {
    static constexpr int kWords = CV * static_cast<int>(sizeof(T)) / 4;
    static_assert(kWords == 2 || kWords % 4 == 0, "8 or 16k-byte words");
    uint32_t u[kWords];
    __device__ void load(const T* p, int) {
        if constexpr (kWords == 2) {
            const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
            u[0] = q.x;
            u[1] = q.y;
        } else {
#pragma unroll
            for (int i = 0; i < kWords / 4; ++i) {
                const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
                u[4 * i] = q.x;
                u[4 * i + 1] = q.y;
                u[4 * i + 2] = q.z;
                u[4 * i + 3] = q.w;
            }
        }
    }
    __device__ void get(float (&f)[CV]) const {
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
            if constexpr (sizeof(T) == 2) {
                f[2 * i] = __uint_as_float(u[i] << 16);
                f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
            } else {
                f[i] = __uint_as_float(u[i]);
            }
        }
    }
};

template <typename T, int CV>
struct Raw<T, CV, false> {
    float v[CV];
    __device__ void load(const T* p, int n) {
#pragma unroll
        for (int e = 0; e < CV; ++e) v[e] = e < n ? to_float(p[e]) : 0.f;
    }
    __device__ void get(float (&f)[CV]) const {
#pragma unroll
        for (int e = 0; e < CV; ++e) f[e] = v[e];
    }
};

// store CV channels (n of them real) as T, in words where V
template <typename T, int CV, bool V>
__device__ __forceinline__ void put(T* p, const float (&f)[CV], int n) {
    if constexpr (V) {
        constexpr int kWords = CV * static_cast<int>(sizeof(T)) / 4;
        uint32_t u[kWords];
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
            if constexpr (sizeof(T) == 2)
                u[i] = bf16x2(f[2 * i], f[2 * i + 1]);
            else
                u[i] = __float_as_uint(f[i]);
        }
        if constexpr (kWords == 2) {
            *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
        } else {
#pragma unroll
            for (int i = 0; i < kWords / 4; ++i)
                reinterpret_cast<uint4*>(p)[i] = make_uint4(
                    u[4 * i], u[4 * i + 1], u[4 * i + 2], u[4 * i + 3]);
        }
    } else {
#pragma unroll
        for (int e = 0; e < CV; ++e)
            if (e < n) p[e] = from_float<T>(f[e]);
    }
}

// a (Bz, S, C) operand read in place: row (b, t) at p + b sb + t ss
// (strides in elements, channels contiguous)
template <typename T>
struct Rows {
    const T* p;
    long long sb, ss;
    __device__ const T* row(int b, int t) const {
        return p + b * sb + static_cast<long long>(t) * ss;
    }
};

// the taps as a conv of NW taps: wv[NW - K + k] = w[k] at channels
// c0 .. c0 + n, the first NW - K taps 0
template <typename T, int NW, int CV, bool V>
__device__ void load_taps(const T* __restrict__ w, int K, int C, int c0,
                          int n, float (&wv)[NW][CV]) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        const int k = j - (NW - K);
        if (k >= 0) {
            Raw<T, CV, V> r;
            r.load(w + static_cast<long long>(k) * C + c0, n);
            r.get(wv[j]);
        } else {
#pragma unroll
            for (int e = 0; e < CV; ++e) wv[j][e] = 0.f;
        }
    }
}

// row t of ext = [state, x] for batch b: x's row where t >= 0, the state's
// row K - 1 + t where -(K - 1) <= t < 0 and a state is given, else 0
template <typename T, int CV, bool V>
__device__ void ext_row(const Rows<T>& x, const T* __restrict__ state,
                        int b, int t, int K, int C, int c0, int n,
                        float (&f)[CV]) {
    const T* p = nullptr;
    if (t >= 0)
        p = x.row(b, t) + c0;
    else if (state != nullptr && t >= -(K - 1))
        p = state + (static_cast<long long>(b) * (K - 1) + (K - 1 + t)) * C
            + c0;
    if (p != nullptr) {
        Raw<T, CV, V> r;
        r.load(p, n);
        r.get(f);
    } else {
#pragma unroll
        for (int e = 0; e < CV; ++e) f[e] = 0.f;
    }
}

// ------------------------------------------------------------ row streams
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (BYTES == 8) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                     :: "r"(d), "l"(src) : "memory");
    } else {
#pragma unroll
        for (int i = 0; i < BYTES / 16; ++i)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(d + 16 * i),
                         "l"(static_cast<const char*>(src) + 16 * i)
                         : "memory");
    }
}

template <bool V>
__device__ __forceinline__ void pipe_commit() {
    if constexpr (V) asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <bool V, int N>
__device__ __forceinline__ void pipe_wait() {
    if constexpr (V)
        asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The rows of one (Bz, S, C) operand that a thread reads in order, from
// row `first` up to `end`, CV channels from c0.  Where V, kept D rows
// ahead of the reader in the thread's ring of D slots in shared memory
// (slot d at ring + d step), filled by cp.async: the caller fetches row
// i + D into slot i % D once row i is read, commits once a row for all
// its streams, and waits for row i before reading it.  So D rows of each
// stream are in flight while the registers hold one.  Else each row is
// loaded when it is read.
template <typename T, int CV, bool V, int D>
struct Stream {
    static constexpr int kBytes = CV * static_cast<int>(sizeof(T));
    unsigned char* ring;
    int step;
    Rows<T> src;
    int b, c0, n, fetched, read_at, end;

    __device__ Stream(unsigned char* ring_, int step_, Rows<T> src_, int b_,
                      int c0_, int n_, int first, int end_)
        : ring(ring_), step(step_), src(src_), b(b_), c0(c0_), n(n_),
          fetched(first), read_at(first), end(end_) {}

    __device__ void fetch(int slot) {
        if constexpr (V) {
            if (fetched < end)
                cp_async<kBytes>(ring + slot * step,
                                 src.row(b, fetched) + c0);
        }
        ++fetched;
    }

    __device__ void read(int slot, float (&f)[CV]) {
        Raw<T, CV, V> r;
        if constexpr (V) {
            const uint32_t* p =
                reinterpret_cast<const uint32_t*>(ring + slot * step);
            if constexpr (Raw<T, CV, V>::kWords == 2) {
                const uint2 q = *reinterpret_cast<const uint2*>(p);
                r.u[0] = q.x;
                r.u[1] = q.y;
            } else {
#pragma unroll
                for (int i = 0; i < Raw<T, CV, V>::kWords / 4; ++i) {
                    const uint4 q = reinterpret_cast<const uint4*>(p)[i];
                    r.u[4 * i] = q.x;
                    r.u[4 * i + 1] = q.y;
                    r.u[4 * i + 2] = q.z;
                    r.u[4 * i + 3] = q.w;
                }
            }
        } else {
            r.load(src.row(b, read_at) + c0, n);
        }
        ++read_at;
        r.get(f);
    }
};

// ---------------------------------------------------------------- forward
// one thread per (batch, block of kFwdRows rows, vector of kFwdVec
// channels), the vectors fastest; win[j] holds ext row t - (NW - 1) + j
template <typename T, int NW, bool V>
__global__ void __launch_bounds__(kFwdThreads)
conv_fwd_kernel(Rows<T> x, const T* __restrict__ state,
                const T* __restrict__ w, const T* __restrict__ bias,
                T* __restrict__ y, int S, int C, int K, int vecs,
                int blocks, long long items) {
    constexpr int CV = kFwdVec;
    constexpr int kBytes = CV * static_cast<int>(sizeof(T));
    constexpr int D = kFwdRing / kBytes;        // rows in flight
    __shared__ __align__(16) unsigned char ring[D * kFwdThreads * kBytes];
    const long long item =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (item >= items) return;
    const int v = static_cast<int>(item % vecs);
    const long long rest = item / vecs;
    const int tb = static_cast<int>(rest % blocks);
    const int b = static_cast<int>(rest / blocks);
    const int c0 = v * CV, n = min(CV, C - c0);
    const int t0 = tb * kFwdRows, t1 = min(t0 + kFwdRows, S);
    Stream<T, CV, V, D> xs(ring + threadIdx.x * kBytes, kFwdThreads * kBytes,
                           x, b, c0, n, t0, t1);
#pragma unroll
    for (int d = 0; d < D; ++d) {
        xs.fetch(d);
        pipe_commit<V>();
    }
    float wv[NW][CV], bv[CV], win[NW][CV];
    load_taps<T, NW, CV, V>(w, K, C, c0, n, wv);
    {
        Raw<T, CV, V> r;
        r.load(bias + c0, n);
        r.get(bv);
    }
#pragma unroll
    for (int j = 0; j < NW - 1; ++j)
        ext_row<T, CV, V>(x, state, b, t0 - (NW - 1) + j, K, C, c0, n,
                          win[j]);
    T* out = y + (static_cast<long long>(b) * S) * C + c0;
    for (int t = t0; t < t1; ++t) {
        const int slot = (t - t0) & (D - 1);
        pipe_wait<V, D - 1>();
        xs.read(slot, win[NW - 1]);
        xs.fetch(slot);
        pipe_commit<V>();
        float o[CV];
#pragma unroll
        for (int e = 0; e < CV; ++e) {
            float a = 0.f;
#pragma unroll
            for (int j = 0; j < NW; ++j) a = fmaf(wv[j][e], win[j][e], a);
            a += bv[e];
            o[e] = a * sigmoid(a);
        }
        put<T, CV, V>(out + static_cast<long long>(t) * C, o, n);
#pragma unroll
        for (int j = 0; j < NW - 1; ++j)
#pragma unroll
            for (int e = 0; e < CV; ++e) win[j][e] = win[j + 1][e];
    }
}

// --------------------------------------------------------------- backward
// CTA (x: 32 vectors of kBwdVec channels, y: kBwdWarps blocks of kBwdRows
// rows, z: batch).  Warp y walks rows s = t0 .. t1 + NW - 2: at each it
// recomputes pre[s] from xw (ext rows s - (NW - 1) .. s) and g[s] = dy[s]
// silu'(pre[s]) (0 past S), adds g[s] xw and g[s] to its sums of dw and db
// where s is its own row, and writes row t = s - (NW - 1) of dx (or, in
// the first block, of the state's gradient) from gw (g rows t .. s).  Then
// the CTA's warps' sums go through a fixed tree (in the rings' shared
// memory) into partial row b gridDim.y + blockIdx.y of part
// ((Bz gridDim.y, K + 1, C): dw's K rows, then db's).
template <typename T, int NW, bool V>
__global__ void __launch_bounds__(32 * kBwdWarps)
conv_bwd_kernel(Rows<T> x, const T* __restrict__ state,
                const T* __restrict__ w, const T* __restrict__ bias,
                Rows<T> dy, T* __restrict__ dx, T* __restrict__ dstate,
                float* __restrict__ part, int S, int C, int K, int vecs) {
    constexpr int CV = kBwdVec;
    constexpr int kBytes = CV * static_cast<int>(sizeof(T));
    constexpr int D = kBwdRing / kBytes;        // rows in flight
    constexpr int kThreads = 32 * kBwdWarps;
    constexpr int kRingBytes = D * kThreads * kBytes;
    constexpr int kRedBytes = kBwdWarps / 2 * (NW + 1) * CV * 32 * 4;
    constexpr int kSmem =
        2 * kRingBytes > kRedBytes ? 2 * kRingBytes : kRedBytes;
    __shared__ __align__(16) unsigned char smem[kSmem];
    float(*red)[NW + 1][CV][32] =
        reinterpret_cast<float(*)[NW + 1][CV][32]>(smem);
    const int tid = threadIdx.y * 32 + threadIdx.x;
    const int v = blockIdx.x * 32 + threadIdx.x;
    const bool live = v < vecs;
    const int b = blockIdx.z;
    const int t0 = (blockIdx.y * kBwdWarps + threadIdx.y) * kBwdRows;
    const int t1 = min(t0 + kBwdRows, S);
    const int c0 = v * CV, n = live ? min(CV, C - c0) : 0;
    float acc[NW + 1][CV];
#pragma unroll
    for (int j = 0; j <= NW; ++j)
#pragma unroll
        for (int e = 0; e < CV; ++e) acc[j][e] = 0.f;
    if (live && t0 < S) {
        const int s1 = t1 + NW - 1, s_load = min(s1, S);
        Stream<T, CV, V, D> xs(smem + tid * kBytes, kThreads * kBytes, x, b,
                               c0, n, t0, s_load);
        Stream<T, CV, V, D> ds(smem + kRingBytes + tid * kBytes,
                               kThreads * kBytes, dy, b, c0, n, t0, s_load);
#pragma unroll
        for (int d = 0; d < D; ++d) {
            xs.fetch(d);
            ds.fetch(d);
            pipe_commit<V>();
        }
        float wv[NW][CV], bv[CV], xw[NW][CV], gw[NW][CV];
        load_taps<T, NW, CV, V>(w, K, C, c0, n, wv);
        {
            Raw<T, CV, V> r;
            r.load(bias + c0, n);
            r.get(bv);
        }
#pragma unroll
        for (int j = 0; j < NW; ++j) {
#pragma unroll
            for (int e = 0; e < CV; ++e) gw[j][e] = 0.f;
            if (j < NW - 1)
                ext_row<T, CV, V>(x, state, b, t0 - (NW - 1) + j, K, C, c0,
                                  n, xw[j]);
        }
        T* dxb = dx + (static_cast<long long>(b) * S) * C + c0;
        for (int s = t0; s < s1; ++s) {
#pragma unroll
            for (int j = 0; j < NW - 1; ++j)
#pragma unroll
                for (int e = 0; e < CV; ++e) gw[j][e] = gw[j + 1][e];
            if (s < s_load) {
                const int slot = (s - t0) & (D - 1);
                float d[CV];
                pipe_wait<V, D - 1>();
                xs.read(slot, xw[NW - 1]);
                ds.read(slot, d);
                xs.fetch(slot);
                ds.fetch(slot);
                pipe_commit<V>();
                const bool own = s < t1;
#pragma unroll
                for (int e = 0; e < CV; ++e) {
                    float a = 0.f;
#pragma unroll
                    for (int j = 0; j < NW; ++j)
                        a = fmaf(wv[j][e], xw[j][e], a);
                    a += bv[e];
                    const float sg = sigmoid(a);
                    const float g = d[e] * (sg * (1.f + a * (1.f - sg)));
                    gw[NW - 1][e] = g;
                    if (own) {
#pragma unroll
                        for (int j = 0; j < NW; ++j)
                            acc[j][e] = fmaf(g, xw[j][e], acc[j][e]);
                        acc[NW][e] += g;
                    }
                }
#pragma unroll
                for (int j = 0; j < NW - 1; ++j)
#pragma unroll
                    for (int e = 0; e < CV; ++e) xw[j][e] = xw[j + 1][e];
            } else {
#pragma unroll
                for (int e = 0; e < CV; ++e) gw[NW - 1][e] = 0.f;
            }
            const int t = s - (NW - 1);
            T* dst = nullptr;
            if (t >= t0)
                dst = dxb + static_cast<long long>(t) * C;
            else if (dstate != nullptr && t0 == 0 && t >= -(K - 1))
                dst = dstate
                      + (static_cast<long long>(b) * (K - 1) + K - 1 + t) * C
                      + c0;
            if (dst != nullptr) {
                float o[CV];
#pragma unroll
                for (int e = 0; e < CV; ++e) {
                    float a = 0.f;
#pragma unroll
                    for (int j = 0; j < NW; ++j)
                        a = fmaf(wv[j][e], gw[NW - 1 - j][e], a);
                    o[e] = a;
                }
                put<T, CV, V>(dst, o, n);
            }
        }
    }
    // the warps' sums, pairwise in a fixed order (warp y + half into y),
    // in the shared memory the rings held
    pipe_wait<V, 0>();
    __syncthreads();
    for (int half = kBwdWarps / 2; half > 0; half /= 2) {
        if (threadIdx.y >= half && threadIdx.y < 2 * half) {
#pragma unroll
            for (int j = 0; j <= NW; ++j)
#pragma unroll
                for (int e = 0; e < CV; ++e)
                    red[threadIdx.y - half][j][e][threadIdx.x] = acc[j][e];
        }
        __syncthreads();
        if (threadIdx.y < half) {
#pragma unroll
            for (int j = 0; j <= NW; ++j)
#pragma unroll
                for (int e = 0; e < CV; ++e)
                    acc[j][e] += red[threadIdx.y][j][e][threadIdx.x];
        }
        __syncthreads();
    }
    if (threadIdx.y != 0 || !live) return;
    const long long grp = static_cast<long long>(b) * gridDim.y + blockIdx.y;
    float* pg = part + grp * (K + 1) * C + c0;
#pragma unroll
    for (int j = 0; j <= NW; ++j) {
        const int r = j == NW ? K : j - (NW - K);
        if (r >= 0) put<float, CV, V>(pg + static_cast<long long>(r) * C,
                                      acc[j], n);
    }
}

// dw (K, C) and db (C) from the partials (groups, K + 1, C), in a fixed
// order: kSumCols columns a CTA by kSumGroups groups of partials, each
// thread summing partials g, g + kSumGroups, ... of its column, then the
// groups in order
template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumGroups)
conv_sum_kernel(const float* __restrict__ part, int groups, int C, int K,
                T* __restrict__ dw, T* __restrict__ db) {
    __shared__ float acc[kSumGroups][kSumCols];
    const long long cols = static_cast<long long>(K + 1) * C;
    const int cx = threadIdx.x % kSumCols, g = threadIdx.x / kSumCols;
    const long long i = static_cast<long long>(blockIdx.x) * kSumCols + cx;
    float s = 0.f;
    if (i < cols)
        for (int k = g; k < groups; k += kSumGroups) s += part[k * cols + i];
    acc[g][cx] = s;
    __syncthreads();
    if (g != 0 || i >= cols) return;
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < kSumGroups; ++j) t += acc[j][cx];
    const long long wc = static_cast<long long>(K) * C;
    if (i < wc)
        dw[i] = from_float<T>(t);
    else
        db[i - wc] = from_float<T>(t);
}

// the backward's grid: (vectors / 32, row blocks / kBwdWarps, Bz)
dim3 bwd_grid(int Bz, int S, int C) {
    const int vecs = (C + kBwdVec - 1) / kBwdVec;
    const int rows = kBwdWarps * kBwdRows;
    return dim3((vecs + 31) / 32, (S + rows - 1) / rows, Bz);
}

bool aligned(const void* p, long long sb, long long ss, int esize) {
    return ((reinterpret_cast<uintptr_t>(p)
             | static_cast<uintptr_t>(sb * esize)
             | static_cast<uintptr_t>(ss * esize)) & 15) == 0;
}

// the shapes both entry points take; where C % 8 == 0 (the word body) every
// operand given, and each of x's rows, starts on the 16-byte grid
bool valid(int Bz, int S, int C, int K, const void* x, long long x_sb,
           long long x_ss, const void* state, const void* w, const void* b,
           const void* out, int esize) {
    if (Bz <= 0 || S <= 0 || C <= 0 || K < 1 || K > kMaxTaps || Bz > 65535)
        return false;
    if (C % 8 != 0) return true;
    return aligned(x, x_sb, x_ss, esize) && aligned(state, 0, 0, esize)
           && aligned(w, 0, 0, esize) && aligned(b, 0, 0, esize)
           && aligned(out, 0, 0, esize);
}

template <typename T, int NW, bool V>
int launch_fwd(Rows<T> x, const T* state, const T* w, const T* b, T* y,
               int Bz, int S, int C, int K, cudaStream_t stream) {
    const int vecs = (C + kFwdVec - 1) / kFwdVec;
    const int blocks = (S + kFwdRows - 1) / kFwdRows;
    const long long items = static_cast<long long>(Bz) * blocks * vecs;
    const long long ctas = (items + kFwdThreads - 1) / kFwdThreads;
    if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    conv_fwd_kernel<T, NW, V><<<static_cast<unsigned>(ctas), kFwdThreads, 0,
                                stream>>>(x, state, w, b, y, S, C, K, vecs,
                                          blocks, items);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int NW, bool V>
int launch_bwd(Rows<T> x, const T* state, const T* w, const T* b,
               Rows<T> dy, T* dx, T* dstate, T* dw, T* db, float* scratch,
               long long scratch_floats, int Bz, int S, int C, int K,
               cudaStream_t stream) {
    const dim3 grid = bwd_grid(Bz, S, C);
    const int groups = static_cast<int>(grid.y) * Bz;
    if (scratch_floats < static_cast<long long>(groups) * (K + 1) * C)
        return static_cast<int>(cudaErrorInvalidValue);
    conv_bwd_kernel<T, NW, V><<<grid, dim3(32, kBwdWarps), 0, stream>>>(
        x, state, w, b, dy, dx, dstate, scratch, S, C, K,
        (C + kBwdVec - 1) / kBwdVec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cols = static_cast<long long>(K + 1) * C;
    conv_sum_kernel<T><<<static_cast<unsigned>((cols + kSumCols - 1)
                                               / kSumCols),
                         kSumCols * kSumGroups, 0, stream>>>(
        scratch, groups, C, K, dw, db);
    return static_cast<int>(cudaGetLastError());
}

// the kernels for K taps: NW = 4 up to 4, else 8; the word body where
// C % 8 == 0
template <typename T>
int fwd(const void* x, long long x_sb, long long x_ss, const void* state,
        const void* w, const void* b, void* y, int Bz, int S, int C, int K,
        cudaStream_t s) {
    const Rows<T> xr{static_cast<const T*>(x), x_sb, x_ss};
    const T *st = static_cast<const T*>(state), *wt = static_cast<const T*>(w),
            *bt = static_cast<const T*>(b);
    T* yt = static_cast<T*>(y);
    const bool words = C % 8 == 0;
    if (K <= 4)
        return words ? launch_fwd<T, 4, true>(xr, st, wt, bt, yt, Bz, S, C, K, s)
                     : launch_fwd<T, 4, false>(xr, st, wt, bt, yt, Bz, S, C, K,
                                               s);
    return words ? launch_fwd<T, 8, true>(xr, st, wt, bt, yt, Bz, S, C, K, s)
                 : launch_fwd<T, 8, false>(xr, st, wt, bt, yt, Bz, S, C, K, s);
}

template <typename T>
int bwd(const void* x, long long x_sb, long long x_ss, const void* state,
        const void* w, const void* b, const void* dy, long long dy_sb,
        long long dy_ss, void* dx, void* dstate, void* dw, void* db,
        float* scratch, long long scratch_floats, int Bz, int S, int C,
        int K, cudaStream_t s) {
    const Rows<T> xr{static_cast<const T*>(x), x_sb, x_ss};
    const Rows<T> dr{static_cast<const T*>(dy), dy_sb, dy_ss};
    const T *st = static_cast<const T*>(state), *wt = static_cast<const T*>(w),
            *bt = static_cast<const T*>(b);
    T *dxt = static_cast<T*>(dx), *dst = static_cast<T*>(dstate),
      *dwt = static_cast<T*>(dw), *dbt = static_cast<T*>(db);
    const bool words = C % 8 == 0;
#define CONV_BWD(NW, V)                                                       \
    launch_bwd<T, NW, V>(xr, st, wt, bt, dr, dxt, dst, dwt, dbt, scratch,    \
                         scratch_floats, Bz, S, C, K, s)
    if (K <= 4) return words ? CONV_BWD(4, true) : CONV_BWD(4, false);
    return words ? CONV_BWD(8, true) : CONV_BWD(8, false);
#undef CONV_BWD
}

}  // namespace

// x: (Bz, S, C) in the model dtype (bf16 with bf16 set, else float32), row
// (b, t) read from b x_sb + t x_ss elements (channels contiguous); state:
// (Bz, K - 1, C) contiguous, or null for zeros; w (K, C) and b (C)
// contiguous.  Writes y = silu(conv + b) (Bz, S, C) contiguous.  1 <= K <=
// 8; where C % 8 == 0, every pointer and x's strides on the 16-byte grid.
KERNEL_EXPORT int mamba_causal_conv_fwd(const void* x, long long x_sb,
                                        long long x_ss, const void* state,
                                        const void* w, const void* b,
                                        void* y, int Bz, int S, int C,
                                        int K, int bf16, void* stream) {
    const int esize = bf16 ? 2 : 4;
    if (!valid(Bz, S, C, K, x, x_sb, x_ss, state, w, b, y, esize))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16)
        return fwd<__nv_bfloat16>(x, x_sb, x_ss, state, w, b, y, Bz, S, C, K,
                                  s);
    return fwd<float>(x, x_sb, x_ss, state, w, b, y, Bz, S, C, K, s);
}

// The forward's inputs as it read them and dy (Bz, S, C), row (b, t) at
// b dy_sb + t dy_ss -> dx (Bz, S, C) contiguous, dw (K, C), db (C) and,
// unless dstate is null, the state's gradient (Bz, K - 1, C), all in the
// model dtype.  scratch: the backward's float32 partials, at least
// mamba_causal_conv_bwd_scratch_floats floats.
KERNEL_EXPORT int mamba_causal_conv_bwd(const void* x, long long x_sb,
                                        long long x_ss, const void* state,
                                        const void* w, const void* b,
                                        const void* dy, long long dy_sb,
                                        long long dy_ss, void* dx,
                                        void* dstate, void* dw, void* db,
                                        float* scratch,
                                        long long scratch_floats, int Bz,
                                        int S, int C, int K, int bf16,
                                        void* stream) {
    const int esize = bf16 ? 2 : 4;
    if (!valid(Bz, S, C, K, x, x_sb, x_ss, state, w, b, dx, esize)
        || (C % 8 == 0
            && !(aligned(dy, dy_sb, dy_ss, esize)
                 && aligned(dstate, 0, 0, esize) && aligned(dw, 0, 0, esize)
                 && aligned(db, 0, 0, esize) && aligned(scratch, 0, 0, 4))))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16)
        return bwd<__nv_bfloat16>(x, x_sb, x_ss, state, w, b, dy, dy_sb,
                                  dy_ss, dx, dstate, dw, db, scratch,
                                  scratch_floats, Bz, S, C, K, s);
    return bwd<float>(x, x_sb, x_ss, state, w, b, dy, dy_sb, dy_ss, dx,
                      dstate, dw, db, scratch, scratch_floats, Bz, S, C, K,
                      s);
}

// The backward's partials in floats at (Bz, S, C) with K taps: K + 1 rows
// of C for each row of the backward's grid; 0 for shapes the kernels do
// not take.
KERNEL_EXPORT long long mamba_causal_conv_bwd_scratch_floats(int Bz, int S,
                                                             int C, int K) {
    if (Bz <= 0 || S <= 0 || C <= 0 || K < 1 || K > kMaxTaps || Bz > 65535)
        return 0;
    const dim3 grid = bwd_grid(Bz, S, C);
    return static_cast<long long>(grid.y) * Bz * (K + 1) * C;
}
