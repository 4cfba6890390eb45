// Mamba2 SSD chunked scan for Hopper (sm_90a): within a chunk of Q
// tokens the recurrence is a masked-decay (Q x Q) product, and across
// chunks only the (P, N) state is carried.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan, pl.pallas_call at :91).  The TPU kernel walks its grid
// (Bz, H, n_chunks) with the chunk axis sequential, carrying the (P, N)
// state in VMEM scratch.  Here one CTA owns one (head, batch) pair -- and
// one slice of the head dimension P, see below -- and walks the chunks in
// order with its slice of the state in shared memory.  x (Bz, S, H, P),
// dt (Bz, S, H) and y are read and written in their public layout through
// strides: no transposes.
//
// Per chunk, in the TPU kernel's order (kernel.py:44-72):
//   cum = cumsum(dt * A)                         (sequential, one thread)
//   W[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for i >= j; the
//             TPU kernel masks the exponent with -1e30 before exp, so the
//             j > i entries are exactly 0 and are not formed
//   y_i = sum_j W[i][j] x_j + (C_i . h) * exp(cum_i)
//   h'  = exp(cum_Q) h + sum_j (x_j * exp(cum_Q - cum_j) dt_j) B_j^T
//
// Splitting P across CTAs is exact: column p of y and row p of h depend
// only on x[:, p] and h[p, :]; each CTA forms the chunk's W again.  The
// wrapper splits P when Bz * H alone would leave most SMs idle (1-4 CTAs
// on the fleet DSE).
//
// Bound on an H100 SXM (published peaks, 700 W limit): for one
// mamba2-780m layer (S 4096, H 48, P 64, N 128, chunk 64, f32) the bytes
// are ~107 MB (~32 us at 3.35 TB/s), but the chunked algorithm needs
// ~7 GFLOP of f32 (~0.11 ms at 67 TFLOP/s without tensor cores), so
// operations bound it.  This first kernel stages the chunk's x slice, B,
// C (rows padded by one float, so a warp's column reads fall in distinct
// banks), dt, cum, W and the state slice in dynamic shared memory, one
// thread per output element of each product, f32 FMA on the CUDA cores.
// The wrapper refuses a chunk whose staging exceeds the opt-in shared
// memory.
#include "kernel_export.cuh"

namespace {

constexpr int kThreads = 256;

// Shared memory, in floats: x slice (Q, Pc), B and C (Q, N + 1), dt and
// cum (Q), W (Q, Q), the state slice (Pc, N + 1).
__host__ __device__ __forceinline__ long long smem_floats(int Q, int Pc,
                                                          int N) {
    return (long long)Q * Pc + 2LL * Q * (N + 1) + 2LL * Q
           + (long long)Q * Q + (long long)Pc * (N + 1);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ h_final, int S, int H, int P, int N,
                int Q, int Pc) {
    extern __shared__ float smem[];
    const int ldN = N + 1;
    float* xs = smem;                 // (Q, Pc); later x * rem
    float* bs = xs + Q * Pc;          // (Q, N + 1)
    float* cs = bs + Q * ldN;         // (Q, N + 1)
    float* dts = cs + Q * ldN;        // (Q)
    float* cum = dts + Q;             // (Q)
    float* ws = cum + Q;              // (Q, Q), lower triangle
    float* hs = ws + Q * Q;           // (Pc, N + 1)

    const int tid = threadIdx.x;
    const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * Pc;
    const float a_h = A[h];
    for (int e = tid; e < Pc * N; e += kThreads) {
        const int p = e / N, n = e - p * N;
        hs[p * ldN + n] = 0.0f;
    }

    for (int c0 = 0; c0 < S; c0 += Q) {
        const long long tok0 = (long long)b * S + c0;   // first token
        __syncthreads();      // the last chunk's readers are done
        for (int e = tid; e < Q * Pc; e += kThreads) {
            const int i = e / Pc, p = e - i * Pc;
            xs[e] = x[((tok0 + i) * H + h) * P + p0 + p];
        }
        for (int e = tid; e < Q * N; e += kThreads) {
            const int i = e / N, n = e - i * N;
            bs[i * ldN + n] = Bm[(tok0 + i) * N + n];
            cs[i * ldN + n] = Cm[(tok0 + i) * N + n];
        }
        for (int i = tid; i < Q; i += kThreads)
            dts[i] = dt[(tok0 + i) * H + h];
        __syncthreads();
        if (tid == 0) {
            float run = 0.0f;
            for (int i = 0; i < Q; ++i) {
                run += dts[i] * a_h;
                cum[i] = run;
            }
        }
        __syncthreads();

        // W = (C . B^T) * exp(cum_i - cum_j) * dt_j on the lower triangle
        for (int e = tid; e < Q * Q; e += kThreads) {
            const int i = e / Q, j = e - i * Q;
            if (j > i) continue;
            const float* ci = cs + i * ldN;
            const float* bj = bs + j * ldN;
            float s = 0.0f;
            for (int n = 0; n < N; ++n) s = fmaf(ci[n], bj[n], s);
            ws[i * Q + j] = s * expf(cum[i] - cum[j]) * dts[j];
        }
        __syncthreads();

        // y = W . x + (C . h^T) * exp(cum)
        for (int e = tid; e < Q * Pc; e += kThreads) {
            const int i = e / Pc, p = e - i * Pc;
            const float* wi = ws + i * Q;
            float intra = 0.0f;
            for (int j = 0; j <= i; ++j) intra = fmaf(wi[j], xs[j * Pc + p], intra);
            const float* ci = cs + i * ldN;
            const float* hp = hs + p * ldN;
            float inter = 0.0f;
            for (int n = 0; n < N; ++n) inter = fmaf(ci[n], hp[n], inter);
            y[((tok0 + i) * H + h) * P + p0 + p] = intra + inter * expf(cum[i]);
        }
        __syncthreads();

        // x * rem, rem_j = exp(cum_Q - cum_j) * dt_j
        const float total = cum[Q - 1];
        for (int e = tid; e < Q * Pc; e += kThreads) {
            const int j = e / Pc;
            xs[e] = xs[e] * (expf(total - cum[j]) * dts[j]);
        }
        __syncthreads();

        // h' = exp(total) * h + (x * rem)^T . B
        const float decay = expf(total);
        for (int e = tid; e < Pc * N; e += kThreads) {
            const int p = e / N, n = e - p * N;
            float s = 0.0f;
            for (int j = 0; j < Q; ++j) s = fmaf(xs[j * Pc + p], bs[j * ldN + n], s);
            hs[p * ldN + n] = decay * hs[p * ldN + n] + s;
        }
    }
    __syncthreads();
    float* hb = h_final + (((long long)b * H + h) * P + p0) * N;
    for (int e = tid; e < Pc * N; e += kThreads) {
        const int p = e / N, n = e - p * N;
        hb[(long long)p * N + n] = hs[p * ldN + n];
    }
}

}  // namespace

// x: (Bz, S, H, P); dt: (Bz, S, H); A: (H,); B, C: (Bz, S, N) -> y:
// (Bz, S, H, P), h_final: (Bz, H, P, N); all contiguous float32.
// S % chunk == 0 and P % p_split == 0, with the staging within the
// opt-in shared memory (checked by the Python wrapper).  Grid
// (H, Bz, p_split).
KERNEL_EXPORT int ssd_scan_fwd(const float* x, const float* dt,
                               const float* A, const float* B,
                               const float* C, float* y, float* h_final,
                               int Bz, int S, int H, int P, int N, int chunk,
                               int p_split, void* stream) {
    if (chunk <= 0 || S % chunk || p_split <= 0 || P % p_split)
        return static_cast<int>(cudaErrorInvalidValue);
    const int Pc = P / p_split;
    const long long smem = smem_floats(chunk, Pc, N) * 4;
    static long long opted_in = 48 * 1024;
    if (smem > opted_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        opted_in = smem;
    }
    const dim3 grid(H, Bz, p_split);
    ssd_scan_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
        x, dt, A, B, C, y, h_final, S, H, P, N, chunk, Pc);
    return static_cast<int>(cudaGetLastError());
}
