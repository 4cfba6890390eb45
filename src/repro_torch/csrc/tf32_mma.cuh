// Float32 products on the TF32 tensor cores, and cp.async staging (sm_90a).
//
// Shared by csrc/ssd_scan.cu and csrc/ssd_scan_bwd.cu (through
// csrc/ssd_common.cuh) and csrc/flash_attention.cu.  A float32
// operand x is split as big + small: big is x with its low 13 mantissa
// bits cleared (a TF32 value), small = x - big is exact in float32.  The
// three products a_big b_big + a_big b_small + a_small b_big on
// mma.sync m16n8k8 keep ~21 significant bits of each operand, so a
// product keeps float32 accuracy against a 1e-4 (SSD) or 2e-5 (flash
// attention) tolerance; the dropped a_small b_small term is below
// float32's rounding of the sum.
#pragma once

#include <cstdint>

namespace {

// ---------------------------------------------------------------- copies
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// --------------------------------------------------------- tensor cores
// x = big + small: big is x cut to TF32 (its low 13 mantissa bits
// cleared), small = x - big is exact in float32; the tensor core reads
// both as TF32, dropping the low 13 bits of each, so big + small keeps
// ~21 significant bits of x.  Two instructions, no cvt.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
    big = __float_as_uint(x) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
}

// d += a . b for one 16 x 8 x 8 tile (A row-major, B column-major)
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}

}  // namespace
