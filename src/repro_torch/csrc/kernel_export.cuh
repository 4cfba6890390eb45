// The plain C interface every library under csrc/ exports (sm_90a).
//
// Each entry point is extern "C", launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError(); the wrapper in
// kernels/build.py turns a non-zero code into an exception with the
// message kernel_error_string gives.
#pragma once

#include <cuda_runtime.h>

#define KERNEL_EXPORT extern "C" __attribute__((visibility("default")))

KERNEL_EXPORT const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
