// cp.async helpers shared by the kernels that stage rows in shared
// memory ahead of their use (csrc/anr.cu, csrc/nb.cu).
#pragma once

#include <cuda_runtime.h>

// Copy one float from global to shared memory asynchronously; it lands
// by the cp_async_wait that retires its group.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Close the group of this thread's cp.asyncs issued since the last
// commit (an empty group where it issued none).
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
