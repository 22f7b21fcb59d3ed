// PTX wrappers of the fused residual kernels (sm_90a): the float64
// tensor-core products, asynchronous global-to-shared copies and the block's
// dynamic shared memory.  Kept apart so that everything else in
// taylor_mlp.cuh is plain CUDA C++.

#pragma once

#include <cuda_runtime.h>

namespace {

// D = A·B + C on the float64 tensor cores, one 8x8x4 tile per warp
// (`SM80_8x8x4_F64F64F64F64_TN` in CUTLASS).  Lane t holds A(t/4, t%4),
// B(t%4, t/4), and C/D(t/4, 2·(t%4) + v) for v = 0, 1.
__device__ __forceinline__ void dmma_8x8x4(double& d0, double& d1, double a,
                                           double b, double c0, double c1) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%4, %5};\n"
      : "=d"(d0), "=d"(d1)
      : "d"(a), "d"(b), "d"(c0), "d"(c1));
}

// D = A·B + D on the float64 tensor cores, one 16x8x8 tile per warp
// (`SM90_16x8x8_F64F64F64F64_TN` in CUTLASS).  With g = t/4, q = t%4, lane t
// holds A(g, q), A(g+8, q), A(g, q+4), A(g+8, q+4); B(q, g), B(q+4, g); and
// D(g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1) as d0-d3.
__device__ __forceinline__ void dmma_16x8x8(double& d0, double& d1, double& d2,
                                            double& d3, double a0, double a1,
                                            double a2, double a3, double b0,
                                            double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// Copy N bytes (4 or 8) from global to shared memory without the register
// file; with `full` false nothing is read and the destination is zeroed.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(N), "r"(full ? N : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return smem_raw;
}

}  // namespace
