// Shared pieces of the ε-sweep kernels (csr_sweep.cu, gathered_sweep.cu).
//
// The one d2 every sweep must reproduce bit for bit is the reference's
// (src/repro/kernels/ref.py _dist2, and the Pallas kernels' _hit_mask):
// d2 = ((0 + dx*dx) + dy*dy) + dz*dz, d = q - c, in f32, with every
// operation rounded on its own. Here it is written with __fsub_rn /
// __fmul_rn / __fadd_rn, and the sources are compiled with -fmad=false
// besides: an FMA-contracted d2 differs at d2 = eps2 and flips integer
// outputs. The leading 0 + dx*dx is dropped: a square is never -0, so adding
// +0 leaves it unchanged. Candidates padded with +1e30 give d2 = +inf, a
// miss for any finite query; squares are >= 0, so no NaN can arise.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kIntMax = 0x7fffffff;

__device__ __forceinline__ float dist2_rn(float qx, float qy, float qz,
                                          float cx, float cy, float cz) {
  const float dx = __fsub_rn(qx, cx);
  const float dy = __fsub_rn(qy, cy);
  const float dz = __fsub_rn(qz, cz);
  float acc = __fmul_rn(dx, dx);
  acc = __fadd_rn(acc, __fmul_rn(dy, dy));
  acc = __fadd_rn(acc, __fmul_rn(dz, dz));
  return acc;
}

// Selects `device` (each library carries its own CUDA runtime) and lets
// `kernel` use `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t prepare(int device, Kernel kernel, size_t smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || smem <= 48 * 1024) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace repro
