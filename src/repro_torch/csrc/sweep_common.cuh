// Shared pieces of the port's kernels: the ε-sweeps' d2 (csr_sweep.cu,
// gathered_sweep.cu), the Morton codes (bvh_sweep.cu, lbvh.cu,
// csr_layout.cu) and the launch preparation (every source).
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

// The bit layout of the reference's Morton codes (src/repro/kernels/ref.py
// morton_encode_ref): 15 bits of x and y interleaved in 2-D, 10 bits of x,
// y and z in 3-D, x in the lowest bit. expand2 / expand3 spread the low 15
// / 10 bits of x to every second / third bit.
__device__ __forceinline__ uint32_t expand3(uint32_t x) {  // 10 -> 30 bits
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

__device__ __forceinline__ uint32_t expand2(uint32_t x) {  // 15 -> 30 bits
  x &= 0x7FFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

__device__ __forceinline__ uint32_t morton2(uint32_t x, uint32_t y) {
  return expand2(x) | (expand2(y) << 1);
}

__device__ __forceinline__ uint32_t morton3(uint32_t x, uint32_t y,
                                            uint32_t z) {
  return expand3(x) | (expand3(y) << 1) | (expand3(z) << 2);
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
