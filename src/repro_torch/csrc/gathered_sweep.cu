// Pre-gathered window ε-sweep for Hopper (sm_90a): the grid-hash engine's
// inner loop.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gathered_sweep.py gathered_sweep (def :55) -> gathered_sweep_kernel
//
// Contract (identical to the reference): query row r (of the row-major
// (b, 3) query array) sweeps its own window of k candidates, row r of each
// plane of the planar (3, b, k) candidate array, with payload croot (b, k)
// = root if the candidate is valid and core, else INT32_MAX. Invalid and
// padded candidates carry +1e30 coordinates. Per row: the count of window
// candidates with d2 <= eps2 and the min croot over those hits (INT32_MAX
// when none). d2 is sweep_common.cuh's dist2_rn, compared with <= eps2
// (eps2 rounded once to f32 by the caller).
//
// What bounds it on this card: memory. Each query has its own window, so no
// candidate is reused across queries: every pair reads 16 bytes (three f32
// coordinates and the int32 payload) for 10 FP32 operations, under one
// operation per byte against a ridge point of about 20. The design streams
// the window at full width and keeps nothing else out of registers:
//   * one warp per query row; the query's coordinates in registers;
//   * each lane reads 4 consecutive candidates of each plane and of croot
//     as one 16-byte load, so a warp reads 512 contiguous bytes per plane
//     per step, coalesced along k (k is a multiple of 4 and the rows are
//     16-byte aligned: the wrapper checks both);
//   * loads bypass L1 residency (__ldcs, read once);
//   * count and min reduce across the warp with __reduce_add_sync /
//     __reduce_min_sync, and lane 0 writes the row once.
// Left for later work: gathering the window inside the kernel from the
// (H, C) bucket table (the caller now gathers it into device memory first,
// which costs more bytes than the sweep itself).

#include "sweep_common.cuh"

namespace {

using repro::kIntMax;

constexpr int kWarpsPerBlock = 8;

__global__ void gathered_sweep_kernel(const float* __restrict__ queries,
                                      const float* __restrict__ cands,
                                      const int* __restrict__ croot,
                                      float eps2, int b, int k,
                                      int* __restrict__ counts,
                                      int* __restrict__ minroot) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= b) return;  // the whole warp leaves together
  const float qx = queries[row * 3 + 0];
  const float qy = queries[row * 3 + 1];
  const float qz = queries[row * 3 + 2];
  const int64_t plane = static_cast<int64_t>(b) * k;
  const float4* cx = reinterpret_cast<const float4*>(cands + row * k);
  const float4* cy = reinterpret_cast<const float4*>(cands + plane + row * k);
  const float4* cz =
      reinterpret_cast<const float4*>(cands + 2 * plane + row * k);
  const int4* cr = reinterpret_cast<const int4*>(croot + row * k);
  int cnt = 0;
  int mr = kIntMax;
#pragma unroll 4
  for (int j = lane; j < k / 4; j += 32) {
    const float4 x = __ldcs(cx + j);
    const float4 y = __ldcs(cy + j);
    const float4 z = __ldcs(cz + j);
    const int4 r = __ldcs(cr + j);
    const bool h0 = repro::dist2_rn(qx, qy, qz, x.x, y.x, z.x) <= eps2;
    const bool h1 = repro::dist2_rn(qx, qy, qz, x.y, y.y, z.y) <= eps2;
    const bool h2 = repro::dist2_rn(qx, qy, qz, x.z, y.z, z.z) <= eps2;
    const bool h3 = repro::dist2_rn(qx, qy, qz, x.w, y.w, z.w) <= eps2;
    cnt += h0 + h1 + h2 + h3;
    if (h0) mr = min(mr, r.x);
    if (h1) mr = min(mr, r.y);
    if (h2) mr = min(mr, r.z);
    if (h3) mr = min(mr, r.w);
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  mr = __reduce_min_sync(0xffffffffu, mr);
  if (lane == 0) {
    counts[row] = cnt;
    minroot[row] = mr;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on success. Launches on `stream`, does not
// synchronise and allocates nothing.
int gathered_sweep_launch(int device, const float* queries,
                          const float* cands, const int* croot, float eps2,
                          int b, int k, int* counts, int* minroot,
                          void* stream) {
  if (b == 0) return 0;
  cudaError_t err = repro::prepare(device, gathered_sweep_kernel, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gathered_sweep_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      queries, cands, croot, eps2, b, k, counts, minroot);
  return static_cast<int>(cudaGetLastError());
}

const char* gathered_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
