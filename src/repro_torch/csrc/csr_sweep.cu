// Cell-sorted CSR slab ε-sweep for Hopper (sm_90a): the grid engine's inner
// loop, in two variants that share one body.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/csr_sweep.py:
//   csr_sweep        (def :146, body _kernel :53)          -> csr_sweep_kernel<true>
//   csr_sweep_counts (def :102, body _kernel_counts :73)   -> csr_sweep_kernel<false>
//
// Contract (identical to the reference): query tile t (block_q rows of the
// row-major (T*block_q, 3) query array) sweeps the candidate blocks
// starts_blk[t] .. starts_blk[t] + nblk[t] - 1 (block_k columns each) of the
// planar (3, nc) sorted candidate array. Per query it returns the count of
// candidates with d2 <= eps2 and, for csr_sweep, the min of croot over those
// hits (INT32_MAX when none). A tile with nblk = 0 returns 0 / INT32_MAX.
//
// Arithmetic: d2 = ((0 + dx*dx) + dy*dy) + dz*dz with every operation rounded
// on its own (__fsub_rn / __fmul_rn / __fadd_rn, and the file is compiled
// with -fmad=false besides). An FMA-contracted d2 differs from the reference
// at d2 = eps2 and flips integer outputs. The leading 0 + dx*dx is dropped:
// a square is never -0, so adding +0 leaves it unchanged. Candidates padded
// with +1e30 give d2 = +inf, a miss; squares are >= 0, so no NaN can arise.
//
// What bounds it on this card: FP32 lane throughput. Each (query, candidate)
// pair costs 3 FSUB, 3 FMUL, 3 FADD and a compare, and every query of the
// tile reuses each 16-byte candidate it stages: block_q * 10 operations per
// 16 bytes (160 per byte at block_q = 256), far above the card's ridge point
// of about 20 FP32 operations per byte of HBM traffic.
// The design keeps the lanes fed:
//   * one thread block per query tile, one query per thread, its coordinates
//     in registers for the whole slab walk;
//   * the slab loop runs inside the block (this replaces the Pallas
//     sequential j grid axis and its accumulate-into-output idiom); a tile
//     owns its output rows, so no reduction across blocks is needed;
//   * each candidate block is staged once in shared memory as float4
//     (x, y, z, croot bits), so the inner loop issues one broadcast LDS.128
//     per pair and no bank conflicts;
//   * counts and min-root live in registers and are written once.
// Left for later work: several queries per thread, a persistent grid that
// balances the skewed nblk across SMs, and cp.async/TMA double buffering.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kIntMax = 0x7fffffff;

template <bool kPayload>
__global__ void csr_sweep_kernel(const float* __restrict__ queries,
                                 const float* __restrict__ cands,
                                 const int* __restrict__ croot,
                                 const int* __restrict__ starts_blk,
                                 const int* __restrict__ nblk, float eps2,
                                 int nc, int max_blocks, int block_k,
                                 int* __restrict__ counts,
                                 int* __restrict__ minroot) {
  extern __shared__ float4 stage[];
  const int t = blockIdx.x;
  const int64_t row = static_cast<int64_t>(t) * blockDim.x + threadIdx.x;
  const float qx = queries[row * 3 + 0];
  const float qy = queries[row * 3 + 1];
  const float qz = queries[row * 3 + 2];

  // Walk at most max_blocks blocks, and never outside [0, nc): inputs that
  // break the contract cannot make the kernel read out of bounds.
  const int n_blocks = nc / block_k;
  const int sb = max(starts_blk[t], 0);
  const int nb = max(0, min(min(nblk[t], max_blocks), n_blocks - sb));

  int cnt = 0;
  int mr = kIntMax;
  for (int b = 0; b < nb; ++b) {
    const int64_t off = static_cast<int64_t>(sb + b) * block_k;
    __syncthreads();  // every thread is done with the previous block
    for (int i = threadIdx.x; i < block_k; i += blockDim.x) {
      const int r = kPayload ? croot[off + i] : kIntMax;
      stage[i] = make_float4(cands[off + i], cands[nc + off + i],
                             cands[2 * static_cast<int64_t>(nc) + off + i],
                             __int_as_float(r));
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < block_k; ++i) {
      const float4 c = stage[i];
      const float dx = __fsub_rn(qx, c.x);
      const float dy = __fsub_rn(qy, c.y);
      const float dz = __fsub_rn(qz, c.z);
      float acc = __fmul_rn(dx, dx);
      acc = __fadd_rn(acc, __fmul_rn(dy, dy));
      acc = __fadd_rn(acc, __fmul_rn(dz, dz));
      const bool hit = acc <= eps2;
      cnt += hit;
      if (kPayload && hit) mr = min(mr, __float_as_int(c.w));
    }
  }
  counts[row] = cnt;
  if (kPayload) minroot[row] = mr;
}

template <bool kPayload>
int launch(int device, const float* queries, const float* cands,
           const int* croot, const int* starts_blk, const int* nblk,
           float eps2, int n_tiles, int block_q, int nc, int max_blocks,
           int block_k, int* counts, int* minroot, void* stream) {
  if (n_tiles == 0) return 0;
  // This library carries its own CUDA runtime: select the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(block_k) * sizeof(float4);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(csr_sweep_kernel<kPayload>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  csr_sweep_kernel<kPayload><<<n_tiles, block_q, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      queries, cands, croot, starts_blk, nblk, eps2, nc, max_blocks, block_k,
      counts, minroot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on success. Launches on `stream`, does not
// synchronise and allocates nothing.
int csr_sweep_launch(int device, const float* queries, const float* cands,
                     const int* croot, const int* starts_blk, const int* nblk,
                     float eps2, int n_tiles, int block_q, int nc,
                     int max_blocks, int block_k, int* counts, int* minroot,
                     void* stream) {
  return launch<true>(device, queries, cands, croot, starts_blk, nblk, eps2,
                      n_tiles, block_q, nc, max_blocks, block_k, counts,
                      minroot, stream);
}

int csr_sweep_counts_launch(int device, const float* queries,
                            const float* cands, const int* starts_blk,
                            const int* nblk, float eps2, int n_tiles,
                            int block_q, int nc, int max_blocks, int block_k,
                            int* counts, void* stream) {
  return launch<false>(device, queries, cands, nullptr, starts_blk, nblk,
                       eps2, n_tiles, block_q, nc, max_blocks, block_k,
                       counts, nullptr, stream);
}

const char* csr_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
