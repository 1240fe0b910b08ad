// Slab ε-sweeps for Hopper (sm_90a): the inner loops of the grid engine
// (cell-sorted CSR slabs), of its frontier round driver, and of the brute
// engine, all one staged block-walk body.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/csr_sweep.py      csr_sweep        (def :146)  -> csr_sweep_kernel<true>
//   src/repro/kernels/csr_sweep.py      csr_sweep_counts (def :102)  -> csr_sweep_kernel<false>
//   src/repro/kernels/frontier_sweep.py frontier_sweep   (def :65)   -> frontier_sweep_kernel
//   src/repro/kernels/pairwise_sweep.py pairwise_sweep   (def :68)   -> pairwise_sweep_kernel
//
// Contracts (identical to the reference):
//   csr_sweep[_counts]: query tile t (block_q rows of the row-major
//     (T*block_q, 3) query array) sweeps the candidate blocks
//     starts_blk[t] .. starts_blk[t] + nblk[t] - 1 (block_k columns each) of
//     the planar (3, nc) sorted candidate array. Per query: the count of
//     candidates with d2 <= eps2 and, for csr_sweep, the min of croot over
//     those hits (INT32_MAX when none). A tile with nblk = 0 gives 0 /
//     INT32_MAX.
//   frontier_sweep: output slot i (rows i*block_q .. +block_q) holds the
//     csr_sweep minroot of tile active[i] when i < n_active, INT32_MAX rows
//     otherwise. n_active is read from device memory, so the caller never
//     syncs the host to learn it. No counts.
//   pairwise_sweep: query tile t sweeps every candidate block of the
//     (3, nc) array; counts and min croot over hits.
// d2 is sweep_common.cuh's dist2_rn, compared with <= eps2 (eps2 rounded
// once to f32 by the caller).
//
// What bounds them on this card: FP32 lane throughput. Each (query,
// candidate) pair costs 3 FSUB, 3 FMUL, 3 FADD and a compare, and every
// query of the tile reuses each 16-byte candidate it stages: block_q * 10
// operations per 16 bytes (160 per byte at block_q = 256), far above the
// card's ridge point of about 20 FP32 operations per byte of HBM traffic.
// The design keeps the lanes fed:
//   * one thread block per query tile (per frontier slot), one query per
//     thread, its coordinates in registers for the whole slab walk;
//   * the block walk runs inside the thread block (this replaces the Pallas
//     sequential j grid axis and its accumulate-into-output idiom); a tile
//     owns its output rows, so no reduction across blocks is needed;
//   * each candidate block is staged once in shared memory as float4
//     (x, y, z, croot bits), so the inner loop issues one broadcast LDS.128
//     per pair and no bank conflicts;
//   * counts and min-root live in registers and are written once;
//   * a parked frontier slot writes its INT32_MAX rows and returns before
//     any load: its cost is one block launch, not a slab walk.
// Left for later work: several queries per thread, a persistent grid that
// balances the skewed nblk across SMs (and a frontier grid sized by the
// live count), and cp.async/TMA double buffering.

#include "sweep_common.cuh"

namespace {

using repro::kIntMax;

// Walks candidate blocks sb .. sb + nb - 1 for one query per thread. Every
// thread of the block must call it with the same sb and nb (barriers).
template <bool kCount, bool kPayload>
__device__ __forceinline__ void walk_blocks(
    float qx, float qy, float qz, const float* __restrict__ cands,
    const int* __restrict__ croot, int nc, int sb, int nb, int block_k,
    float eps2, float4* stage, int& cnt, int& mr) {
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
      const bool hit = repro::dist2_rn(qx, qy, qz, c.x, c.y, c.z) <= eps2;
      if (kCount) cnt += hit;
      if (kPayload && hit) mr = min(mr, __float_as_int(c.w));
    }
  }
}

// Live blocks of tile t, clamped so that inputs that break the contract
// cannot make a kernel read outside [0, nc).
__device__ __forceinline__ void slab_of(const int* __restrict__ starts_blk,
                                        const int* __restrict__ nblk, int t,
                                        int nc, int max_blocks, int block_k,
                                        int& sb, int& nb) {
  const int n_blocks = nc / block_k;
  sb = max(starts_blk[t], 0);
  nb = max(0, min(min(nblk[t], max_blocks), n_blocks - sb));
}

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
  int sb, nb;
  slab_of(starts_blk, nblk, t, nc, max_blocks, block_k, sb, nb);
  int cnt = 0;
  int mr = kIntMax;
  walk_blocks<true, kPayload>(queries[row * 3 + 0], queries[row * 3 + 1],
                              queries[row * 3 + 2], cands, croot, nc, sb, nb,
                              block_k, eps2, stage, cnt, mr);
  counts[row] = cnt;
  if (kPayload) minroot[row] = mr;
}

__global__ void frontier_sweep_kernel(const float* __restrict__ queries,
                                      const float* __restrict__ cands,
                                      const int* __restrict__ croot,
                                      const int* __restrict__ starts_blk,
                                      const int* __restrict__ nblk,
                                      const int* __restrict__ active,
                                      const int* __restrict__ n_active,
                                      float eps2, int n_tiles, int nc,
                                      int max_blocks, int block_k,
                                      int* __restrict__ minroot) {
  extern __shared__ float4 stage[];
  const int i = blockIdx.x;
  const int64_t out = static_cast<int64_t>(i) * blockDim.x + threadIdx.x;
  const int t = active[i];
  // uniform over the block, so the early return skips no barrier
  if (i >= *n_active || t < 0 || t >= n_tiles) {
    minroot[out] = kIntMax;
    return;
  }
  const int64_t row = static_cast<int64_t>(t) * blockDim.x + threadIdx.x;
  int sb, nb;
  slab_of(starts_blk, nblk, t, nc, max_blocks, block_k, sb, nb);
  int cnt = 0;
  int mr = kIntMax;
  walk_blocks<false, true>(queries[row * 3 + 0], queries[row * 3 + 1],
                           queries[row * 3 + 2], cands, croot, nc, sb, nb,
                           block_k, eps2, stage, cnt, mr);
  minroot[out] = mr;
}

__global__ void pairwise_sweep_kernel(const float* __restrict__ queries,
                                      const float* __restrict__ cands,
                                      const int* __restrict__ croot,
                                      float eps2, int nc, int block_c,
                                      int* __restrict__ counts,
                                      int* __restrict__ minroot) {
  extern __shared__ float4 stage[];
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int cnt = 0;
  int mr = kIntMax;
  walk_blocks<true, true>(queries[row * 3 + 0], queries[row * 3 + 1],
                          queries[row * 3 + 2], cands, croot, nc, 0,
                          nc / block_c, block_c, eps2, stage, cnt, mr);
  counts[row] = cnt;
  minroot[row] = mr;
}

template <bool kPayload>
int launch_csr(int device, const float* queries, const float* cands,
               const int* croot, const int* starts_blk, const int* nblk,
               float eps2, int n_tiles, int block_q, int nc, int max_blocks,
               int block_k, int* counts, int* minroot, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = static_cast<size_t>(block_k) * sizeof(float4);
  cudaError_t err = repro::prepare(device, csr_sweep_kernel<kPayload>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  csr_sweep_kernel<kPayload><<<n_tiles, block_q, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      queries, cands, croot, starts_blk, nblk, eps2, nc, max_blocks, block_k,
      counts, minroot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launch function returns a cudaError_t code: 0 on success. It
// launches on `stream`, does not synchronise and allocates nothing.
int csr_sweep_launch(int device, const float* queries, const float* cands,
                     const int* croot, const int* starts_blk, const int* nblk,
                     float eps2, int n_tiles, int block_q, int nc,
                     int max_blocks, int block_k, int* counts, int* minroot,
                     void* stream) {
  return launch_csr<true>(device, queries, cands, croot, starts_blk, nblk,
                          eps2, n_tiles, block_q, nc, max_blocks, block_k,
                          counts, minroot, stream);
}

int csr_sweep_counts_launch(int device, const float* queries,
                            const float* cands, const int* starts_blk,
                            const int* nblk, float eps2, int n_tiles,
                            int block_q, int nc, int max_blocks, int block_k,
                            int* counts, void* stream) {
  return launch_csr<false>(device, queries, cands, nullptr, starts_blk, nblk,
                           eps2, n_tiles, block_q, nc, max_blocks, block_k,
                           counts, nullptr, stream);
}

int frontier_sweep_launch(int device, const float* queries,
                          const float* cands, const int* croot,
                          const int* starts_blk, const int* nblk,
                          const int* active, const int* n_active, float eps2,
                          int n_tiles, int block_q, int nc, int max_blocks,
                          int block_k, int* minroot, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = static_cast<size_t>(block_k) * sizeof(float4);
  cudaError_t err = repro::prepare(device, frontier_sweep_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  frontier_sweep_kernel<<<n_tiles, block_q, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      queries, cands, croot, starts_blk, nblk, active, n_active, eps2,
      n_tiles, nc, max_blocks, block_k, minroot);
  return static_cast<int>(cudaGetLastError());
}

int pairwise_sweep_launch(int device, const float* queries,
                          const float* cands, const int* croot, float eps2,
                          int nq, int block_q, int nc, int block_c,
                          int* counts, int* minroot, void* stream) {
  if (nq == 0) return 0;
  const size_t smem = static_cast<size_t>(block_c) * sizeof(float4);
  cudaError_t err = repro::prepare(device, pairwise_sweep_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pairwise_sweep_kernel<<<nq / block_q, block_q, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      queries, cands, croot, eps2, nc, block_c, counts, minroot);
  return static_cast<int>(cudaGetLastError());
}

const char* csr_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
