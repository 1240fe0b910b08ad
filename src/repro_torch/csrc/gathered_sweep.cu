// The grid-hash engine's ε-sweeps for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gathered_sweep.py gathered_sweep (def :55) -> gathered_sweep_kernel
// and, for the engine's sweep, the window gather that fed it:
//   hash_sweep_kernel reads the (H, C) bucket table itself.
//
// Contracts:
//   gathered_sweep (identical to the reference): query row r (of the
//     row-major (b, 3) query array) sweeps its own window of k candidates,
//     row r of each plane of the planar (3, b, k) candidate array, with
//     payload croot (b, k) = root if the candidate is valid and core, else
//     INT32_MAX. Invalid and padded candidates carry +1e30 coordinates.
//     Per row: the count of window candidates with d2 <= eps2 and the min
//     croot over those hits (INT32_MAX when none).
//   hash_sweep: the engine's whole sweep in one launch. Query i (row i of
//     the (n, 3) query array, original order) sweeps the occupied slots of
//     the buckets of its window: buckets[i, o] for each offset o with
//     cell_valid[i, o]. Bucket h holds its points at slots h*C + 0 ..
//     h*C + occ[h] - 1 of the (H, C, 3) table (build_grid writes a bucket's
//     points at slots h*C + rank, so the valid slots are a prefix). Per
//     query: the count of those slots with d2 <= eps2 and the min of
//     root[j] over the hits whose point j = index[h*C + s] is core
//     (INT32_MAX when none), written at row i. This is gathered_sweep over
//     the windows the engine used to gather, bit for bit: a padded slot and
//     every slot of a bucket with cell_valid false reach gathered_sweep as
//     +1e30 coordinates, whose d2 to a query of the engine (finite, far
//     below 1e29 in magnitude) overflows to +inf, never <= eps2.
// d2 is sweep_common.cuh's dist2_rn, compared with <= eps2 (eps2 rounded
// once to f32 by the caller).
//
// What bounds them on this card.
//   gathered_sweep: memory. Each query has its own window, so no candidate
//   is reused across queries: every pair reads 16 bytes (three f32
//   coordinates and the int32 payload) for 10 FP32 operations, under one
//   operation per byte against a ridge point of about 20. The design
//   streams the window at full width and keeps nothing else out of
//   registers: one warp per query row, the query's coordinates in
//   registers; each lane reads 4 consecutive candidates of each plane and
//   of croot as one 16-byte load, so a warp reads 512 contiguous bytes per
//   plane per step, coalesced along k (k is a multiple of 4 and the rows
//   are 16-byte aligned: the wrapper checks both); loads bypass L1
//   residency (__ldcs, read once); count and min reduce across the warp
//   with __reduce_add_sync / __reduce_min_sync, and lane 0 writes the row.
//   Its caller pads every window to 9 or 27 buckets x C slots, C the
//   fullest bucket's occupancy, so most of the pairs it tests are padding.
//   hash_sweep: FP32 lane throughput over the occupied pairs only (each a
//   dist2_rn: 9 unfused FP32 instructions and a compare). Each point is
//   read once from device memory; the table's occupied slots (n x 12
//   bytes) fit in the 50 MB L2, where the rereads of a slot by the queries
//   of neighbouring cells are served. The design:
//   * one thread per query, the threads of a block taking consecutive
//     queries of the bucket-major visiting order (Grid.order), so a warp's
//     queries mostly share one home cell and with it one window: their
//     loads of a slot are one broadcast;
//   * the query's coordinates, count and min in registers, each output row
//     written once; no window buffer, no padding, no chunk loop;
//   * index, core and root are read only for a hit.
// Staging a window in shared memory was not tried: no profiler on the card
// used reads the L2 traffic, and the visiting order shows what sharing
// windows within a warp is worth (in the identity order, where a warp's
// queries lie in unrelated cells, the sweep is 1.4x / 3.8x slower at the
// smoke's roadnet2d / iono3d; PERF.md).

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

constexpr int kHashThreads = 256;

__global__ void hash_sweep_kernel(const float* __restrict__ queries,
                                  const int* __restrict__ order,
                                  const int* __restrict__ buckets,
                                  const unsigned char* __restrict__ cell_valid,
                                  const float* __restrict__ gpoints,
                                  const int* __restrict__ gindex,
                                  const int* __restrict__ occupancy,
                                  const unsigned char* __restrict__ core,
                                  const int* __restrict__ root, float eps2,
                                  int n, int n_off, int cap,
                                  int* __restrict__ counts,
                                  int* __restrict__ minroot) {
  const int t = blockIdx.x * kHashThreads + threadIdx.x;
  if (t >= n) return;
  const int64_t i = order[t];
  const float qx = queries[i * 3 + 0];
  const float qy = queries[i * 3 + 1];
  const float qz = queries[i * 3 + 2];
  int cnt = 0;
  int mr = kIntMax;
  for (int o = 0; o < n_off; ++o) {
    if (!cell_valid[i * n_off + o]) continue;
    const int h = buckets[i * n_off + o];
    const int occ = occupancy[h];
    const int64_t base = static_cast<int64_t>(h) * cap;
    const float* p = gpoints + base * 3;
    for (int s = 0; s < occ; ++s) {
      if (repro::dist2_rn(qx, qy, qz, p[3 * s], p[3 * s + 1], p[3 * s + 2]) <=
          eps2) {
        ++cnt;
        const int j = gindex[base + s];
        if (core[j]) mr = min(mr, root[j]);
      }
    }
  }
  counts[i] = cnt;
  minroot[i] = mr;
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

// cell_valid and core are torch.bool (one byte each, 0 or 1).
int hash_sweep_launch(int device, const float* queries, const int* order,
                      const int* buckets, const unsigned char* cell_valid,
                      const float* gpoints, const int* gindex,
                      const int* occupancy, const unsigned char* core,
                      const int* root, float eps2, int n, int n_off, int cap,
                      int* counts, int* minroot, void* stream) {
  if (n == 0) return 0;
  cudaError_t err = repro::prepare(device, hash_sweep_kernel, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  hash_sweep_kernel<<<(n + kHashThreads - 1) / kHashThreads, kHashThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      queries, order, buckets, cell_valid, gpoints, gindex, occupancy, core,
      root, eps2, n, n_off, cap, counts, minroot);
  return static_cast<int>(cudaGetLastError());
}

const char* gathered_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
