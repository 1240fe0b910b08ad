// Slab ε-sweeps for Hopper (sm_90a): the inner loops of the grid engine
// (cell-sorted CSR slabs), of its frontier round driver, of the serving
// tier's cross-corpus queries, and of the brute engine. The grid engine's
// two sweeps skip the candidate runs that cannot hold a hit; the other
// three share one staged block-walk body.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/csr_sweep.py      csr_sweep        (def :146)  -> csr_sweep_kernel<true>
//   src/repro/kernels/csr_sweep.py      csr_sweep_counts (def :102)  -> csr_sweep_kernel<false>
//   src/repro/kernels/frontier_sweep.py frontier_sweep   (def :65)   -> frontier_sweep_kernel
//   src/repro/kernels/cross_sweep.py    cross_sweep      (def :94)   -> cross_sweep_kernel
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
//   cross_sweep: the csr_sweep slab walk for fresh queries against a
//     frozen corpus whose croot holds the cluster label of core points
//     (INT32_MAX elsewhere). A third output, mind2, is the min d2 over the
//     hits with croot != INT32_MAX (+inf when none), taken over the very
//     d2 values the hit test compared, so it is bit-identical to the plain
//     version's. A tile with nblk = 0 gives 0 / INT32_MAX / +inf.
//   pairwise_sweep: query tile t sweeps every candidate block of the
//     (3, nc) array; counts and min croot over hits.
// d2 is sweep_common.cuh's dist2_rn, compared with <= eps2 (eps2 rounded
// once to f32 by the caller).
//
// frontier_sweep, cross_sweep and pairwise_sweep (walk_blocks below): one
// thread block per query tile (per frontier slot), one query per thread,
// its coordinates in registers for the whole slab walk; each candidate
// block staged once in shared memory as float4 (x, y, z, croot bits), so
// the inner loop issues one broadcast LDS.128 per pair; counts, min-root
// and min-d2 in registers, written once; a parked frontier slot writes its
// INT32_MAX rows and returns before any load. They are bound by FP32 lane
// throughput over every pair of the slab: each pair costs 3 FSUB, 3 FMUL,
// 3 FADD and a compare (9 FP32-pipe instructions, -fmad=false forbidding
// fusion), and every query of the tile reuses each staged 16-byte candidate.
//
// csr_sweep and csr_sweep_counts skip the candidates that cannot hold a
// hit. A tile's slab is a contiguous Morton range that spans 40-46% of the
// sorted array at the smoke's full sizes, and under 2% of its pairs lie
// in runs whose box comes within eps of the tile's box. Three launches:
//   1. run_boxes_kernel: the axis-aligned box (min, max per axis) of every
//      run of G consecutive candidate columns, G = gcd(block_k, RUN) with
//      RUN = 128 (kernels/csr_sweep.py; 128 swept the full-size grids 1.7x
//      faster than 512: fewer pairs kept outweigh 4x the runs to stage and
//      test). Padding columns (+1e30) belong to their run: an all-padding
//      run's box is at +1e30, so its bound overflows to +inf and it is
//      skipped (its pairs' d2 is +inf too).
//   2. csr_cull_kernel: one block per tile reduces its block_q query rows
//      to the tile box, initialises the tile's outputs (0, INT32_MAX), and
//      tests every run of its slab (after slab_of's clamp): a run is kept
//      when its lower bound lb <= eps2. Each segment of S = kSegRuns = 32
//      consecutive runs (the width of the kept-run bitmask) that keeps one
//      or more runs becomes a work item (tile, first run, kept-run
//      bitmask), appended to a device list with an atomic counter.
//   3. csr_sweep_kernel: a persistent grid (as many blocks as fit on the
//      card at once) drains the list, each block taking the next item by
//      an atomic on a second counter, so the host never learns the item
//      count and no tile, however heavy, sets the sweep's length: its
//      kept runs spread over its items. A block stages the item's kept
//      runs through a two-slot shared-memory ring with cp.async (the next
//      run loads while the current one is tested), keeps the float4 layout
//      and the one broadcast LDS.128 per pair, and adds its counts
//      (atomicAdd) and folds its min-root (atomicMin) into the tile's rows.
//      Integer add and min do not depend on order: the outputs are
//      deterministic and bit-identical to the plain versions'.
//
// Why the skip is exact. With the tile box [qlo, qhi] and the run box
// [clo, chi], per axis gap = max(0, qlo - chi, clo - qhi), each difference
// rounded to nearest (__fsub_rn), and lb = ((gx*gx) + gy*gy) + gz*gz with
// __fmul_rn / __fadd_rn: dist2_rn's expression tree. For a pair (q, c) in
// the two boxes, q - c >= qlo - chi and c - q >= clo - qhi exactly, and
// rounding to nearest is monotone and odd, so |fl(q - c)| >= gap on every
// axis; squares of non-negatives and sums are monotone too, so lb <= the
// d2 that dist2_rn computes for every such pair, and lb > eps2 proves
// every pair a miss. The bound is never NaN: fminf/fmaxf drop NaN
// coordinates from the boxes (their pairs miss anyway, d2 being NaN), an
// all-NaN box is the empty box (+inf, -inf), and the gaps are >= 0.
//
// No tensor cores: a wgmma product computes -2 q.c with another rounding,
// so it cannot decide a pair at d2 = eps2 the way the reference's unfused
// acc + d*d does. The FP32 pipe stays.
//
// What bounds csr_sweep[_counts] now: the kept pairs (1.24e9 / 6.84e9 a
// sweep at roadnet2d 435K / iono3d 1M, G = 128; 1.8% / 1.5% of the slab's)
// at the FP32 issue rate, plus the three launches and the item fetches;
// registers 32 (sweep), 40 (cull), 31 (boxes), no spills. Left for later
// work: the same skip in frontier_sweep, cross_sweep and pairwise_sweep,
// several queries per thread, and boxes kept across the sweeps of one grid.

#include <cmath>

#include "sweep_common.cuh"

namespace {

using repro::kIntMax;

// Walks candidate blocks sb .. sb + nb - 1 for one query per thread. Every
// thread of the block must call it with the same sb and nb (barriers).
// kMinD2 also keeps the min d2 over hits with a payload below INT32_MAX.
template <bool kCount, bool kPayload, bool kMinD2 = false>
__device__ __forceinline__ void walk_blocks(
    float qx, float qy, float qz, const float* __restrict__ cands,
    const int* __restrict__ croot, int nc, int sb, int nb, int block_k,
    float eps2, float4* stage, int& cnt, int& mr, float* md = nullptr) {
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
      // one d2 per pair, for the hit test and the min alike
      const float d2 = repro::dist2_rn(qx, qy, qz, c.x, c.y, c.z);
      const bool hit = d2 <= eps2;
      if (kCount) cnt += hit;
      if (kPayload && hit) mr = min(mr, __float_as_int(c.w));
      if (kMinD2 && hit && __float_as_int(c.w) != kIntMax)
        *md = fminf(*md, d2);
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

// ---- csr_sweep / csr_sweep_counts: boxes, cull, balanced sweep ----

struct Box {
  float4 lo, hi;  // .w unused
};

// A work item: `kept` bit j set when run run0 + j is kept for tile `tile`.
struct Item {
  int tile, run0;
  unsigned kept;
};

// counters[0]: items appended; counters[1]: items taken.
constexpr int kCounters = 2;
// S: runs per work item, one bit of Item::kept each (kernels/csr_sweep.py's
// SEG_RUNS sizes the list with it).
constexpr int kSegRuns = 32;

__device__ __forceinline__ float gap_rn(float qlo, float qhi, float clo,
                                        float chi) {
  // max(0, qlo - chi, clo - qhi); fmaxf drops a NaN operand
  return fmaxf(fmaxf(0.0f, __fsub_rn(qlo, chi)), __fsub_rn(clo, qhi));
}

// The lower bound of dist2_rn over the pairs of two boxes (see the note).
__device__ __forceinline__ float box_lb(const float4& qlo, const float4& qhi,
                                        const float4& clo,
                                        const float4& chi) {
  const float gx = gap_rn(qlo.x, qhi.x, clo.x, chi.x);
  const float gy = gap_rn(qlo.y, qhi.y, clo.y, chi.y);
  const float gz = gap_rn(qlo.z, qhi.z, clo.z, chi.z);
  float acc = __fmul_rn(gx, gx);
  acc = __fadd_rn(acc, __fmul_rn(gy, gy));
  acc = __fadd_rn(acc, __fmul_rn(gz, gz));
  return acc;
}

__device__ __forceinline__ void warp_box(float& lx, float& ly, float& lz,
                                         float& hx, float& hy, float& hz) {
  for (int m = 16; m > 0; m >>= 1) {
    lx = fminf(lx, __shfl_xor_sync(0xffffffffu, lx, m));
    ly = fminf(ly, __shfl_xor_sync(0xffffffffu, ly, m));
    lz = fminf(lz, __shfl_xor_sync(0xffffffffu, lz, m));
    hx = fmaxf(hx, __shfl_xor_sync(0xffffffffu, hx, m));
    hy = fmaxf(hy, __shfl_xor_sync(0xffffffffu, hy, m));
    hz = fmaxf(hz, __shfl_xor_sync(0xffffffffu, hz, m));
  }
}

// One warp per run of `run` columns of the planar candidates. Block 0 also
// zeroes the work-list counters.
__global__ void run_boxes_kernel(const float* __restrict__ cands, int nc,
                                 int run, int n_runs, Box* __restrict__ boxes,
                                 int* __restrict__ counters) {
  if (blockIdx.x == 0 && threadIdx.x < kCounters) counters[threadIdx.x] = 0;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= n_runs) return;  // uniform over the warp
  float lx = INFINITY, ly = INFINITY, lz = INFINITY;
  float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY;
  const int64_t off = static_cast<int64_t>(r) * run;
  for (int i = lane; i < run; i += 32) {
    const float x = cands[off + i];
    const float y = cands[nc + off + i];
    const float z = cands[2 * static_cast<int64_t>(nc) + off + i];
    lx = fminf(lx, x), ly = fminf(ly, y), lz = fminf(lz, z);
    hx = fmaxf(hx, x), hy = fmaxf(hy, y), hz = fmaxf(hz, z);
  }
  warp_box(lx, ly, lz, hx, hy, hz);
  if (lane == 0)
    boxes[r] = Box{make_float4(lx, ly, lz, 0.0f), make_float4(hx, hy, hz, 0.0f)};
}

// One block per tile, blockDim = block_q rounded up to a warp (thread i <
// block_q owns row i): the tile box, the outputs' initial values, and the
// work items of the tile's kept runs.
template <bool kPayload>
__global__ void csr_cull_kernel(const float* __restrict__ queries,
                                const int* __restrict__ starts_blk,
                                const int* __restrict__ nblk,
                                const Box* __restrict__ boxes, float eps2,
                                int block_q, int nc, int max_blocks,
                                int block_k, int run,
                                int* __restrict__ counts,
                                int* __restrict__ minroot,
                                Item* __restrict__ items,
                                int* __restrict__ counters) {
  __shared__ float part[6][32];
  __shared__ Box tile_box;
  const int t = blockIdx.x;
  float lx = INFINITY, ly = INFINITY, lz = INFINITY;
  float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY;
  if (threadIdx.x < block_q) {
    const int64_t row = static_cast<int64_t>(t) * block_q + threadIdx.x;
    const float x = queries[row * 3 + 0];
    const float y = queries[row * 3 + 1];
    const float z = queries[row * 3 + 2];
    lx = fminf(lx, x), ly = fminf(ly, y), lz = fminf(lz, z);
    hx = fmaxf(hx, x), hy = fmaxf(hy, y), hz = fmaxf(hz, z);
    counts[row] = 0;
    if (kPayload) minroot[row] = kIntMax;
  }
  warp_box(lx, ly, lz, hx, hy, hz);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = lx, part[1][warp] = ly, part[2][warp] = lz;
    part[3][warp] = hx, part[4][warp] = hy, part[5][warp] = hz;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < (blockDim.x >> 5);
    lx = has ? part[0][lane] : INFINITY;
    ly = has ? part[1][lane] : INFINITY;
    lz = has ? part[2][lane] : INFINITY;
    hx = has ? part[3][lane] : -INFINITY;
    hy = has ? part[4][lane] : -INFINITY;
    hz = has ? part[5][lane] : -INFINITY;
    warp_box(lx, ly, lz, hx, hy, hz);
    if (lane == 0)
      tile_box = Box{make_float4(lx, ly, lz, 0.0f),
                     make_float4(hx, hy, hz, 0.0f)};
  }
  __syncthreads();
  int sb, nb;
  slab_of(starts_blk, nblk, t, nc, max_blocks, block_k, sb, nb);
  const int per_block = block_k / run;
  const int first = sb * per_block, n_runs = nb * per_block;
  const int n_segs = (n_runs + kSegRuns - 1) / kSegRuns;
  const Box q = tile_box;
  for (int s = threadIdx.x; s < n_segs; s += blockDim.x) {
    const int r0 = s * kSegRuns;
    const int m = min(kSegRuns, n_runs - r0);
    unsigned kept = 0;
    for (int j = 0; j < m; ++j) {
      const Box c = boxes[first + r0 + j];
      if (box_lb(q.lo, q.hi, c.lo, c.hi) <= eps2) kept |= 1u << j;
    }
    if (kept) items[atomicAdd(&counters[0], 1)] = Item{t, first + r0, kept};
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Starts the copy of run r (`run` columns) into a stage slot as float4
// (x, y, z, croot bits); without payload .w is left unwritten and unread.
template <bool kPayload>
__device__ __forceinline__ void stage_run(const float* __restrict__ cands,
                                          const int* __restrict__ croot,
                                          int nc, int run, int r,
                                          float4* slot) {
  const int64_t off = static_cast<int64_t>(r) * run;
  for (int i = threadIdx.x; i < run; i += blockDim.x) {
    float* dst = reinterpret_cast<float*>(slot + i);
    cp_async4(dst + 0, cands + off + i);
    cp_async4(dst + 1, cands + nc + off + i);
    cp_async4(dst + 2, cands + 2 * static_cast<int64_t>(nc) + off + i);
    if (kPayload) cp_async4(dst + 3, croot + off + i);
  }
  cp_async_commit();
}

// Persistent: each block takes items until the list is drained. blockDim =
// block_q, one query per thread. Dynamic shared memory: two slots of
// `run` float4.
template <bool kPayload>
__global__ void csr_sweep_kernel(const float* __restrict__ queries,
                                 const float* __restrict__ cands,
                                 const int* __restrict__ croot,
                                 const Item* __restrict__ items,
                                 int* __restrict__ counters, float eps2,
                                 int nc, int run, int* __restrict__ counts,
                                 int* __restrict__ minroot) {
  extern __shared__ float4 stage[];
  __shared__ Item item;
  const int n_items = counters[0];  // final: the cull launch has ended
  for (;;) {
    if (threadIdx.x == 0) {
      const int k = atomicAdd(&counters[1], 1);
      item = k < n_items ? items[k] : Item{-1, 0, 0u};
    }
    __syncthreads();
    const Item it = item;
    __syncthreads();  // every thread has read `item` before it changes
    if (it.tile < 0) return;  // uniform over the block
    const int64_t row = static_cast<int64_t>(it.tile) * blockDim.x + threadIdx.x;
    const float qx = queries[row * 3 + 0];
    const float qy = queries[row * 3 + 1];
    const float qz = queries[row * 3 + 2];
    int cnt = 0;
    int mr = kIntMax;
    unsigned kept = it.kept;  // != 0, the same in every thread
    int slot = 0;
    stage_run<kPayload>(cands, croot, nc, run, it.run0 + __ffs(kept) - 1,
                        stage);
    kept &= kept - 1;
    for (;;) {
      const bool more = kept != 0;
      if (more) {  // the next kept run loads while this one is tested
        stage_run<kPayload>(cands, croot, nc, run,
                            it.run0 + __ffs(kept) - 1, stage + (slot ^ 1) * run);
        kept &= kept - 1;
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // the current slot has landed for every thread
      const float4* c = stage + slot * run;
#pragma unroll 8
      for (int i = 0; i < run; ++i) {
        const float4 p = c[i];
        const float d2 = repro::dist2_rn(qx, qy, qz, p.x, p.y, p.z);
        const bool hit = d2 <= eps2;
        cnt += hit;
        if (kPayload && hit) mr = min(mr, __float_as_int(p.w));
      }
      __syncthreads();  // every thread is done with the slot before reuse
      if (!more) break;
      slot ^= 1;
    }
    if (cnt) atomicAdd(&counts[row], cnt);
    if (kPayload && mr != kIntMax) atomicMin(&minroot[row], mr);
  }
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

__global__ void cross_sweep_kernel(const float* __restrict__ queries,
                                   const float* __restrict__ cands,
                                   const int* __restrict__ croot,
                                   const int* __restrict__ starts_blk,
                                   const int* __restrict__ nblk, float eps2,
                                   int nc, int max_blocks, int block_k,
                                   int* __restrict__ counts,
                                   int* __restrict__ minroot,
                                   float* __restrict__ mind2) {
  extern __shared__ float4 stage[];
  const int t = blockIdx.x;
  const int64_t row = static_cast<int64_t>(t) * blockDim.x + threadIdx.x;
  int sb, nb;
  slab_of(starts_blk, nblk, t, nc, max_blocks, block_k, sb, nb);
  int cnt = 0;
  int mr = kIntMax;
  float md = INFINITY;
  walk_blocks<true, true, true>(queries[row * 3 + 0], queries[row * 3 + 1],
                                queries[row * 3 + 2], cands, croot, nc, sb,
                                nb, block_k, eps2, stage, cnt, mr, &md);
  counts[row] = cnt;
  minroot[row] = mr;
  mind2[row] = md;
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
               int block_k, int run, int* counts, int* minroot,
               Box* boxes, Item* items, int* counters, void* stream) {
  if (n_tiles == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * static_cast<size_t>(run) * sizeof(float4);
  cudaError_t err = repro::prepare(device, csr_sweep_kernel<kPayload>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, csr_sweep_kernel<kPayload>, block_q, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_runs = nc / run;
  run_boxes_kernel<<<(n_runs + 7) / 8, 256, 0, s>>>(cands, nc, run, n_runs,
                                                     boxes, counters);
  csr_cull_kernel<kPayload><<<n_tiles, (block_q + 31) / 32 * 32, 0, s>>>(
      queries, starts_blk, nblk, boxes, eps2, block_q, nc, max_blocks,
      block_k, run, counts, minroot, items, counters);
  csr_sweep_kernel<kPayload><<<max(per_sm, 1) * n_sm, block_q, smem, s>>>(
      queries, cands, croot, items, counters, eps2, nc, run, counts,
      minroot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launch function returns a cudaError_t code: 0 on success. It
// launches on `stream`, does not synchronise and allocates nothing.
int csr_sweep_launch(int device, const float* queries, const float* cands,
                     const int* croot, const int* starts_blk, const int* nblk,
                     float eps2, int n_tiles, int block_q, int nc,
                     int max_blocks, int block_k, int run, int* counts,
                     int* minroot, void* boxes, void* items,
                     int* counters, void* stream) {
  return launch_csr<true>(device, queries, cands, croot, starts_blk, nblk,
                          eps2, n_tiles, block_q, nc, max_blocks, block_k,
                          run, counts, minroot,
                          static_cast<Box*>(boxes), static_cast<Item*>(items),
                          counters, stream);
}

int csr_sweep_counts_launch(int device, const float* queries,
                            const float* cands, const int* starts_blk,
                            const int* nblk, float eps2, int n_tiles,
                            int block_q, int nc, int max_blocks, int block_k,
                            int run, int* counts, void* boxes,
                            void* items, int* counters, void* stream) {
  return launch_csr<false>(device, queries, cands, nullptr, starts_blk, nblk,
                           eps2, n_tiles, block_q, nc, max_blocks, block_k,
                           run, counts, nullptr,
                           static_cast<Box*>(boxes),
                           static_cast<Item*>(items), counters, stream);
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

int cross_sweep_launch(int device, const float* queries, const float* cands,
                       const int* croot, const int* starts_blk,
                       const int* nblk, float eps2, int n_tiles, int block_q,
                       int nc, int max_blocks, int block_k, int* counts,
                       int* minroot, float* mind2, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = static_cast<size_t>(block_k) * sizeof(float4);
  cudaError_t err = repro::prepare(device, cross_sweep_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_sweep_kernel<<<n_tiles, block_q, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      queries, cands, croot, starts_blk, nblk, eps2, nc, max_blocks, block_k,
      counts, minroot, mind2);
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
