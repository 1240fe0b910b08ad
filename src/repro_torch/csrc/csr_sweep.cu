// Slab ε-sweeps for Hopper (sm_90a): the inner loops of the grid engine
// (cell-sorted CSR slabs), of its frontier round driver, of the serving
// tier's cross-corpus queries, and of the brute engine. The four slab
// sweeps skip the candidate runs that cannot hold a hit and share one
// boxes / cull / sweep design; the brute engine's sweep walks every block.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/csr_sweep.py      csr_sweep        (def :146)  -> csr_sweep_kernel<kCsr>
//   src/repro/kernels/csr_sweep.py      csr_sweep_counts (def :102)  -> csr_sweep_kernel<kCounts>
//   src/repro/kernels/frontier_sweep.py frontier_sweep   (def :65)   -> csr_sweep_kernel<kFrontier>
//   src/repro/kernels/cross_sweep.py    cross_sweep      (def :94)   -> csr_sweep_kernel<kCross>
//   src/repro/kernels/pairwise_sweep.py pairwise_sweep   (def :68)   -> pairwise_sweep_kernel
// (each slab sweep with run_boxes_kernel and csr_cull_kernel<mode> before
// it).
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
//   cross_sweep: the csr_sweep slab sweep for fresh queries against a
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
// pairwise_sweep (walk_blocks below): one thread block per query tile, one
// query per thread, its coordinates in registers for the whole walk; each
// candidate block staged once in shared memory as float4 (x, y, z, croot
// bits), so the inner loop issues one broadcast LDS.128 per pair; counts
// and min-root in registers, written once. The brute engine tests every
// pair by design, so nothing is skipped: it is bound by FP32 lane
// throughput over all pairs, each pair costing 3 FSUB, 3 FMUL, 2 FADD and
// a compare (9 FP32-pipe instructions, -fmad=false forbidding fusion).
//
// The slab sweeps skip the candidates that cannot hold a hit. A tile's slab
// is a contiguous Morton range that spans 40-46% of the sorted array at the
// smoke's full sizes, and under 2% of its pairs lie in runs whose box comes
// within eps of the tile's box. Three launches:
//   1. run_boxes_kernel: the axis-aligned box (min, max per axis) of every
//      run of G consecutive candidate columns, G = gcd(block_k, RUN) with
//      RUN = 128 (kernels/csr_sweep.py; 128 swept the full-size grids 1.7x
//      faster than 512: fewer pairs kept outweigh 4x the runs to stage and
//      test). Padding columns (+1e30) belong to their run: an all-padding
//      run's box is at +1e30, so its bound overflows to +inf against a
//      finite tile and it is skipped (its pairs' d2 is +inf too).
//   2. csr_cull_kernel: one block per output tile initialises the tile's
//      outputs (counts 0, minroot INT32_MAX, mind2 +inf), reduces the query
//      rows it reads to the tile box, and tests every run of the query
//      tile's slab (after slab_of's clamp): a run is kept when its lower
//      bound lb <= eps2. Each segment of S = kSegRuns = 32 consecutive runs
//      (the width of the kept-run bitmask) that keeps one or more runs
//      becomes a work item (output tile, first run, kept-run bitmask),
//      appended to a device list with an atomic counter. A third counter
//      sums the kept runs (the popcounts of the items' masks), so the host
//      can learn the pairs a sweep tests, runs x G x block_q; the block
//      sums its tile's first and adds once, since one add an item would
//      double the adds on the hot counter line. For
//      frontier_sweep the output tile is slot i and the query tile is
//      active[i]: the block reads n_active and active[i] itself, and a
//      parked slot (i >= n_active, or active[i] outside [0, T)) keeps its
//      INT32_MAX rows and appends nothing, so a parked slot that repeats the
//      last live id never writes into the live slot's rows. A tile of
//      +1e30 query padding rows has a box that reaches 1e30, and keeps the
//      runs its lower corner allows: exact, and the list spreads the work.
//   3. csr_sweep_kernel: a persistent grid (as many blocks as fit on the
//      card at once) drains the list, each block taking the next item by
//      an atomic on a second counter, so the host never learns the item
//      count and no tile, however heavy, sets the sweep's length: its
//      kept runs spread over its items. A block reads the query rows of the
//      item's query tile, stages the item's kept runs through a two-slot
//      shared-memory ring with cp.async (the next run loads while the
//      current one is tested), keeps the float4 layout and the one
//      broadcast LDS.128 per pair, and folds its register partials once an
//      item into the output tile's rows: counts by atomicAdd, min-root by
//      atomicMin, mind2 by atomicMin on its bits. Integer add and min do
//      not depend on order: the outputs are deterministic and bit-identical
//      to the plain versions'.
//
// Why the mind2 fold is exact. A hit's d2 is dist2_rn of real coordinates,
// a sum of squares rounded to nearest: fl(d*d) >= +0 and +0 + +0 = +0, so
// it is >= +0 and never -0; it is never NaN, since a NaN fails <= eps2. For
// such values and for the +inf initial value (0x7f800000), the order of
// their bits as signed int32 is their order as floats, so atomicMin on
// __float_as_int(d2) takes the float min. The skip keeps mind2 exact too:
// mind2 is a min over core hits only, and a skipped run holds no hit.
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
// What bounds the slab sweeps now: the kept pairs at the FP32 issue rate,
// plus the three launches and the item fetches. On an H100 SXM at
// roadnet2d 435K / iono3d 1M, G = 128: csr_sweep keeps 1.24e9 / 6.84e9
// pairs a sweep (1.8% / 1.5% of the slab's), frontier_sweep's first round
// 1.23e9 / 6.84e9; cross_sweep, for an assign of 32,768 fresh points,
// keeps 4.9e8 / 1.8e9 (7.7% / 9.0%: a tile of fresh points spans more of
// the world than a tile of the corpus) in 1,234 / 4,800 work items for the
// persistent grid's 792 blocks, and sweeps them at 60% / 74% of
// frontier_sweep's rate per pair (PERF.md). Left for later work: several
// queries per thread, and boxes kept across the sweeps of one grid.

#include <cmath>

#include "sweep_common.cuh"

namespace {

using repro::kIntMax;

// ---- pairwise_sweep: the staged walk over every block ----

// Walks candidate blocks 0 .. nb - 1 for one query per thread, counting the
// hits and keeping the min payload over them. Every thread of the block
// must call it with the same nb (barriers).
__device__ __forceinline__ void walk_blocks(
    float qx, float qy, float qz, const float* __restrict__ cands,
    const int* __restrict__ croot, int nc, int nb, int block_k, float eps2,
    float4* stage, int& cnt, int& mr) {
  for (int b = 0; b < nb; ++b) {
    const int64_t off = static_cast<int64_t>(b) * block_k;
    __syncthreads();  // every thread is done with the previous block
    for (int i = threadIdx.x; i < block_k; i += blockDim.x)
      stage[i] = make_float4(cands[off + i], cands[nc + off + i],
                             cands[2 * static_cast<int64_t>(nc) + off + i],
                             __int_as_float(croot[off + i]));
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < block_k; ++i) {
      const float4 c = stage[i];
      const bool hit = repro::dist2_rn(qx, qy, qz, c.x, c.y, c.z) <= eps2;
      cnt += hit;
      if (hit) mr = min(mr, __float_as_int(c.w));
    }
  }
}

// ---- the slab sweeps: boxes, cull, balanced sweep ----

// What a slab sweep computes, by its public function.
enum Sweep { kCounts, kCsr, kFrontier, kCross };

// count: counts (hooking drops them); payload: minroot; min_d2: mind2;
// frontier: output slot i reads query tile active[i].
template <Sweep S>
struct Out {
  static constexpr bool count = S != kFrontier;
  static constexpr bool payload = S != kCounts;
  static constexpr bool min_d2 = S == kCross;
  static constexpr bool frontier = S == kFrontier;
};

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

struct Box {
  float4 lo, hi;  // .w unused
};

// A work item: `kept` bit j set when run run0 + j is kept for output tile
// `slot` (the query tile itself, or for frontier_sweep the frontier slot,
// whose query tile is active[slot]).
struct Item {
  int slot, run0;
  unsigned kept;
};

// counters[0]: items appended; counters[1]: items taken; counters[2]:
// kept runs, summed over the items appended.
constexpr int kCounters = 3;
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

// One block per output tile (frontier slot), blockDim = block_q rounded up
// to a warp (thread i < block_q owns row i): the outputs' initial values,
// the query tile's box, and the work items of its kept runs.
template <Sweep S>
__global__ void csr_cull_kernel(const float* __restrict__ queries,
                                const int* __restrict__ starts_blk,
                                const int* __restrict__ nblk,
                                const int* __restrict__ active,
                                const int* __restrict__ n_active,
                                const Box* __restrict__ boxes, float eps2,
                                int n_tiles, int block_q, int nc,
                                int max_blocks, int block_k, int run,
                                int* __restrict__ counts,
                                int* __restrict__ minroot,
                                float* __restrict__ mind2,
                                Item* __restrict__ items,
                                int* __restrict__ counters) {
  using O = Out<S>;
  __shared__ float part[6][32];
  __shared__ Box tile_box;
  __shared__ int tile_kept;
  const int slot = blockIdx.x;
  if (threadIdx.x < block_q) {
    const int64_t row = static_cast<int64_t>(slot) * block_q + threadIdx.x;
    if (O::count) counts[row] = 0;
    if (O::payload) minroot[row] = kIntMax;
    if (O::min_d2) mind2[row] = INFINITY;
  }
  int t = slot;
  if (O::frontier) {
    t = active[slot];
    // parked: its INT32_MAX rows are final. Uniform over the block, so the
    // return skips no barrier.
    if (slot >= *n_active || t < 0 || t >= n_tiles) return;
  }
  float lx = INFINITY, ly = INFINITY, lz = INFINITY;
  float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY;
  if (threadIdx.x < block_q) {
    const int64_t row = static_cast<int64_t>(t) * block_q + threadIdx.x;
    const float x = queries[row * 3 + 0];
    const float y = queries[row * 3 + 1];
    const float z = queries[row * 3 + 2];
    lx = fminf(lx, x), ly = fminf(ly, y), lz = fminf(lz, z);
    hx = fmaxf(hx, x), hy = fmaxf(hy, y), hz = fmaxf(hz, z);
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
    if (lane == 0) {
      tile_box = Box{make_float4(lx, ly, lz, 0.0f),
                     make_float4(hx, hy, hz, 0.0f)};
      tile_kept = 0;
    }
  }
  __syncthreads();
  int sb, nb;
  slab_of(starts_blk, nblk, t, nc, max_blocks, block_k, sb, nb);
  const int per_block = block_k / run;
  const int first = sb * per_block, n_runs = nb * per_block;
  const int n_segs = (n_runs + kSegRuns - 1) / kSegRuns;
  const Box q = tile_box;
  int kept_runs = 0;
  for (int s = threadIdx.x; s < n_segs; s += blockDim.x) {
    const int r0 = s * kSegRuns;
    const int m = min(kSegRuns, n_runs - r0);
    unsigned kept = 0;
    for (int j = 0; j < m; ++j) {
      const Box c = boxes[first + r0 + j];
      if (box_lb(q.lo, q.hi, c.lo, c.hi) <= eps2) kept |= 1u << j;
    }
    if (kept) {
      items[atomicAdd(&counters[0], 1)] = Item{slot, first + r0, kept};
      kept_runs += __popc(kept);
    }
  }
  // the tile's kept runs: a sum a warp (every warp is whole), one shared
  // add a warp, one global add a block
  kept_runs = __reduce_add_sync(0xffffffffu, kept_runs);
  if (lane == 0 && kept_runs) atomicAdd(&tile_kept, kept_runs);
  __syncthreads();
  if (threadIdx.x == 0 && tile_kept) atomicAdd(&counters[2], tile_kept);
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
template <Sweep S>
__global__ void csr_sweep_kernel(const float* __restrict__ queries,
                                 const float* __restrict__ cands,
                                 const int* __restrict__ croot,
                                 const int* __restrict__ active,
                                 const Item* __restrict__ items,
                                 int* __restrict__ counters, float eps2,
                                 int nc, int run, int* __restrict__ counts,
                                 int* __restrict__ minroot,
                                 float* __restrict__ mind2) {
  using O = Out<S>;
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
    if (it.slot < 0) return;  // uniform over the block
    // the cull appended items of live slots only, so active[slot] is a tile
    const int t = O::frontier ? active[it.slot] : it.slot;
    const int64_t q_row = static_cast<int64_t>(t) * blockDim.x + threadIdx.x;
    const int64_t row =
        static_cast<int64_t>(it.slot) * blockDim.x + threadIdx.x;
    const float qx = queries[q_row * 3 + 0];
    const float qy = queries[q_row * 3 + 1];
    const float qz = queries[q_row * 3 + 2];
    int cnt = 0;
    int mr = kIntMax;
    float md = INFINITY;
    unsigned kept = it.kept;  // != 0, the same in every thread
    int slot = 0;
    stage_run<O::payload>(cands, croot, nc, run, it.run0 + __ffs(kept) - 1,
                          stage);
    kept &= kept - 1;
    for (;;) {
      const bool more = kept != 0;
      if (more) {  // the next kept run loads while this one is tested
        stage_run<O::payload>(cands, croot, nc, run,
                              it.run0 + __ffs(kept) - 1,
                              stage + (slot ^ 1) * run);
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
        // one d2 per pair, for the hit test and the min alike
        const float d2 = repro::dist2_rn(qx, qy, qz, p.x, p.y, p.z);
        const bool hit = d2 <= eps2;
        if (O::count) cnt += hit;
        if (O::payload && hit) mr = min(mr, __float_as_int(p.w));
        if (O::min_d2 && hit && __float_as_int(p.w) != kIntMax)
          md = fminf(md, d2);
      }
      __syncthreads();  // every thread is done with the slot before reuse
      if (!more) break;
      slot ^= 1;
    }
    if (O::count && cnt) atomicAdd(&counts[row], cnt);
    if (O::payload && mr != kIntMax) atomicMin(&minroot[row], mr);
    // d2 >= +0 and never NaN: int order is float order (see the note)
    if (O::min_d2 && md != INFINITY)
      atomicMin(reinterpret_cast<int*>(mind2) + row, __float_as_int(md));
  }
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
  walk_blocks(queries[row * 3 + 0], queries[row * 3 + 1],
              queries[row * 3 + 2], cands, croot, nc, nc / block_c, block_c,
              eps2, stage, cnt, mr);
  counts[row] = cnt;
  minroot[row] = mr;
}

// The three launches of a slab sweep. `active` and `n_active` are read by
// frontier_sweep's cull alone; outputs a sweep does not compute are null.
template <Sweep S>
int launch_sweep(int device, const float* queries, const float* cands,
                 const int* croot, const int* starts_blk, const int* nblk,
                 const int* active, const int* n_active, float eps2,
                 int n_tiles, int block_q, int nc, int max_blocks,
                 int block_k, int run, int* counts, int* minroot,
                 float* mind2, void* boxes_, void* items_, int* counters,
                 void* stream) {
  if (n_tiles == 0) return 0;
  Box* boxes = static_cast<Box*>(boxes_);
  Item* items = static_cast<Item*>(items_);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * static_cast<size_t>(run) * sizeof(float4);
  cudaError_t err = repro::prepare(device, csr_sweep_kernel<S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, csr_sweep_kernel<S>, block_q, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_runs = nc / run;
  run_boxes_kernel<<<(n_runs + 7) / 8, 256, 0, s>>>(cands, nc, run, n_runs,
                                                     boxes, counters);
  csr_cull_kernel<S><<<n_tiles, (block_q + 31) / 32 * 32, 0, s>>>(
      queries, starts_blk, nblk, active, n_active, boxes, eps2, n_tiles,
      block_q, nc, max_blocks, block_k, run, counts, minroot, mind2, items,
      counters);
  csr_sweep_kernel<S><<<max(per_sm, 1) * n_sm, block_q, smem, s>>>(
      queries, cands, croot, active, items, counters, eps2, nc, run, counts,
      minroot, mind2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launch function returns a cudaError_t code: 0 on success. It
// launches on `stream`, does not synchronise and allocates nothing: the
// slab sweeps take their scratch (`boxes`: 8 floats a run, `items`: 3 ints
// an item, `counters`: 3 ints) from the caller.
int csr_sweep_launch(int device, const float* queries, const float* cands,
                     const int* croot, const int* starts_blk, const int* nblk,
                     float eps2, int n_tiles, int block_q, int nc,
                     int max_blocks, int block_k, int run, int* counts,
                     int* minroot, void* boxes, void* items,
                     int* counters, void* stream) {
  return launch_sweep<kCsr>(device, queries, cands, croot, starts_blk, nblk,
                            nullptr, nullptr, eps2, n_tiles, block_q, nc,
                            max_blocks, block_k, run, counts, minroot,
                            nullptr, boxes, items, counters, stream);
}

int csr_sweep_counts_launch(int device, const float* queries,
                            const float* cands, const int* starts_blk,
                            const int* nblk, float eps2, int n_tiles,
                            int block_q, int nc, int max_blocks, int block_k,
                            int run, int* counts, void* boxes,
                            void* items, int* counters, void* stream) {
  return launch_sweep<kCounts>(device, queries, cands, nullptr, starts_blk,
                               nblk, nullptr, nullptr, eps2, n_tiles,
                               block_q, nc, max_blocks, block_k, run, counts,
                               nullptr, nullptr, boxes, items, counters,
                               stream);
}

int frontier_sweep_launch(int device, const float* queries,
                          const float* cands, const int* croot,
                          const int* starts_blk, const int* nblk,
                          const int* active, const int* n_active, float eps2,
                          int n_tiles, int block_q, int nc, int max_blocks,
                          int block_k, int run, int* minroot, void* boxes,
                          void* items, int* counters, void* stream) {
  return launch_sweep<kFrontier>(device, queries, cands, croot, starts_blk,
                                 nblk, active, n_active, eps2, n_tiles,
                                 block_q, nc, max_blocks, block_k, run,
                                 nullptr, minroot, nullptr, boxes, items,
                                 counters, stream);
}

int cross_sweep_launch(int device, const float* queries, const float* cands,
                       const int* croot, const int* starts_blk,
                       const int* nblk, float eps2, int n_tiles, int block_q,
                       int nc, int max_blocks, int block_k, int run,
                       int* counts, int* minroot, float* mind2, void* boxes,
                       void* items, int* counters, void* stream) {
  return launch_sweep<kCross>(device, queries, cands, croot, starts_blk,
                              nblk, nullptr, nullptr, eps2, n_tiles, block_q,
                              nc, max_blocks, block_k, run, counts, minroot,
                              mind2, boxes, items, counters, stream);
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
