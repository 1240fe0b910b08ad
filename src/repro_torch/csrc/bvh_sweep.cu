// The BVH engine's kernels for Hopper (sm_90a): one level of the batched
// wavefront traversal, and the Morton codes of the LBVH build.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/bvh_sweep.py bvh_batch_sweep (def :79) -> bvh_batch_sweep_kernel<D, Box>,
//                                                                and bvh_level_kernel<D, Box>
//   src/repro/kernels/morton.py    morton_encode   (def :50) -> morton_encode_kernel<k2d>
//
// Contracts:
//   bvh_batch_sweep (identical to the reference): E entries, each a (query
//     block, child node) pair that carries B queries. Row-major inputs:
//     queries (E, B, D) f32; the pre-dilated prune box dlo / dhi (E, D), f32
//     or bf16 (Box), widened to f32 here; the leaf point pt (E, D) f32;
//     croot / leaf (E,) int32; in payload mode nmin (E,) and bound (E, B)
//     int32, else both null. Per column (e, b):
//       inside  = every coordinate of the query lies in [dlo, dhi], the
//                 query rounded to the nearest bf16 and widened back first
//                 when bf16_prune (the boxes are then outward-rounded bf16
//                 values, so the prune stays conservative);
//       hit     = leaf[e] != 0 and d2(query, pt) <= eps2, exact f32;
//       minroot = croot[e] if hit, else INT32_MAX;
//     per entry: push = leaf[e] == 0 and some column is useful: inside,
//     and in payload mode nmin[e] < bound[e, b]. Dead entries are encoded
//     by the caller (box lo +BIG, hi -BIG, or query -BIG; leaf 0).
//   bvh_level: one whole level of the traversal (core/bvh.py), the same
//     per-column tests on the tree's own arrays. Level l reads the
//     frontier (block, node) of buffer l % 2 and its live count nlive[l]
//     from device memory; it returns at once when that count is 0. Every
//     live parent entry e expands into its two children, each at position
//     p = (e / tile) * 2 * tile + side * tile + e % tile (side 0 for the
//     left child, 1 for the right): the order of the level's child list,
//     per tile its left children, then its right children. A leaf child
//     adds its hits to counts[blk * B + b] (atomicAdd) and its payload to
//     minroot[blk * B + b] (atomicMin): both order-free, so bit-identical
//     to a scatter in any order. An internal child is pushed when a column
//     is useful, against bound, the copy of minroot the caller takes before
//     the level (payload mode). The pushed children go to buffer (l+1) % 2
//     in order of p, the first `capacity` of them; nlive[l+1] gets their
//     count, overflow is set when more than `capacity` push (and then,
//     with stop_on_overflow, nlive[l+1] is 0, which ends the traversal),
//     and hist[l] gets nlive[l].
//   morton_encode: (n, 3) int32 quantized coordinates -> (n,) int32 30-bit
//     Z-order codes, 15 bits per axis of x and y when dims == 2 (z
//     ignored), else 10 bits per axis of x, y and z (the reference oracle's
//     choice, ref.morton_encode_ref), with the input masks & 0x7FFF /
//     & 0x3FF and the magic-number shift and mask chains of the reference.
// d2 is accumulated in ascending coordinate order, acc = acc + d * d from
// acc = 0, d = q - p, every operation rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn, and -fmad=false besides): ref._dist2's arithmetic.
//
// What bounds them on this card: memory. An entry of bvh_batch_sweep reads
// 4*B*D (queries) + 2*s*D (box, s = 2 for bf16, 4 for f32) + 4*D + 8 bytes,
// and 4 + 4*B more in payload mode, and writes 8*B + 4 (196 and 68 at
// B = 8, D = 3, bf16 boxes, no payload) for about 10*B*D operations, under
// one operation per byte against a ridge point of about 20; morton_encode
// reads 12 bytes and writes 4 per point for a few dozen integer
// operations. bvh_batch_sweep streams each input once and keeps nothing out
// of registers: one thread per entry (per point); the entry's box, leaf
// point and payload in registers, reused by its B columns; push is the OR
// of its columns; D and the box type are template parameters (1..8; f32 or
// bf16), so the coordinate loops unroll and bf16 boxes cross memory at 2
// bytes a coordinate. Its caller must gather every entry's inputs into
// device memory first and scatter its outputs after, which moves more
// bytes than the kernel does; bvh_level does away with both:
//   * a parent entry's bytes: its frontier ids (8), its children's ids (8),
//     and per child the box (2*s*D) of an internal one or the point and
//     payload (4*D + 4) of a leaf; the query block once (4*B*D, from L2:
//     a block's entries are many); in payload mode the node min (4) and
//     the block's bounds (4*B); and 8 bytes per push written. Hits go to
//     counts and minroot by atomics, nothing per column is written;
//   * a persistent grid (as many blocks as fit on the card at once) takes
//     units of kUnit consecutive child positions in order by an atomic
//     ticket, kItems a thread. The pushes are compacted in position order
//     by a single-pass chained scan (decoupled look-back): a unit
//     publishes its push count, then warp 0 sums its predecessors' counts
//     32 at a time until it meets one that published its inclusive prefix,
//     and publishes its own. A unit's predecessors hold earlier tickets, so
//     they are resident and never wait on it. The status words carry the
//     level's number, so one zeroing serves a whole traversal;
//   * the live count, the frontier and the overflow flag never leave the
//     card: the host learns that the traversal ended from asynchronous
//     copies of earlier levels' counts.

#include <cuda_bf16.h>

#include <algorithm>

#include "sweep_common.cuh"

namespace {

using repro::kIntMax;

constexpr int kThreads = 256;
constexpr int kMaxDims = 8;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int D, typename Box>
__global__ void bvh_batch_sweep_kernel(
    const float* __restrict__ queries, const Box* __restrict__ dlo,
    const Box* __restrict__ dhi, const float* __restrict__ pt,
    const int* __restrict__ croot, const int* __restrict__ nmin,
    const int* __restrict__ leaf, const int* __restrict__ bound, float eps2,
    int n_entries, int batch, bool bf16_prune, bool prune_payload,
    int* __restrict__ hit, int* __restrict__ minroot,
    int* __restrict__ push) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_entries) return;
  float lo[D], hi[D], p[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    lo[k] = widen(dlo[e * D + k]);
    hi[k] = widen(dhi[e * D + k]);
    p[k] = pt[e * D + k];
  }
  const bool is_leaf = leaf[e] != 0;
  const int cr = croot[e];
  const int nm = prune_payload ? nmin[e] : 0;
  const float* q = queries + e * batch * D;
  const int64_t row = e * batch;
  bool useful_any = false;
  for (int b = 0; b < batch; ++b) {
    bool inside = true;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float x = q[b * D + k];
      const float xp =
          bf16_prune ? __bfloat162float(__float2bfloat16_rn(x)) : x;
      inside = inside & (xp >= lo[k]) & (xp <= hi[k]);
      const float d = __fsub_rn(x, p[k]);
      acc = __fadd_rn(acc, __fmul_rn(d, d));
    }
    const bool h = is_leaf && acc <= eps2;
    hit[row + b] = h ? 1 : 0;
    minroot[row + b] = h ? cr : kIntMax;
    const bool useful = inside && (!prune_payload || nm < bound[row + b]);
    useful_any = useful_any || useful;
  }
  push[e] = (!is_leaf && useful_any) ? 1 : 0;
}


// One level of the wavefront traversal (see the contract above).
constexpr int kItems = 4;                      // child positions a thread
constexpr int kUnit = kThreads * kItems;       // child positions a unit
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kAggregate = 1, kInclusive = 2;

// A unit's status word: [level + 1 : 8 | flag : 8 | value : 48].
__device__ __forceinline__ unsigned long long status_word(
    int epoch, unsigned long long flag, unsigned long long value) {
  return (static_cast<unsigned long long>(epoch) << 56) | (flag << 48) |
         value;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int d = 16; d > 0; d /= 2) x += __shfl_down_sync(0xffffffffu, x, d);
  return __shfl_sync(0xffffffffu, x, 0);
}

template <int D, typename Box>
__global__ void __launch_bounds__(kThreads) bvh_level_kernel(
    const int* __restrict__ fb_in, const int* __restrict__ fn_in,
    int* __restrict__ nlive, int level, const int* __restrict__ left,
    const int* __restrict__ right, const Box* __restrict__ node_lo,
    const Box* __restrict__ node_hi, const float* __restrict__ pts,
    const int* __restrict__ croot_leaf, const int* __restrict__ node_min,
    const int* __restrict__ bound, const float* __restrict__ qblocks,
    float eps2, int n_leaves, int batch, int tile, int capacity,
    bool bf16_prune, bool prune_payload, bool stop_on_overflow,
    int* __restrict__ counts, int* __restrict__ minroot,
    int* __restrict__ fb_out, int* __restrict__ fn_out,
    int* __restrict__ overflow, int* __restrict__ hist,
    unsigned long long* __restrict__ status, int* __restrict__ tickets) {
  __shared__ long long s_unit;
  __shared__ int s_warp[kItems][kWarps];
  __shared__ long long s_excl;
  const int n_live = nlive[level];
  if (n_live == 0) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) hist[level] = n_live;
  const int64_t n_pos =
      2 * ((static_cast<int64_t>(n_live) + tile - 1) / tile) * tile;
  const int64_t n_units = (n_pos + kUnit - 1) / kUnit;
  const int n_int = n_leaves - 1;
  const int epoch = level + 1;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (;;) {
    if (threadIdx.x == 0) s_unit = atomicAdd(&tickets[level], 1);
    __syncthreads();
    const int64_t u = s_unit;
    if (u >= n_units) return;  // the whole block leaves together
    bool push[kItems];
    int pblk[kItems], pchild[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      push[k] = false;
      const int64_t p = u * kUnit + k * kThreads + threadIdx.x;
      const int64_t t = p / (2 * tile);
      const int64_t r = p - t * 2 * tile;
      const bool side = r >= tile;
      const int64_t e = t * tile + (side ? r - tile : r);
      if (p >= n_pos || e >= n_live) continue;
      const int blk = fb_in[e];
      const int node = fn_in[e];
      const int child = side ? right[node] : left[node];
      pblk[k] = blk;
      pchild[k] = child;
      const float* q = qblocks + static_cast<int64_t>(blk) * batch * D;
      const int64_t row = static_cast<int64_t>(blk) * batch;
      if (child >= n_int) {  // a leaf: refine, hits to the block's rows
        const int64_t lid = child - n_int;
        float pt[D];
#pragma unroll
        for (int c = 0; c < D; ++c) pt[c] = pts[lid * D + c];
        const int cr = croot_leaf[lid];
        for (int b = 0; b < batch; ++b) {
          float acc = 0.0f;
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const float d = __fsub_rn(q[b * D + c], pt[c]);
            acc = __fadd_rn(acc, __fmul_rn(d, d));
          }
          if (acc <= eps2) {
            atomicAdd(&counts[row + b], 1);
            if (cr != kIntMax) atomicMin(&minroot[row + b], cr);
          }
        }
      } else {  // internal: prune, push when a column is useful
        float lo[D], hi[D];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          lo[c] = widen(node_lo[static_cast<int64_t>(child) * D + c]);
          hi[c] = widen(node_hi[static_cast<int64_t>(child) * D + c]);
        }
        const int nm = prune_payload ? node_min[child] : 0;
        bool useful = false;
        for (int b = 0; b < batch && !useful; ++b) {
          bool inside = true;
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const float x = q[b * D + c];
            const float xp =
                bf16_prune ? __bfloat162float(__float2bfloat16_rn(x)) : x;
            inside = inside & (xp >= lo[c]) & (xp <= hi[c]);
          }
          useful = inside && (!prune_payload || nm < bound[row + b]);
        }
        push[k] = useful;
      }
    }
    // push counts per (item, warp), in position order
    unsigned ballot[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      ballot[k] = __ballot_sync(0xffffffffu, push[k]);
      if (lane == 0) s_warp[k][warp] = __popc(ballot[k]);
    }
    __syncthreads();
    if (warp == 0) {
      unsigned long long agg = 0;
      for (int x = lane; x < kItems * kWarps; x += 32)
        agg += s_warp[x / kWarps][x % kWarps];
      agg = warp_sum(agg);
      unsigned long long excl = 0;
      if (lane == 0)
        atomicExch(&status[u], status_word(epoch, u == 0 ? kInclusive
                                                         : kAggregate, agg));
      // look-back: lane i reads unit j - i; a unit before 0 counts as an
      // inclusive 0
      for (int64_t j = u - 1; j >= 0; j -= 32) {
        const int64_t idx = j - lane;
        unsigned long long flag = kInclusive, val = 0;
        if (idx >= 0) {
          unsigned long long w;
          do {
            w = *reinterpret_cast<volatile unsigned long long*>(&status[idx]);
          } while (static_cast<int>(w >> 56) != epoch ||
                   ((w >> 48) & 0xff) == 0);
          flag = (w >> 48) & 0xff;
          val = w & ((1ull << 48) - 1);
        }
        const unsigned incl = __ballot_sync(0xffffffffu, flag == kInclusive);
        const int first = incl ? __ffs(incl) - 1 : 31;
        excl += warp_sum(lane <= first ? val : 0);
        if (incl) break;
      }
      if (lane == 0) {
        if (u > 0)
          atomicExch(&status[u], status_word(epoch, kInclusive, excl + agg));
        s_excl = static_cast<long long>(excl);
        if (u == n_units - 1) {  // the level's last unit: the total
          const long long total = static_cast<long long>(excl + agg);
          const bool over = total > capacity;
          if (over) *overflow = 1;
          nlive[level + 1] = over && stop_on_overflow
                                 ? 0
                                 : static_cast<int>(over ? capacity : total);
        }
      }
    }
    __syncthreads();
    long long pos = s_excl;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      long long mine = pos;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) mine += s_warp[k][w];
        pos += s_warp[k][w];
      }
      mine += __popc(ballot[k] & ((1u << lane) - 1));
      if (push[k] && mine < capacity) {
        fb_out[mine] = pblk[k];
        fn_out[mine] = pchild[k];
      }
    }
    __syncthreads();  // s_warp and s_excl are rewritten by the next unit
  }
}

template <bool k2d>
__global__ void morton_encode_kernel(const int* __restrict__ coords, int n,
                                     int* __restrict__ codes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = static_cast<uint32_t>(coords[i * 3 + 0]);
  const uint32_t y = static_cast<uint32_t>(coords[i * 3 + 1]);
  uint32_t code;
  if (k2d) {
    code = repro::morton2(x, y);
  } else {
    const uint32_t z = static_cast<uint32_t>(coords[i * 3 + 2]);
    code = repro::morton3(x, y, z);
  }
  codes[i] = static_cast<int>(code);
}

template <int D, typename Box>
cudaError_t launch_sweep(int device, const float* queries, const void* dlo,
                         const void* dhi, const float* pt, const int* croot,
                         const int* nmin, const int* leaf, const int* bound,
                         float eps2, int n_entries, int batch, bool bf16_prune,
                         bool prune_payload, int* hit, int* minroot,
                         int* push, cudaStream_t stream) {
  cudaError_t err = repro::prepare(device, bvh_batch_sweep_kernel<D, Box>, 0);
  if (err != cudaSuccess) return err;
  const int blocks = (n_entries + kThreads - 1) / kThreads;
  bvh_batch_sweep_kernel<D, Box><<<blocks, kThreads, 0, stream>>>(
      queries, static_cast<const Box*>(dlo), static_cast<const Box*>(dhi),
      pt, croot, nmin, leaf, bound, eps2, n_entries, batch, bf16_prune,
      prune_payload, hit, minroot, push);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dims(int device, const float* queries, const void* dlo,
                        const void* dhi, const float* pt, const int* croot,
                        const int* nmin, const int* leaf, const int* bound,
                        float eps2, int n_entries, int batch, bool box_bf16,
                        bool bf16_prune, bool prune_payload, int* hit,
                        int* minroot, int* push, cudaStream_t stream) {
  if (box_bf16)
    return launch_sweep<D, __nv_bfloat16>(
        device, queries, dlo, dhi, pt, croot, nmin, leaf, bound, eps2,
        n_entries, batch, bf16_prune, prune_payload, hit, minroot, push,
        stream);
  return launch_sweep<D, float>(device, queries, dlo, dhi, pt, croot, nmin,
                                leaf, bound, eps2, n_entries, batch,
                                bf16_prune, prune_payload, hit, minroot, push,
                                stream);
}

template <int D, typename Box>
cudaError_t launch_level(int device, const int* fb_in, const int* fn_in,
                         int* nlive, int level, const int* left,
                         const int* right, const void* node_lo,
                         const void* node_hi, const float* pts,
                         const int* croot_leaf, const int* node_min,
                         const int* bound, const float* qblocks, float eps2,
                         int n_leaves, int batch, int tile, int capacity,
                         bool bf16_prune, bool prune_payload,
                         bool stop_on_overflow, int* counts, int* minroot,
                         int* fb_out, int* fn_out, int* overflow, int* hist,
                         unsigned long long* status, int* tickets,
                         cudaStream_t stream) {
  const auto kernel = bvh_level_kernel<D, Box>;
  cudaError_t err = repro::prepare(device, kernel, 0);
  if (err != cudaSuccess) return err;
  int n_sm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  // at most 2 * capacity child positions: no more units than that
  const int64_t max_units = (2 * static_cast<int64_t>(capacity) + kUnit - 1) /
                            kUnit;
  const int blocks = static_cast<int>(
      std::min<int64_t>(std::max(per_sm, 1) * n_sm, std::max<int64_t>(
                                                        max_units, 1)));
  kernel<<<blocks, kThreads, 0, stream>>>(
      fb_in, fn_in, nlive, level, left, right, static_cast<const Box*>(node_lo),
      static_cast<const Box*>(node_hi), pts, croot_leaf, node_min, bound,
      qblocks, eps2, n_leaves, batch, tile, capacity, bf16_prune,
      prune_payload, stop_on_overflow, counts, minroot, fb_out, fn_out,
      overflow, hist, status, tickets);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on success. They launch on `stream`,
// do not synchronise and allocate nothing.

// dlo / dhi are bf16 when box_bf16, else f32. nmin and bound are read
// only when prune_payload, and may be null otherwise.
int bvh_batch_sweep_launch(int device, const float* queries, const void* dlo,
                           const void* dhi, const float* pt,
                           const int* croot, const int* nmin, const int* leaf,
                           const int* bound, float eps2, int n_entries,
                           int batch, int dims, int box_bf16, int bf16_prune,
                           int prune_payload, int* hit, int* minroot,
                           int* push, void* stream) {
  if (n_entries == 0) return 0;
  const bool pp = prune_payload != 0;
  if (dims < 1 || dims > kMaxDims || batch < 1 ||
      (pp && (nmin == nullptr || bound == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool bb = box_bf16 != 0;
  const bool bf = bf16_prune != 0;
#define REPRO_BVH_CASE(DIMS)                                                 \
  case DIMS:                                                                 \
    return static_cast<int>(launch_dims<DIMS>(                               \
        device, queries, dlo, dhi, pt, croot, nmin, leaf, bound, eps2,       \
        n_entries, batch, bb, bf, pp, hit, minroot, push, s));
  switch (dims) {
    REPRO_BVH_CASE(1)
    REPRO_BVH_CASE(2)
    REPRO_BVH_CASE(3)
    REPRO_BVH_CASE(4)
    REPRO_BVH_CASE(5)
    REPRO_BVH_CASE(6)
    REPRO_BVH_CASE(7)
    REPRO_BVH_CASE(8)
  }
#undef REPRO_BVH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The arrays of one traversal: fb_in / fn_in and fb_out / fn_out (capacity,)
// int32 frontier buffers (block, node); nlive (levels + 1,) int32; hist
// (levels,) int32; overflow (1,) int32; status, one 8-byte word per unit of
// kUnit child positions (2 * capacity / kUnit rounded up), and tickets
// (levels,) int32, both zeroed once per traversal. node_lo / node_hi are
// bf16 when box_bf16, else f32, over the (2n - 1) node ids; node_min and
// bound are read only when prune_payload, and may be null otherwise.
int bvh_level_launch(int device, const int* fb_in, const int* fn_in,
                     int* nlive, int level, const int* left, const int* right,
                     const void* node_lo, const void* node_hi,
                     const float* pts, const int* croot_leaf,
                     const int* node_min, const int* bound,
                     const float* qblocks, float eps2, int n_leaves, int dims,
                     int batch, int tile, int capacity, int box_bf16,
                     int bf16_prune, int prune_payload, int stop_on_overflow,
                     int* counts, int* minroot, int* fb_out, int* fn_out,
                     int* overflow, int* hist, void* status, int* tickets,
                     void* stream) {
  const bool pp = prune_payload != 0;
  if (dims < 1 || dims > kMaxDims || batch < 1 || tile < 1 ||
      capacity < 1 || n_leaves < 2 ||
      (pp && (node_min == nullptr || bound == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool bf = bf16_prune != 0;
  const bool st = stop_on_overflow != 0;
  auto* words = static_cast<unsigned long long*>(status);
#define REPRO_LEVEL_CASE(DIMS)                                               \
  case DIMS:                                                                 \
    return static_cast<int>(                                                 \
        box_bf16 ? launch_level<DIMS, __nv_bfloat16>(                        \
                       device, fb_in, fn_in, nlive, level, left, right,      \
                       node_lo, node_hi, pts, croot_leaf, node_min, bound,   \
                       qblocks, eps2, n_leaves, batch, tile, capacity, bf,   \
                       pp, st, counts, minroot, fb_out, fn_out, overflow,    \
                       hist, words, tickets, s)                              \
                 : launch_level<DIMS, float>(                                \
                       device, fb_in, fn_in, nlive, level, left, right,      \
                       node_lo, node_hi, pts, croot_leaf, node_min, bound,   \
                       qblocks, eps2, n_leaves, batch, tile, capacity, bf,   \
                       pp, st, counts, minroot, fb_out, fn_out, overflow,    \
                       hist, words, tickets, s));
  switch (dims) {
    REPRO_LEVEL_CASE(1)
    REPRO_LEVEL_CASE(2)
    REPRO_LEVEL_CASE(3)
    REPRO_LEVEL_CASE(4)
    REPRO_LEVEL_CASE(5)
    REPRO_LEVEL_CASE(6)
    REPRO_LEVEL_CASE(7)
    REPRO_LEVEL_CASE(8)
  }
#undef REPRO_LEVEL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int morton_encode_launch(int device, const int* coords, int n, int dims,
                         int* codes, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dims == 2) {
    err = repro::prepare(device, morton_encode_kernel<true>, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    morton_encode_kernel<true><<<blocks, kThreads, 0, s>>>(coords, n, codes);
  } else {
    err = repro::prepare(device, morton_encode_kernel<false>, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    morton_encode_kernel<false><<<blocks, kThreads, 0, s>>>(coords, n, codes);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bvh_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
