// The LBVH build of the BVH engines for Hopper (sm_90a): Morton keys,
// Karras's radix tree, the node boxes and the tree depth, each in one pass
// over the card.
//
// Replaces
//   src/repro/kernels/morton.py morton_encode (def :50), with the
//     quantization before it (src/repro/core/bvh.py build_bvh :111-121)
//                                     -> lbvh_keys_kernel<k2d>
//   src/repro/core/bvh.py build_bvh's node construction (vmap over the
//     internal nodes, three fori_loop searches, :128-168, jnp, no Pallas)
//                                     -> lbvh_nodes_kernel
//   its range min/max table (:170-189, jnp)  -> lbvh_refit_kernel<D>
//   max_leaf_depth (:196, jnp)   -> lbvh_parents_kernel, lbvh_depth_kernel
//
// Contracts (n points, nl = n - 1 internal nodes, n >= 2 for the last
// three; node ids: internal 0..nl-1, leaf i is nl + i):
//   lbvh_keys: points (n, D) f32 row-major, lo and hi (D,) f32 -> codes (n,)
//     int32. Per axis k < min(D, 3): scale = 1023 / (hi - lo) (IEEE
//     division, __fdiv_rn) where hi > lo, else 0; q = (p - lo) * scale
//     (__fsub_rn, __fmul_rn), clamped to [0, 1023], truncated to int32;
//     axes k >= D give q = 0, axes k >= 3 are not read. The code
//     interleaves 15 bits of x and y when dims == 2, else 10 bits of x, y
//     and z, with morton_encode's masks and shift chains. This is the
//     reference's quantization op for op (torch computes the same
//     division for the plain version), then morton_encode.
//   lbvh_nodes: codes (n,) int32, sorted ascending -> left, right, first,
//     last (nl,) int32, parent (2n - 1,) int32 (-1 at the root, node 0),
//     and arrivals (nl,) int32 set to 0 for lbvh_refit. delta(i, j) is
//     -1 for j outside [0, n), else clz(codes[i] ^ codes[j]) when the
//     codes differ, else 32 + clz(i ^ j) (the sorted index breaks ties,
//     Karras's key augmentation; clz(0) = 32). The searches are the
//     reference's, in 64-bit arithmetic: direction d = +1 if delta(i, i+1)
//     >= delta(i, i-1) else -1; lmax doubles from 2 for at most 31 steps
//     while delta(i, i + lmax*d) > delta(i, i - d); l grows by t = lmax/2,
//     lmax/4, ... for 31 steps where delta(i, i + (l+t)*d) stays above
//     it; the split s grows by t = ceil(l / 2^k), k = 1..30, where
//     delta(i, i + (s+t)*d) > delta(i, j), j = i + l*d, until t <= 1.
//     gamma = i + s*d + min(d, 0); first/last = min/max(i, j); a child is
//     the leaf gamma (gamma + 1) when it is the range's end, else the
//     internal node. A search step that cannot change its value any more
//     (the doubling once its test fails, the bisection once t = 0, the
//     split once done) ends the loop: the values are those of every step.
//   lbvh_refit: points (n, D) f32, order (n,) int64 (the sort's
//     permutation), left, right, parent, arrivals (zero) -> pts_sorted
//     (n, D) = points[order], order as int32, box_lo / box_hi (nl, D): per
//     coordinate the min / max over the node's leaves, with -0 below +0
//     (min gives -0 and max +0 where both meet), so the result does not
//     depend on the order of the reduction and equals jnp.minimum /
//     jnp.maximum's (IEEE 754-2019 minimum and maximum). Finite points.
//   lbvh_depth: left, right (nl,) int32 -> depth (1,) int32, the depth of
//     the deepest leaf (the root at 0): max_leaf_depth.
//
// What bounds them on this card: memory, and for lbvh_nodes the latency
// of its dependent loads. lbvh_keys reads 4*D bytes and writes 4 a point
// for a few dozen operations: one thread a point, each row read once, the
// clamp and cast in registers (the old route wrote and read back an
// (n, 3) int32 array between five launches). lbvh_nodes reads the sorted
// codes (4 MB at n = 1M, resident in the 50 MB L2) at 2 + log2 steps of
// each search and writes 28 bytes a node: one thread a node, every
// search in registers, no intermediate array (the eager version made
// about 3,500 launches of it). lbvh_refit reads a point (4*D + 8 bytes) a
// leaf and writes it sorted, and writes 8*D bytes a node: one thread a
// leaf climbs through parent; an arrival counter per node stops the first
// child's thread, and the second combines the two children's boxes and
// climbs on, so every node is written once, after both its children.
// Memory order: a thread writes its node's box, then __threadfence, then
// the atomicAdd on the parent's counter; the thread that arrives second
// fences after its atomicAdd and reads the sibling's box with __ldcg (L2;
// L1 is not coherent across SMs). lbvh_depth writes each node's parent
// (one thread a node), then counts each leaf's ancestors (one thread a
// leaf) and folds the warp's max with one atomicMax.

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool k2d>
__global__ void __launch_bounds__(kThreads) lbvh_keys_kernel(
    const float* __restrict__ pts, int n, int cols,
    const float* __restrict__ lo, const float* __restrict__ hi,
    int* __restrict__ codes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t q[3] = {0u, 0u, 0u};
  const int axes = cols < 3 ? cols : 3;
  for (int k = 0; k < axes; ++k) {
    const float l = lo[k], h = hi[k];
    const float scale = h > l ? __fdiv_rn(1023.0f, __fsub_rn(h, l)) : 0.0f;
    float v = __fmul_rn(__fsub_rn(pts[i * cols + k], l), scale);
    v = fminf(fmaxf(v, 0.0f), 1023.0f);
    q[k] = static_cast<uint32_t>(__float2int_rz(v));
  }
  const uint32_t code = k2d ? repro::morton2(q[0], q[1])
                            : repro::morton3(q[0], q[1], q[2]);
  codes[i] = static_cast<int>(code);
}

// delta(i, j) of the contract; ci = codes[i].
__device__ __forceinline__ int delta(const int* __restrict__ codes,
                                     int64_t n, int ci, int64_t i,
                                     int64_t j) {
  if (j < 0 || j >= n) return -1;
  const int x = ci ^ codes[j];
  return x != 0 ? __clz(x) : 32 + __clz(static_cast<int>(i ^ j));
}

__global__ void __launch_bounds__(kThreads) lbvh_nodes_kernel(
    const int* __restrict__ codes, int n, int* __restrict__ left,
    int* __restrict__ right, int* __restrict__ first, int* __restrict__ last,
    int* __restrict__ parent, int* __restrict__ arrivals) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nl = n - 1;
  if (i >= nl) return;
  const int ci = codes[i];
  const int64_t d =
      delta(codes, n, ci, i, i + 1) >= delta(codes, n, ci, i, i - 1) ? 1 : -1;
  const int dmin = delta(codes, n, ci, i, i - d);
  // exponential search for an upper bound of the range length
  int64_t lmax = 2;
  for (int step = 0; step < 31; ++step) {
    if (!(delta(codes, n, ci, i, i + lmax * d) > dmin)) break;
    lmax *= 2;
  }
  // binary search of the exact length
  int64_t l = 0;
  int64_t t = lmax >> 1;
  for (int step = 0; step < 31 && t >= 1; ++step, t >>= 1) {
    if (delta(codes, n, ci, i, i + (l + t) * d) > dmin) l += t;
  }
  const int64_t j = i + l * d;
  const int dnode = delta(codes, n, ci, i, j);
  // binary search of the split position
  int64_t s = 0;
  for (int k = 1; k <= 30; ++k) {
    const int64_t tk = (l + (int64_t{1} << k) - 1) >> k;
    if (tk >= 1 && delta(codes, n, ci, i, i + (s + tk) * d) > dnode) s += tk;
    if (tk <= 1) break;
  }
  const int64_t gamma = i + s * d + (d < 0 ? d : 0);
  const int64_t f = i < j ? i : j;
  const int64_t la = i < j ? j : i;
  const int64_t lc = f == gamma ? nl + gamma : gamma;
  const int64_t rc = la == gamma + 1 ? nl + gamma + 1 : gamma + 1;
  left[i] = static_cast<int>(lc);
  right[i] = static_cast<int>(rc);
  first[i] = static_cast<int>(f);
  last[i] = static_cast<int>(la);
  parent[lc] = static_cast<int>(i);
  parent[rc] = static_cast<int>(i);
  arrivals[i] = 0;
  if (i == 0) parent[0] = -1;
}

// min and max with -0 below +0: equal values differ at most in the sign of
// a zero, and OR (AND) of the bits then keeps the -0 (+0)
__device__ __forceinline__ float min_signed_zero(float a, float b) {
  if (a < b) return a;
  if (b < a) return b;
  return __int_as_float(__float_as_int(a) | __float_as_int(b));
}

__device__ __forceinline__ float max_signed_zero(float a, float b) {
  if (a > b) return a;
  if (b > a) return b;
  return __int_as_float(__float_as_int(a) & __float_as_int(b));
}

template <int D>
__global__ void __launch_bounds__(kThreads) lbvh_refit_kernel(
    const float* __restrict__ pts, const int64_t* __restrict__ order, int n,
    const int* __restrict__ left, const int* __restrict__ right,
    const int* __restrict__ parent, int* __restrict__ arrivals,
    float* __restrict__ pts_sorted, int* __restrict__ order_out,
    float* box_lo, float* box_hi) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int nl = n - 1;
  const int64_t o = order[i];
  order_out[i] = static_cast<int>(o);
  float lo[D], hi[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    lo[k] = hi[k] = pts[o * D + k];
    pts_sorted[i * D + k] = lo[k];
  }
  int from = nl + static_cast<int>(i);
  int node = parent[from];
  while (node >= 0) {
    __threadfence();
    if (atomicAdd(&arrivals[node], 1) == 0) return;  // the sibling is not done
    __threadfence();
    const int l = left[node];
    const int sib = l == from ? right[node] : l;
    if (sib >= nl) {
      const int64_t so = order[sib - nl];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float p = pts[so * D + k];
        lo[k] = min_signed_zero(lo[k], p);
        hi[k] = max_signed_zero(hi[k], p);
      }
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        lo[k] = min_signed_zero(lo[k], __ldcg(&box_lo[int64_t{sib} * D + k]));
        hi[k] = max_signed_zero(hi[k], __ldcg(&box_hi[int64_t{sib} * D + k]));
      }
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      box_lo[int64_t{node} * D + k] = lo[k];
      box_hi[int64_t{node} * D + k] = hi[k];
    }
    from = node;
    node = parent[node];
  }
}

__global__ void __launch_bounds__(kThreads) lbvh_parents_kernel(
    const int* __restrict__ left, const int* __restrict__ right, int n,
    int* __restrict__ parent, int* __restrict__ depth) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n - 1) return;
  parent[left[i]] = static_cast<int>(i);
  parent[right[i]] = static_cast<int>(i);
  if (i == 0) {
    parent[0] = -1;
    *depth = 0;
  }
}

__global__ void __launch_bounds__(kThreads) lbvh_depth_kernel(
    const int* __restrict__ parent, int n, int* __restrict__ depth) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int d = 0;
  if (i < n) {
    for (int node = parent[n - 1 + i]; node >= 0; node = parent[node]) ++d;
  }
  d = __reduce_max_sync(0xffffffffu, d);
  if ((threadIdx.x & 31) == 0 && d > 0) atomicMax(depth, d);
}

int blocks_for(int64_t threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

template <int D>
cudaError_t launch_refit(int device, const float* pts, const int64_t* order,
                         int n, const int* left, const int* right,
                         const int* parent, int* arrivals, float* pts_sorted,
                         int* order_out, float* box_lo, float* box_hi,
                         cudaStream_t s) {
  cudaError_t err = repro::prepare(device, lbvh_refit_kernel<D>, 0);
  if (err != cudaSuccess) return err;
  lbvh_refit_kernel<D><<<blocks_for(n), kThreads, 0, s>>>(
      pts, order, n, left, right, parent, arrivals, pts_sorted, order_out,
      box_lo, box_hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int lbvh_keys_launch(int device, const float* pts, int n, int cols,
                     const float* lo, const float* hi, int code_dims,
                     int* codes, void* stream) {
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (code_dims == 2) {
    err = repro::prepare(device, lbvh_keys_kernel<true>, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    lbvh_keys_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(pts, n, cols,
                                                               lo, hi, codes);
  } else {
    err = repro::prepare(device, lbvh_keys_kernel<false>, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    lbvh_keys_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
        pts, n, cols, lo, hi, codes);
  }
  return static_cast<int>(cudaGetLastError());
}

int lbvh_nodes_launch(int device, const int* codes, int n, int* left,
                      int* right, int* first, int* last, int* parent,
                      int* arrivals, void* stream) {
  cudaError_t err = repro::prepare(device, lbvh_nodes_kernel, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  lbvh_nodes_kernel<<<blocks_for(n - 1), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      codes, n, left, right, first, last, parent, arrivals);
  return static_cast<int>(cudaGetLastError());
}

int lbvh_refit_launch(int device, const float* pts, const int64_t* order,
                      int n, int dims, const int* left, const int* right,
                      const int* parent, int* arrivals, float* pts_sorted,
                      int* order_out, float* box_lo, float* box_hi,
                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define REPRO_REFIT_CASE(DIMS)                                               \
  case DIMS:                                                                 \
    return static_cast<int>(launch_refit<DIMS>(                              \
        device, pts, order, n, left, right, parent, arrivals, pts_sorted,    \
        order_out, box_lo, box_hi, s));
  switch (dims) {
    REPRO_REFIT_CASE(1)
    REPRO_REFIT_CASE(2)
    REPRO_REFIT_CASE(3)
    REPRO_REFIT_CASE(4)
    REPRO_REFIT_CASE(5)
    REPRO_REFIT_CASE(6)
    REPRO_REFIT_CASE(7)
    REPRO_REFIT_CASE(8)
  }
#undef REPRO_REFIT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int lbvh_depth_launch(int device, const int* left, const int* right, int n,
                      int* parent, int* depth, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = repro::prepare(device, lbvh_parents_kernel, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  lbvh_parents_kernel<<<blocks_for(n - 1), kThreads, 0, s>>>(left, right, n,
                                                            parent, depth);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lbvh_depth_kernel<<<blocks_for(n), kThreads, 0, s>>>(parent, n, depth);
  return static_cast<int>(cudaGetLastError());
}

const char* lbvh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
