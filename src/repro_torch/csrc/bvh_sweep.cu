// The BVH engine's kernels for Hopper (sm_90a): one level of the batched
// wavefront traversal, and the Morton codes of the LBVH build.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/bvh_sweep.py bvh_batch_sweep (def :79) -> bvh_batch_sweep_kernel<D>
//   src/repro/kernels/morton.py    morton_encode   (def :50) -> morton_encode_kernel<k2d>
//
// Contracts (identical to the reference):
//   bvh_batch_sweep: E entries, each a (query block, child node) pair that
//     carries B queries. Row-major inputs: queries (E, B, D) f32; the
//     pre-dilated prune box dlo / dhi (E, D), f32 or bf16 (Box), widened
//     to f32 here; the leaf point pt (E, D) f32; croot / leaf (E,) int32;
//     in payload mode nmin (E,) and bound (E, B) int32, else both null.
//     Per column (e, b):
//       inside  = every coordinate of the query lies in [dlo, dhi], the
//                 query rounded to the nearest bf16 and widened back first
//                 when bf16_prune (the boxes are then outward-rounded bf16
//                 values, so the prune stays conservative);
//       hit     = leaf[e] != 0 and d2(query, pt) <= eps2, exact f32;
//       minroot = croot[e] if hit, else INT32_MAX;
//     per entry: push = leaf[e] == 0 and some column is useful: inside,
//     and in payload mode nmin[e] < bound[e, b]. Dead entries are encoded
//     by the caller (box lo +BIG, hi -BIG, or query -BIG; leaf 0).
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
// operations. The design streams each input once and keeps nothing out of
// registers:
//   * one thread per entry (per point); the entry's box, leaf point and
//     payload in registers, reused by its B columns; push is the OR of its
//     columns, so no reduction across threads is needed;
//   * D and the box type are template parameters (1..8; f32 or bf16), so
//     the coordinate loops unroll and bf16 boxes cross memory at 2 bytes
//     a coordinate;
//   * an entry's queries are B*D consecutive floats, so the threads of a
//     warp read one contiguous stretch of the queries between them.
// Left for later work: reading the frontier's node ids and gathering boxes,
// leaf points and payloads inside the kernel (the caller now gathers them
// into device memory first, which moves more bytes than the kernel does),
// and one thread per column with a warp vote for push, for coalesced
// 4-byte accesses.

#include <cuda_bf16.h>

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

template <bool k2d>
__global__ void morton_encode_kernel(const int* __restrict__ coords, int n,
                                     int* __restrict__ codes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = static_cast<uint32_t>(coords[i * 3 + 0]);
  const uint32_t y = static_cast<uint32_t>(coords[i * 3 + 1]);
  uint32_t code;
  if (k2d) {
    code = expand2(x) | (expand2(y) << 1);
  } else {
    const uint32_t z = static_cast<uint32_t>(coords[i * 3 + 2]);
    code = expand3(x) | (expand3(y) << 1) | (expand3(z) << 2);
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
