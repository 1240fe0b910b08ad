// The window bounds of the grid engine's cell-sorted CSR layout for Hopper
// (sm_90a): per query cell, the range of the code-sorted corpus that holds
// the occupied cells of its 3^dims window, in one pass over the queries.
//
// Replaces
//   src/repro/core/grid.py _csr_window_bounds (def :219; a loop over the
//     9 / 27 window offsets of jnp Morton codes and searchsorted calls, no
//     Pallas)                         -> window_bounds_kernel<kDims>
//
// Contract (the plain version is that loop, kernels/csr_layout.py
// window_bounds_plain): sorted_codes (n,) int32 in ascending order, n below
// 2^30 (a bisection step reaches 2n in int32; the wrapper checks), cells
// (m, 3) int32 row-major, bits -> lo, hi (m,) int32. For every row and
// every offset (dx, dy, dz) in {-1, 0, 1}^3, with dz = 0 when dims == 2:
//   nb = min(max(cell + off, 0), 2^bits - 2) per axis, the add wrapping in
//     int32 as a tensor add does;
//   code = the Morton code of nb: 15 bits of x and y interleaved when
//     dims == 2 (z not read), else 10 bits of x, y and z, with
//     morton_encode's masks and shift chains (sweep_common.cuh);
//   left, right = the lower and upper bound of code in sorted_codes
//     (signed int32 order, as torch.searchsorted compares);
//   where right > left: lo = min(lo, left) and hi = max(hi, right).
// lo starts at n and hi at 0, so a window with no occupied cell gives
// (n, 0).
//
// Design: one thread a row, the window in registers, one store each of lo
// and hi. Both bounds are monotone in the code, so lo is the lower bound of
// the least occupied code and hi the upper bound of the greatest: a thread
// finds the lower bound of each offset's code (the cell is occupied iff
// the element there equals the code) and then one upper bound, 9 + 1 or
// 27 + 1 bisections where the loop made 18 or 54. The offsets' bisections
// step together (branch-free, floor(log2 n) + 1 steps), so a thread has 9
// or 27 independent loads in flight a step. Every caller passes its rows
// sorted by code, so the lanes of a warp share most of their path and the
// loads broadcast; the sorted codes (8 MB at n = 2M) stay in the 50 MB L2.
// What bounds it on this card: the latency of the dependent steps, hidden
// by the loads in flight; its bytes are m * 20 (a row's cell in, lo and hi
// out) and the corpus n * 4 once from memory.

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;

// min(max(c + d, 0), cap), the add wrapping as an int32 tensor add does
__device__ __forceinline__ uint32_t clamp_cell(int c, int d, int cap) {
  const int v = static_cast<int>(static_cast<uint32_t>(c) +
                                 static_cast<uint32_t>(d));
  return static_cast<uint32_t>(min(max(v, 0), cap));
}

template <int kDims>
__global__ void __launch_bounds__(kThreads) window_bounds_kernel(
    const int* __restrict__ codes, int n, const int* __restrict__ cells,
    int m, int cap, int top, int* __restrict__ lo_out,
    int* __restrict__ hi_out) {
  constexpr int kOff = kDims == 2 ? 9 : 27;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int cx = cells[i * 3], cy = cells[i * 3 + 1];
  const int cz = kDims == 2 ? 0 : cells[i * 3 + 2];
  int code[kOff];
  int pos[kOff];
#pragma unroll
  for (int k = 0; k < kOff; ++k) {
    // the plain loop's order: dx outermost, then dy, then dz
    const int dx = kDims == 2 ? k / 3 - 1 : k / 9 - 1;
    const int dy = kDims == 2 ? k % 3 - 1 : k / 3 % 3 - 1;
    const uint32_t x = clamp_cell(cx, dx, cap);
    const uint32_t y = clamp_cell(cy, dy, cap);
    if (kDims == 2) {
      code[k] = static_cast<int>(repro::morton2(x, y));
    } else {
      const uint32_t z = clamp_cell(cz, k % 3 - 1, cap);
      code[k] = static_cast<int>(repro::morton3(x, y, z));
    }
    pos[k] = 0;
  }
  // lower bounds: pos gains each power of two, from top (the greatest one
  // not above n) down, while the element before it is below the code
  for (int step = top; step > 0; step >>= 1) {
#pragma unroll
    for (int k = 0; k < kOff; ++k) {
      const int p = pos[k] + step;
      if (p <= n && __ldg(&codes[p - 1]) < code[k]) pos[k] = p;
    }
  }
  int lo = n;
  int high = 0;
  bool any = false;
#pragma unroll
  for (int k = 0; k < kOff; ++k) {
    if (pos[k] < n && __ldg(&codes[pos[k]]) == code[k]) {
      lo = min(lo, pos[k]);
      high = any ? max(high, code[k]) : code[k];
      any = true;
    }
  }
  int hi = 0;
  if (any) {  // the upper bound of the greatest occupied code
    for (int step = top; step > 0; step >>= 1) {
      const int p = hi + step;
      if (p <= n && __ldg(&codes[p - 1]) <= high) hi = p;
    }
  }
  lo_out[i] = lo;
  hi_out[i] = hi;
}

template <int kDims>
cudaError_t launch(int device, const int* codes, int n, const int* cells,
                   int m, int cap, int* lo, int* hi, cudaStream_t s) {
  cudaError_t err = repro::prepare(device, window_bounds_kernel<kDims>, 0);
  if (err != cudaSuccess) return err;
  int top = 0;
  for (int64_t p = 1; p <= n; p *= 2) top = static_cast<int>(p);
  window_bounds_kernel<kDims><<<(m + kThreads - 1) / kThreads, kThreads, 0,
                                s>>>(codes, n, cells, m, cap, top, lo, hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on success. Launches on `stream`, does not
// synchronise and allocates nothing.
int window_bounds_launch(int device, const int* codes, int n,
                         const int* cells, int m, int dims, int bits,
                         int* lo, int* hi, void* stream) {
  if (m == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int cap = (1 << bits) - 2;
  if (dims == 2)
    return static_cast<int>(launch<2>(device, codes, n, cells, m, cap, lo,
                                      hi, s));
  if (dims == 3)
    return static_cast<int>(launch<3>(device, codes, n, cells, m, cap, lo,
                                      hi, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* csr_layout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
