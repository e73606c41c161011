// K3, the per-Gaussian segment sum of duplicate gradients, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wast3d_tpu/ops/rasterizer/grad_reduce.py::_segsum_kernel`,
// which all three rank-major reductions there reach (`segment_reduce_by_rank`,
// `_sortpayload`, `_sortpacked`). Its input is the duplicates' gradient rows
// in rank-major order, as the wrapper's `torch.sort` of the ranks leaves them
// (the TPU wrappers sort with `lax.sort` outside their kernel too): either
// gathered into that order already, or read through the sort's permutation
// (`perm`, null when the rows are already in order). Output row r is the sum
// of the rows whose rank is r, for every r in [0, n1): a rank that no
// duplicate has gets zeros.
//
// The TPU kernel streams the sorted rows once through a ring of output rows
// in its fast memory and flushes it block by block, which relies on its grid
// running in order and on a sentinel rank to flush the last block. Blocks run
// in no order here, so the kernel is the other way round: 16 output rows per
// block of 256 threads, one thread per (row, column). Two lanes of each row
// find the row's segment [lo, hi) in the sorted ranks by binary search, and
// each column's thread adds that segment's values in ascending order. One
// fixed order per output row, no atomics, every row written: the result is
// the same bit for bit from run to run.
//
// What bounds it on this card: bytes are K x (4 C + 4) in (plus 8 K of
// permutation) and 4 C n1 out, work is K x C additions. At the 200k / 800x800
// scene that is a few tens of MB, so the bound is bytes; this simple version
// also pays two binary searches per output row and, through `perm`, reads
// the rows in random order.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;            // columns handled per row (C <= 16)
constexpr int kRowsPerBlock = 16;    // 16 rows x 16 columns = 256 threads
constexpr int kBlock = kRowsPerBlock * kCols;

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n, int value) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (a[mid] < value) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kBlock)
segsum_kernel(const float* __restrict__ rows, int ld_rows,
              const long long* __restrict__ perm,  // [K] or null
              const int* __restrict__ sorted_ranks,  // [K] ascending
              int k, int n1, int c, float* __restrict__ out) {
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / kCols;
  const int col = threadIdx.x % kCols;
  // Lane 0 of the row's 16 finds lo, lane 1 finds hi; the half-warp shares them.
  int bound = 0;
  if (r < n1 && col < 2) bound = lower_bound(sorted_ranks, k, r + col);
  const int lo = __shfl_sync(0xffffffffu, bound, 0, kCols);
  const int hi = __shfl_sync(0xffffffffu, bound, 1, kCols);
  if (r >= n1 || col >= c) return;
  float s = 0.0f;
  for (int i = lo; i < hi; ++i) {
    const long long src = perm != nullptr ? perm[i] : static_cast<long long>(i);
    s += rows[src * ld_rows + col];
  }
  out[static_cast<size_t>(r) * c + col] = s;
}

}  // namespace

extern "C" {

// out [n1, c] = per-rank sums of rows [K, c] (row stride ld_rows floats).
// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = success). Synchronises nothing and allocates nothing.
int w3d_segsum(const void* rows, int ld_rows, const void* perm, const void* sorted_ranks,
               int k, int n1, int c, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c < 1 || c > kCols) return static_cast<int>(cudaErrorInvalidValue);
  if (n1 > 0) {
    const int blocks = (n1 + kRowsPerBlock - 1) / kRowsPerBlock;
    segsum_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), ld_rows, static_cast<const long long*>(perm),
        static_cast<const int*>(sorted_ranks), k, n1, c, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
