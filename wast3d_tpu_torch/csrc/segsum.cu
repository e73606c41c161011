// K3, the per-Gaussian segment sum of duplicate gradients, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wast3d_tpu/ops/rasterizer/grad_reduce.py::_segsum_kernel`,
// which all three rank-major reductions there reach (`segment_reduce_by_rank`,
// `_sortpayload`, `_sortpacked`). The TPU kernel streams rank-sorted rows once
// through a ring of output rows in its fast memory, which relies on its grid
// running in order. Here the grouping comes in as segments, CSR style:
//
//   out[r] = sum over p in [lo[s], hi[s]) of rows[idx[p]],
//   s = row_map[r] (s = r if row_map is null),
//
// summed in ascending p, for r in [0, n1). The bounds are offsets
// (lo = offsets, hi = offsets + 1), or a first pass writes them from
// `segment_of`, the ascending segment of each position. idx is given, or is
// the inverse of the permutation `perm` (the first pass writes it), or is
// the identity. The wrapper (`grad_reduce.py`) takes the segments from the
// binning, which listed each Gaussian's duplicates together before its tile
// sort (segment_of = each listed duplicate's Gaussian, row_map = the depth
// order, perm = the tile sort's permutation), or from a sort of the ranks;
// the kernels search nothing and sort nothing.
//
// Design: one thread per output row, no atomics, each output row written
// once. A thread reads a duplicate's row as 16-byte loads when the rows allow
// it (`vec`: row stride a multiple of 4 floats, 16-byte aligned; the render
// path's rows are 12 floats, 48 bytes), else as scalar loads, and issues the
// idx loads of a group of kGroup duplicates before their row loads, so that
// kGroup rows are in flight at once. A segment longer than kLong is summed by
// the whole warp instead: lane l adds elements lo + l, lo + l + 32, ... in
// order, and the 32 partial sums meet in a fixed xor-shuffle tree. Every
// choice depends only on the segment's length, so two runs, and the two
// routes (which give each row the same sequence of rows), give the same bits.
//
// What bounds it on this card: bytes, K x 4 C of rows in through idx (K x 16
// of perm and segment_of on the binning route, K x 4 of idx on the other),
// ~12 n1 of bounds and row map, and 4 C n1 out; the work is K x C
// additions. The rows are read in random order, one 48-byte row in two
// 32-byte sectors, so the sectors carry ~1.3x the bytes counted. TMA and
// wgmma do not apply to a random-row gather; the design keeps loads in
// flight instead.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarp = 32;
constexpr int kGroup = 4;   // duplicates whose loads are issued together
constexpr int kLong = 32;   // longer segments are split over the warp

// Columns 0 .. 4 * kVecs - 1 of row `src` into v; vector loads read past c up
// to the next multiple of 4 (the wrapper checked that the storage has them),
// scalar loads stop at c.
template <int kVecs, bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ rows, int ld, int c,
                                         int src, float (&v)[4 * kVecs]) {
  const float* p = rows + static_cast<long long>(src) * ld;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int col = 0; col < 4 * kVecs; ++col) v[col] = col < c ? __ldg(p + col) : 0.0f;
  }
}

// acc += the rows of positions first, first + stride, ... below end, in that
// order, kGroup at a time: their idx loads, then their row loads, then the adds.
template <int kVecs, bool kVec>
__device__ __forceinline__ void add_positions(const float* __restrict__ rows, int ld, int c,
                                              const int* __restrict__ idx, int first, int end,
                                              int stride, float (&acc)[4 * kVecs]) {
  for (int p = first; p < end; p += kGroup * stride) {
    int src[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int q = p + u * stride;
      src[u] = q < end ? (idx != nullptr ? __ldg(idx + q) : q) : -1;
    }
    float v[kGroup][4 * kVecs];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (src[u] >= 0) load_row<kVecs, kVec>(rows, ld, c, src[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (src[u] >= 0) {
#pragma unroll
        for (int col = 0; col < 4 * kVecs; ++col) acc[col] += v[u][col];
      }
    }
  }
}

template <int kVecs>
__device__ __forceinline__ void store_row(float* __restrict__ out, int r, int c,
                                          const float (&acc)[4 * kVecs]) {
  float* o = out + static_cast<long long>(r) * c;
#pragma unroll
  for (int col = 0; col < 4 * kVecs; ++col) {
    if (col < c) o[col] = acc[col];
  }
}

// The first pass, one thread per position p: idx[perm[p]] = p, the inverse
// of the permutation, when perm is given; lo[s] = p where segment s starts
// and hi[s] = p + 1 where it ends, when segment_of is given (ascending). An
// empty segment keeps the lo = hi = 0 written before this pass.
__global__ void first_pass_kernel(const long long* __restrict__ perm,
                                  const long long* __restrict__ segment_of, int k,
                                  int* __restrict__ idx, int* __restrict__ lo,
                                  int* __restrict__ hi) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= k) return;
  if (perm != nullptr) idx[perm[p]] = p;
  if (segment_of != nullptr) {
    const long long s = segment_of[p];
    if (p == 0 || segment_of[p - 1] != s) lo[s] = p;
    if (p == k - 1 || segment_of[p + 1] != s) hi[s] = p + 1;
  }
}

template <int kVecs, bool kVec>
__global__ void __launch_bounds__(kBlock)
segsum_kernel(const float* __restrict__ rows, int ld, const int* __restrict__ idx,
              const int* __restrict__ seg_lo, const int* __restrict__ seg_hi,
              const long long* __restrict__ row_map, int n1, int c, float* __restrict__ out) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  const bool live = r < n1;
  const int seg = live ? (row_map != nullptr ? static_cast<int>(row_map[r]) : r) : 0;
  const int lo = live ? seg_lo[seg] : 0;
  const int hi = live ? seg_hi[seg] : 0;
  const bool split = hi - lo > kLong;
  if (live && !split) {
    float acc[4 * kVecs];
#pragma unroll
    for (int col = 0; col < 4 * kVecs; ++col) acc[col] = 0.0f;
    add_positions<kVecs, kVec>(rows, ld, c, idx, lo, hi, 1, acc);
    store_row<kVecs>(out, r, c, acc);
  }
  // The warp's long segments, one after another, each over all 32 lanes.
  unsigned pending = __ballot_sync(0xffffffffu, split);
  while (pending != 0u) {
    const int leader = __ffs(pending) - 1;
    pending &= pending - 1u;
    const int slo = __shfl_sync(0xffffffffu, lo, leader);
    const int shi = __shfl_sync(0xffffffffu, hi, leader);
    float acc[4 * kVecs];
#pragma unroll
    for (int col = 0; col < 4 * kVecs; ++col) acc[col] = 0.0f;
    add_positions<kVecs, kVec>(rows, ld, c, idx, slo + lane, shi, kWarp, acc);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int col = 0; col < 4 * kVecs; ++col) {
        acc[col] += __shfl_xor_sync(0xffffffffu, acc[col], off);
      }
    }
    if (lane == leader) store_row<kVecs>(out, r, c, acc);
  }
}

template <int kVecs>
void launch(bool vec, const float* rows, int ld, const int* idx, const int* lo, const int* hi,
            const long long* row_map, int n1, int c, float* out, cudaStream_t stream) {
  const int blocks = (n1 + kBlock - 1) / kBlock;
  if (vec) {
    segsum_kernel<kVecs, true><<<blocks, kBlock, 0, stream>>>(rows, ld, idx, lo, hi, row_map,
                                                              n1, c, out);
  } else {
    segsum_kernel<kVecs, false><<<blocks, kBlock, 0, stream>>>(rows, ld, idx, lo, hi, row_map,
                                                               n1, c, out);
  }
}

}  // namespace

extern "C" {

// out [n1, c] = the segment sums above; rows [*, c] float32 at row stride
// `ld_rows` floats, `vec` != 0 to read them as 16-byte loads (the caller
// checked alignment and storage); idx [K] int32 or null; perm [K] int64 or
// null, and then idx is [K] scratch that the first pass fills;
// segment_of [K] int64 ascending in [0, n1) or null; offsets [S + 1] int32
// when segment_of is null, else null, and then bounds is [2 n1] int32
// scratch (lo, then hi) that this call zeroes and the first pass fills;
// row_map [n1] int64 or null. K is the number of positions (used only with
// perm or segment_of). Launches on `stream` and returns cudaGetLastError()
// after the launches (0 = success). Synchronises nothing and allocates
// nothing.
int w3d_segsum(const void* rows, int ld_rows, int vec, void* idx, const void* perm,
               const void* segment_of, int k, const void* offsets, void* bounds,
               const void* row_map, int n1, int c, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long* seg_of = static_cast<const long long*>(segment_of);
  if (c < 1 || c > 16 || n1 < 0 || k < 0 || (perm != nullptr && idx == nullptr) ||
      (seg_of != nullptr ? bounds == nullptr : offsets == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ix = static_cast<int*>(idx);
  int* scratch = static_cast<int*>(bounds);
  const int* seg_lo = seg_of != nullptr ? scratch : static_cast<const int*>(offsets);
  const int* seg_hi = seg_of != nullptr ? scratch + n1 : seg_lo + 1;
  if (seg_of != nullptr && n1 > 0) {
    err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int) * static_cast<size_t>(n1), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((perm != nullptr || seg_of != nullptr) && k > 0) {
    first_pass_kernel<<<(k + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        static_cast<const long long*>(perm), seg_of, k, ix, scratch,
        scratch != nullptr ? scratch + n1 : nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n1 > 0) {
    const float* r = static_cast<const float*>(rows);
    const long long* map = static_cast<const long long*>(row_map);
    float* o = static_cast<float*>(out);
    const bool v = vec != 0;
    switch ((c + 3) / 4) {
      case 1: launch<1>(v, r, ld_rows, ix, seg_lo, seg_hi, map, n1, c, o, s); break;
      case 2: launch<2>(v, r, ld_rows, ix, seg_lo, seg_hi, map, n1, c, o, s); break;
      case 3: launch<3>(v, r, ld_rows, ix, seg_lo, seg_hi, map, n1, c, o, s); break;
      default: launch<4>(v, r, ld_rows, ix, seg_lo, seg_hi, map, n1, c, o, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
