// K4, the pair-descriptor loss of the stylization fit, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wast3d_tpu/stylize/desc_kernel.py::_loss_kernel`
// (launched by `_loss_impl`). For every ball b of a batch:
//
//   loss[b] = sum_ij W_ij (D_ij - T_ij)^2,
//   D_ij = |x_i - x_j|                                     (x = x[b], [Mp, 3])
//   T_ij = |tp_i - tp_j| for the frozen style points tp    ([Mp, 3], shared)
//   W_ij = cg * bit0(code_ij) + cl * bit1(code_ij)        (the pair code, shared)
//
// The TPU kernel evaluates every pair of its 256 x 1024 blocks on the MXU
// and VPU. Here the code's sparse structure is taken out of the kernel: W
// is nonzero on ~1.2% of the pairs and the same for the whole fit, so the
// fit lists its pairs once (`desc_kernel.build_pair_list`, the list K5
// walks too; `desc_common.cuh` has its layout) and this kernel walks that
// list, never the [Mp, Mp] code. D and T are exactly symmetric (both from
// the coordinate differences, `desc_common.cuh`), so the sum is taken over
// the pairs j > i only, each with the weight W_ij + W_ji from the entry's 4
// bits: half the evaluations of the list, and the diagonal, where D = T = 0,
// adds exactly 0. W is exactly 0 off the list, so the sum's value is that
// of the dense one up to the order of the additions.
//
// One warp per row i, rows longest first (`row_order`). A row's columns
// ascend, so its j > i entries are a suffix; a 32-way search (each lane
// probes one entry, a ballot picks the bracket; three rounds for a
// 2,000-entry row) finds where it starts. The suffix streams through
// shared memory in 128-entry chunks, double-buffered with cp.async, as in
// K5 (`desc_grad.cu`): lane l copies and takes entries l, l + 32, ...
// Per entry it computes W_ij + W_ji and T once, then D and the weighted
// square for up to 8 balls, reading x ball-interleaved (the entry's 8
// balls and tp_j are one 128-byte line of the copy `interleave_kernel`
// makes first).
//
// Determinism: each lane adds its entries in list order, the warp sums its
// lanes by a fixed xor-shuffle tree and writes one partial per (ball,
// row); a second kernel sums each ball's partials in row-index order by a
// fixed tree. No atomics: two runs give the same bits.
//
// What bounds it on this card: ~20 operations per pair j > i and ~13 more
// per ball (2.4 M pairs at the production patch, Mp = 16384), against 4
// bytes of list per pair and 12 B per point and ball: operations, by a
// little (both ~0.005 ms).

#include "desc_common.cuh"

namespace {

constexpr int kWarps = 8;        // rows (one per warp) per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;      // entries per shared-memory stage
constexpr int kPerLane = kChunk / 32;
constexpr int kSumThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// First position p in [lo, hi) whose entry's column is above i, or hi
// (the columns ascend). Every lane of the warp gets the same answer.
__device__ __forceinline__ int first_above(const uint32_t* __restrict__ entries, int lo, int hi,
                                           int i, int lane) {
  // Invariant: entries before lo have columns <= i, those from hi on > i.
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool above = p >= hi || static_cast<int>(__ldg(entries + p) & kColMask) > i;
    const unsigned m = __ballot_sync(kFull, above);
    if (m == 0u) {  // all 32 probes at or below i: the answer is past the last
      lo += 31 * step + 1;
    } else {
      const int f = __ffs(static_cast<int>(m)) - 1;
      hi = min(hi, lo + f * step);
      if (f > 0) lo += (f - 1) * step + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
desc_loss_kernel(const float* __restrict__ tp,          // [Mp, 3]
                 const float4* __restrict__ xt,         // [groups, Mp, kBalls]
                 const int* __restrict__ row_ptr,       // [Mp + 1]
                 const uint32_t* __restrict__ entries,  // [P]
                 const int* __restrict__ row_order,     // [Mp]
                 int num_balls, int mp, float cg, float cl,
                 float* __restrict__ partial) {         // [B, Mp]
  __shared__ uint32_t s_list[kWarps][2][kChunk];  // slot 32 u + l: lane l's entry u
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= mp) return;  // the whole warp
  const int i = row_order[w];
  const int end = row_ptr[i + 1];
  const int start = first_above(entries, row_ptr[i], end, i, lane);
  const float tix = tp[3 * i], tiy = tp[3 * i + 1], tiz = tp[3 * i + 2];

  // The row's entries base + lane + 32 u, u < kPerLane, into buffer `buf`.
  // Each lane reads back only the slots it copied, so its own
  // cp.async.wait_group makes them visible; no warp barrier is needed.
  auto stage = [&](int base, int buf) {
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int e = base + 32 * u + lane;
      if (e < end) cp_async4(&s_list[warp][buf][32 * u + lane], entries + e);
    }
  };

  for (int b0 = 0; b0 < num_balls; b0 += kBalls) {
    const int nb = min(kBalls, num_balls - b0);
    const float4* xg = xt + static_cast<size_t>(b0 / kBalls) * mp * kBalls;
    float xi[kBalls][3], acc[kBalls];
#pragma unroll
    for (int b = 0; b < kBalls; ++b) {
      const float4 q = xg[static_cast<size_t>(i) * kBalls + b];
      xi[b][0] = q.x;
      xi[b][1] = q.y;
      xi[b][2] = q.z;
      acc[b] = 0.0f;
    }

    stage(start, 0);
    cp_async_commit();
    int buf = 0;
    for (int c = start; c < end; c += kChunk, buf ^= 1) {
      if (c + kChunk < end) stage(c + kChunk, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this lane's copies of chunk c are done
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        if (c + 32 * u + lane >= end) break;
        const uint32_t ent = s_list[warp][buf][32 * u + lane];
        const int j = static_cast<int>(ent & kColMask);
        float4 q[kBalls];  // x_j of each ball; tp_j in the w of q[0..2]
#pragma unroll
        for (int b = 0; b < kBalls; ++b) q[b] = __ldg(xg + static_cast<size_t>(j) * kBalls + b);
        const float wsum = weight_both(ent >> kColBits, cg, cl);
        const float t = dist(tix, tiy, tiz, q[0].w, q[1].w, q[2].w);
#pragma unroll
        for (int b = 0; b < kBalls; ++b) {
          if (b < nb) {
            const float d = dist(xi[b][0], xi[b][1], xi[b][2], q[b].x, q[b].y, q[b].z);
            const float diff = __fsub_rn(d, t);
            acc[b] = __fadd_rn(acc[b], __fmul_rn(wsum, __fmul_rn(diff, diff)));
          }
        }
      }
    }
    cp_async_wait<0>();

    // The 32 lanes' sums, by a fixed xor tree (every lane ends with the total).
#pragma unroll
    for (int b = 0; b < kBalls; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[b] = __fadd_rn(acc[b], __shfl_xor_sync(kFull, acc[b], off));
      }
    }
    if (lane < nb) {
      float v = 0.0f;
#pragma unroll
      for (int b = 0; b < kBalls; ++b) v = lane == b ? acc[b] : v;
      partial[static_cast<size_t>(b0 + lane) * mp + i] = v;
    }
  }
}

// loss[b] = sum over rows of partial[b, row], in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
desc_loss_sum_kernel(const float* __restrict__ partial, int rows, float* __restrict__ loss) {
  __shared__ float s[kSumThreads];
  const float* p = partial + static_cast<size_t>(blockIdx.x) * rows;
  float acc = 0.0f;
  for (int t = threadIdx.x; t < rows; t += kSumThreads) acc = __fadd_rn(acc, p[t]);
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kSumThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[blockIdx.x] = s[0];
}

}  // namespace

extern "C" {

// loss [B] = per-ball pair-descriptor loss (see above). x [B, Mp, 3],
// tp [Mp, 3] float32; the pair list: row_ptr [Mp + 1], entries [P] and
// row_order [Mp], int32; scratch: ceil(B / 8) * Mp * 32 + B * Mp floats,
// 16-byte aligned (the interleaved copy of x, then the per-row partials).
// Launches the copy and both kernels on `stream` and returns
// cudaGetLastError() (0 = success).
int w3d_desc_loss(const void* x, const void* tp, const void* row_ptr, const void* entries,
                  const void* row_order, void* scratch, int num_balls, int mp, float cg,
                  float cl, void* loss, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mp <= 0 || num_balls <= 0 || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tpp = static_cast<const float*>(tp);
  float4* xt = static_cast<float4*>(scratch);
  float* partial = static_cast<float*>(scratch) +
                   static_cast<size_t>((num_balls + kBalls - 1) / kBalls) * mp * kBalls * 4;
  err = launch_interleave(static_cast<const float*>(x), tpp, num_balls, mp, xt, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  desc_loss_kernel<<<(mp + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      tpp, xt, static_cast<const int*>(row_ptr), static_cast<const uint32_t*>(entries),
      static_cast<const int*>(row_order), num_balls, mp, cg, cl, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  desc_loss_sum_kernel<<<num_balls, kSumThreads, 0, s>>>(partial, mp,
                                                         static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
