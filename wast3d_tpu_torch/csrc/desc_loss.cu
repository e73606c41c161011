// K4, the pair-descriptor loss of the stylization fit, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wast3d_tpu/stylize/desc_kernel.py::_loss_kernel`
// (launched by `_loss_impl`). For every ball b of a batch:
//
//   loss[b] = sum_ij W_ij (D_ij - T_ij)^2,
//   D_ij = |x_i - x_j|                                     (x = x[b], [Mp, 3])
//   T_ij = |tp_i - tp_j| for the frozen style points tp    ([Mp, 3], shared)
//   W_ij = cg * bit0(code_ij) + cl * bit1(code_ij)        (code [Mp, Mp] u8, shared)
//
// The TPU kernel evaluates every pair of its 256 x 1024 blocks on the MXU
// and VPU; here the work follows the code, which is sparse: a row has about
// local_knn + global_knn / global_stride nonzero entries (~200 of 16384 at
// the production patch), so this kernel reads the code once and does the
// float work only where a byte is nonzero. W is exactly 0 elsewhere, so
// skipping those pairs leaves the sum's value unchanged.
//
// Layout: one CTA of 256 threads per (32-row block, 1024-column block)
// tile, walked in four chunks of 256 columns. In each chunk thread t reads
// the 32 code bytes of row t / 8, columns 32 (t % 8) + [0, 32) (two uint4; a
// warp reads 4 rows x 256 contiguous bytes), counts its nonzero bytes, and a
// block-wide prefix sum gives every nonzero byte a slot in one list in
// shared memory, in (row, column) order. Then the 256 threads take the
// list's entries in turn, so the float work is spread over all lanes
// instead of following the code's scattered nonzeros. T and W depend on
// the pair only: each entry computes them once and loops over up to 8
// balls, all of whose x_i, x_j loads are issued before any use (x is
// 12 B x Mp x B = 1.5 MB at Mp = 16384, B = 8: L2-resident). The code is
// read once per launch for B <= 8, once per 8 balls beyond.
//
// Determinism: the list's order is fixed by the prefix sum, each thread
// adds its entries in that order, the warp sums by a fixed xor-shuffle tree,
// the 8 warps in order through shared memory, into one partial per (ball,
// tile); a second kernel sums each ball's partials in a fixed order. No
// atomics: two runs give the same bits.
//
// What bounds it on this card: the code's Mp^2 bytes (268 MB at Mp = 16384,
// 0.08 ms at 3.35 TB/s); the float work is ~14 operations per nonzero pair
// and ~13 more per ball, a few tens of millions of pairs.
//
// Distances come from the coordinate differences, with explicitly rounded
// products and sums (no FMA contraction): D and T are exactly symmetric,
// exactly 0 for coincident points, and accurate for near-coincident ones.
// The TPU kernel uses the MXU's expansion |a|^2 + |b|^2 - 2 a.b, whose
// float32 error of ~1e-7 |a|^2 in D^2 is all of D^2 for points 1e-4 apart;
// through K5's 1 / D it put the gradient 1.85e5 x max |g| from a float64
// evaluation (chip_smoke.py, k4k5_near_coincident, on an H100).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;        // rows per CTA
constexpr int kCols = 1024;      // columns per CTA; Mp must be a multiple
constexpr int kChunk = 256;      // columns per compaction pass
constexpr int kThreads = 256;    // 8 threads per row, 32 bytes each per chunk
constexpr int kPerRow = kThreads / kRows;
constexpr int kBytes = kChunk / kPerRow;  // 32
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBalls = 8;     // balls per pass over the code
constexpr int kSumThreads = 256;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// |a - b| from the coordinate differences (see the head of the file).
__device__ __forceinline__ float dist(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by), dz = __fsub_rn(az, bz);
  return sqrtf(dot3(dx, dy, dz, dx, dy, dz));
}

// Number of nonzero bytes of a word.
__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  uint32_t m = w | (w >> 4);
  m |= m >> 2;
  m |= m >> 1;
  return __popc(m & 0x01010101u);
}

// Exclusive prefix sum of v over the block's threads, in thread order, and
// the total. Integer adds: exact and order-free.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    all += s_warp[w];
  }
  *total = all;
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
desc_loss_kernel(const float* __restrict__ x,        // [B, Mp, 3]
                 const float* __restrict__ tp,       // [Mp, 3]
                 const uint8_t* __restrict__ code,   // [Mp, Mp]
                 int num_balls, int mp, float cg, float cl,
                 float* __restrict__ partial) {      // [B, tiles]
  // One entry per nonzero code byte of the chunk: row << 16 | column << 8 | code.
  __shared__ uint32_t s_list[kRows * kChunk];
  __shared__ int s_warp[kWarps];
  __shared__ float red[kWarps][kMaxBalls];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = threadIdx.x / kPerRow;
  const int seg = threadIdx.x % kPerRow;
  const int i0 = blockIdx.y * kRows;
  const int j0 = blockIdx.x * kCols;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t ball_stride = static_cast<size_t>(mp) * 3;

  for (int b0 = 0; b0 < num_balls; b0 += kMaxBalls) {
    const int nb = min(kMaxBalls, num_balls - b0);
    const float* xb0 = x + static_cast<size_t>(b0) * ball_stride;
    float acc[kMaxBalls];
#pragma unroll
    for (int b = 0; b < kMaxBalls; ++b) acc[b] = 0.0f;

    for (int c0 = 0; c0 < kCols; c0 += kChunk) {
      const uint8_t* src = code + static_cast<size_t>(i0 + r) * mp + j0 + c0 + seg * kBytes;
      const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(src));
      const uint4 v1 = __ldg(reinterpret_cast<const uint4*>(src + 16));
      const uint32_t words[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      int n = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) n += nonzero_bytes(words[q]);
      int total;
      int slot = block_exclusive_scan(n, s_warp, &total);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t wd = words[q];
        while (wd != 0u) {  // this word's nonzero bytes, lowest first
          const int byte = (__ffs(static_cast<int>(wd)) - 1) >> 3;
          const uint32_t c = (wd >> (8 * byte)) & 0xffu;
          wd &= ~(0xffu << (8 * byte));
          s_list[slot++] = (static_cast<uint32_t>(r) << 16) |
                           (static_cast<uint32_t>(seg * kBytes + 4 * q + byte) << 8) | c;
        }
      }
      __syncthreads();

      for (int e = threadIdx.x; e < total; e += kThreads) {
        const uint32_t ent = s_list[e];
        const int i = i0 + static_cast<int>(ent >> 16);
        const int j = j0 + c0 + static_cast<int>((ent >> 8) & 0xffu);
        const uint32_t c = ent & 0xffu;
        float xi[kMaxBalls][3], xj[kMaxBalls][3];
#pragma unroll
        for (int b = 0; b < kMaxBalls; ++b) {  // every load first, then the math
          const int bb = b < nb ? b : 0;
          const float* pi = xb0 + bb * ball_stride + 3 * i;
          const float* pj = xb0 + bb * ball_stride + 3 * j;
          xi[b][0] = __ldg(pi);
          xi[b][1] = __ldg(pi + 1);
          xi[b][2] = __ldg(pi + 2);
          xj[b][0] = __ldg(pj);
          xj[b][1] = __ldg(pj + 1);
          xj[b][2] = __ldg(pj + 2);
        }
        const float tix = __ldg(tp + 3 * i), tiy = __ldg(tp + 3 * i + 1),
                    tiz = __ldg(tp + 3 * i + 2);
        const float tjx = __ldg(tp + 3 * j), tjy = __ldg(tp + 3 * j + 1),
                    tjz = __ldg(tp + 3 * j + 2);
        const float w = __fadd_rn(__fmul_rn(cg, static_cast<float>(c & 1u)),
                                  __fmul_rn(cl, static_cast<float>((c >> 1) & 1u)));
        const float t = dist(tix, tiy, tiz, tjx, tjy, tjz);
#pragma unroll
        for (int b = 0; b < kMaxBalls; ++b) {
          if (b < nb) {
            const float d = dist(xi[b][0], xi[b][1], xi[b][2], xj[b][0], xj[b][1], xj[b][2]);
            const float diff = __fsub_rn(d, t);
            acc[b] = __fadd_rn(acc[b], __fmul_rn(w, __fmul_rn(diff, diff)));
          }
        }
      }
      __syncthreads();  // s_list and s_warp are reused by the next chunk
    }

    // Fixed-order sums: xor tree over the warp, then the 8 warps in order.
#pragma unroll
    for (int b = 0; b < kMaxBalls; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[b] = __fadd_rn(acc[b], __shfl_xor_sync(0xffffffffu, acc[b], off));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int b = 0; b < kMaxBalls; ++b) red[warp][b] = acc[b];
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[w][threadIdx.x]);
      partial[static_cast<size_t>(b0 + threadIdx.x) * tiles + tile] = s;
    }
    __syncthreads();
  }
}

// loss[b] = sum over tiles of partial[b, tile], in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
desc_loss_sum_kernel(const float* __restrict__ partial, int tiles, float* __restrict__ loss) {
  __shared__ float s[kSumThreads];
  const float* p = partial + static_cast<size_t>(blockIdx.x) * tiles;
  float acc = 0.0f;
  for (int t = threadIdx.x; t < tiles; t += kSumThreads) acc = __fadd_rn(acc, p[t]);
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

// Number of floats of scratch `w3d_desc_loss` needs for `partial`.
int w3d_desc_loss_partials(int num_balls, int mp) {
  return num_balls * (mp / kCols) * (mp / kRows);
}

// loss [B] = per-ball pair-descriptor loss (see above). x [B, Mp, 3],
// tp [Mp, 3] float32; code [Mp, Mp] uint8, 16-byte aligned; Mp a multiple of
// 1024; partial: w3d_desc_loss_partials(B, Mp) floats of scratch. Launches
// both kernels on `stream` and returns cudaGetLastError() (0 = success).
int w3d_desc_loss(const void* x, const void* tp, const void* code, int num_balls, int mp,
                  float cg, float cl, void* partial, void* loss, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mp <= 0 || mp % kCols != 0 || num_balls <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(mp / kCols, mp / kRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  desc_loss_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(tp),
      static_cast<const uint8_t*>(code), num_balls, mp, cg, cl, static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  desc_loss_sum_kernel<<<num_balls, kSumThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<int>(grid.x * grid.y),
      static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
