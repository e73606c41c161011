// K5, the gradient of the pair-descriptor loss (K4), for Hopper (sm_90a).
//
// Replaces the TPU kernel `wast3d_tpu/stylize/desc_kernel.py::_grad_kernel`
// (launched by `_grad_impl`, the VJP of `pair_loss`). For every ball b:
//
//   dL/dx_i = sum_j (R_ij + R_ji) (x_i - x_j),
//   R_ij = 2 W_ij (D_ij - T_ij) / max(D_ij, 1e-12)
//
// with D, T and W as in K4 (`desc_loss.cu`): D and T from the coordinate
// differences, which are accurate where points nearly coincide (the
// expansion the TPU kernel uses makes D noise there, and R_ij's 1 / D turns
// that noise into gradient errors of ~1e5 x max |g|). D and T are symmetric,
// so R_ij + R_ji = 2 (W_ij + W_ji) (D_ij - T_ij) / max(D_ij, 1e-12), and the
// differences x_i - x_j serve both D and the gradient.
//
// The TPU kernel adds each (row block, column block) tile's row and column
// sums into one (3, Mp) accumulator in its fast memory, which only works
// because its grid runs in order. Blocks run in no order here, and float
// atomics would make the result vary from run to run. So each CTA owns 32
// rows and walks every column, reading both code[i, j] (its rows, coalesced)
// and code[j, i] (the 32-byte column slab of its rows, one sector per code
// row) through shared memory. Every unordered pair is visited from both of
// its ends, twice the pair visits of a tile split, and no reduction across
// CTAs is needed: each dx row is written by exactly one CTA.
//
// Per tile of 256 columns: the two code slabs go to shared memory; thread
// (row r, segment g) of the 8 threads of row r scans columns g, g + 8, ...
// of both slabs and, after a per-row prefix sum of the counts, writes one
// entry per nonzero pair into row r's list. Then the 8 threads of row r take
// that list's entries in turn, so the float work follows the pairs rather
// than the code's scattered nonzeros. Each thread keeps x_i and its running
// gradient for up to 8 balls in registers; all of an entry's x_j loads are
// issued before any use. At the end the 8 threads of a row are summed by a
// fixed xor-shuffle tree. Float work is done only where code[i, j] |
// code[j, i] is nonzero (W_ij + W_ji = 0 elsewhere, which contributes
// exactly 0). Two runs give the same bits.
//
// What bounds it on this card: reading the code twice (2 Mp^2 bytes,
// 537 MB at Mp = 16384, 0.16 ms at 3.35 TB/s; the bytes a one-pass design
// would read are Mp^2), and ~20 operations per nonzero pair and ~20 more
// per ball.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;                   // rows per CTA
constexpr int kCols = 256;                  // columns per shared-memory tile
constexpr int kThreads = 256;
constexpr int kPerRow = kThreads / kRows;   // 8 threads per row
constexpr int kMaxBalls = 8;                // balls per pass over the code
constexpr int kRowPad = 4;                  // bytes: spreads s_row's rows over the banks
constexpr float kEps = 1e-12f;

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

__device__ __forceinline__ float weight(uint32_t c, float cg, float cl) {
  return __fadd_rn(__fmul_rn(cg, static_cast<float>(c & 1u)),
                   __fmul_rn(cl, static_cast<float>((c >> 1) & 1u)));
}

__global__ void __launch_bounds__(kThreads)
desc_grad_kernel(const float* __restrict__ x,        // [B, Mp, 3]
                 const float* __restrict__ tp,       // [Mp, 3]
                 const uint8_t* __restrict__ code,   // [Mp, Mp]
                 int num_balls, int mp, float cg, float cl,
                 float* __restrict__ dx) {           // [B, Mp, 3]
  __shared__ __align__(16) uint8_t s_row[kRows][kCols + kRowPad];  // code[i0 + r][j0 + c]
  __shared__ __align__(16) uint8_t s_col[kCols][kRows];            // code[j0 + c][i0 + r]
  // Row r's pairs in this tile: column | code[i, j] << 8 | code[j, i] << 10.
  __shared__ uint16_t s_list[kRows][kCols];
  __shared__ int s_count[kRows][kPerRow];
  const int r = threadIdx.x / kPerRow;
  const int g = threadIdx.x % kPerRow;
  const int i0 = blockIdx.x * kRows;
  const int i = i0 + r;
  const size_t ball_stride = static_cast<size_t>(mp) * 3;
  const float tix = tp[3 * i], tiy = tp[3 * i + 1], tiz = tp[3 * i + 2];

  for (int b0 = 0; b0 < num_balls; b0 += kMaxBalls) {
    const int nb = min(kMaxBalls, num_balls - b0);
    const float* xb0 = x + static_cast<size_t>(b0) * ball_stride;
    float xi[kMaxBalls][3], acc[kMaxBalls][3];
#pragma unroll
    for (int b = 0; b < kMaxBalls; ++b) {
      const float* p = xb0 + (b < nb ? b : 0) * ball_stride + 3 * i;
      xi[b][0] = p[0];
      xi[b][1] = p[1];
      xi[b][2] = p[2];
      acc[b][0] = acc[b][1] = acc[b][2] = 0.0f;
    }

    for (int j0 = 0; j0 < mp; j0 += kCols) {
      __syncthreads();  // the previous tile's slabs and lists have been read
      for (int t = threadIdx.x; t < kRows * kCols / 16; t += kThreads) {
        const int rr = t / (kCols / 16);
        const int cc = (t % (kCols / 16)) * 16;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            code + static_cast<size_t>(i0 + rr) * mp + j0 + cc));
        uint32_t* dst = reinterpret_cast<uint32_t*>(&s_row[rr][cc]);  // row stride 260: 4-aligned
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
      for (int t = threadIdx.x; t < kCols * kRows / 16; t += kThreads) {
        const int cc = t / (kRows / 16);
        const int half = (t % (kRows / 16)) * 16;
        *reinterpret_cast<uint4*>(&s_col[cc][half]) = __ldg(reinterpret_cast<const uint4*>(
            code + static_cast<size_t>(j0 + cc) * mp + i0 + half));
      }
      __syncthreads();

      // Row r's nonzero pairs among columns g, g + 8, ...: count, place, list.
      int n = 0;
      for (int c = g; c < kCols; c += kPerRow) n += (s_row[r][c] | s_col[c][r]) != 0;
      s_count[r][g] = n;
      __syncthreads();
      int slot = 0, total = 0;
      for (int gg = 0; gg < kPerRow; ++gg) {
        slot += gg < g ? s_count[r][gg] : 0;
        total += s_count[r][gg];
      }
      for (int c = g; c < kCols; c += kPerRow) {
        const uint32_t a = s_row[r][c], bt = s_col[c][r];
        if ((a | bt) != 0u) s_list[r][slot++] = static_cast<uint16_t>(c | (a << 8) | (bt << 10));
      }
      __syncthreads();

      for (int e = g; e < total; e += kPerRow) {
        const uint32_t ent = s_list[r][e];
        const int j = j0 + static_cast<int>(ent & 0xffu);
        float xj[kMaxBalls][3];
#pragma unroll
        for (int b = 0; b < kMaxBalls; ++b) {  // every load first, then the math
          const float* p = xb0 + (b < nb ? b : 0) * ball_stride + 3 * j;
          xj[b][0] = __ldg(p);
          xj[b][1] = __ldg(p + 1);
          xj[b][2] = __ldg(p + 2);
        }
        const float tjx = __ldg(tp + 3 * j), tjy = __ldg(tp + 3 * j + 1),
                    tjz = __ldg(tp + 3 * j + 2);
        const float w = __fadd_rn(weight((ent >> 8) & 3u, cg, cl), weight((ent >> 10) & 3u, cg, cl));
        const float t = dist(tix, tiy, tiz, tjx, tjy, tjz);
#pragma unroll
        for (int b = 0; b < kMaxBalls; ++b) {
          if (b < nb) {
            const float ex = __fsub_rn(xi[b][0], xj[b][0]), ey = __fsub_rn(xi[b][1], xj[b][1]),
                        ez = __fsub_rn(xi[b][2], xj[b][2]);
            const float d = sqrtf(dot3(ex, ey, ez, ex, ey, ez));
            const float f = __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, w), __fsub_rn(d, t)),
                                      fmaxf(d, kEps));
            acc[b][0] = __fadd_rn(acc[b][0], __fmul_rn(f, ex));
            acc[b][1] = __fadd_rn(acc[b][1], __fmul_rn(f, ey));
            acc[b][2] = __fadd_rn(acc[b][2], __fmul_rn(f, ez));
          }
        }
      }
    }

    // The 8 threads of each row (adjacent lanes), summed by a fixed xor tree.
#pragma unroll
    for (int b = 0; b < kMaxBalls; ++b) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int off = kPerRow / 2; off > 0; off >>= 1) {
          acc[b][k] = __fadd_rn(acc[b][k], __shfl_xor_sync(0xffffffffu, acc[b][k], off));
        }
      }
    }
    for (int e = g; e < 3 * nb; e += kPerRow) {
      float v = 0.0f;
#pragma unroll
      for (int b = 0; b < kMaxBalls; ++b) {
#pragma unroll
        for (int k = 0; k < 3; ++k) v = e == 3 * b + k ? acc[b][k] : v;
      }
      dx[static_cast<size_t>(b0 + e / 3) * ball_stride + 3 * i + (e % 3)] = v;
    }
  }
}

}  // namespace

extern "C" {

// dx [B, Mp, 3] = d(sum of K4's per-ball losses)/dx (see above). x [B, Mp, 3],
// tp [Mp, 3] float32; code [Mp, Mp] uint8, 16-byte aligned; Mp a multiple of
// 256 (the port passes multiples of 1024). Launches on `stream` and returns
// cudaGetLastError() (0 = success).
int w3d_desc_grad(const void* x, const void* tp, const void* code, int num_balls, int mp,
                  float cg, float cl, void* dx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mp <= 0 || mp % kCols != 0 || num_balls <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  desc_grad_kernel<<<mp / kRows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(tp),
      static_cast<const uint8_t*>(code), num_balls, mp, cg, cl, static_cast<float*>(dx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
