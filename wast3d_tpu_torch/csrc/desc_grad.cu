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
// The TPU kernel evaluates every pair of its dense (row block, column block)
// tiles and adds each tile's row and column sums into one accumulator in its
// fast memory, which only works because its grid runs in order. Here the
// code's structure is taken out of the kernel: W is nonzero on ~1.2% of the
// pairs and the same for the whole fit, so the fit lists the pairs once
// (`desc_kernel.build_pair_list`): CSR over code | code^T, each entry one
// int32, the column j in bits 0-27, code[i, j] in bits 28-29 and code[j, i]
// in bits 30-31. The kernel walks that list and never reads the [Mp, Mp]
// code.
//
// One warp per row i: the row's entries stream through shared memory in
// 128-entry chunks, double-buffered with cp.async (the copy of chunk k + 1
// is in flight while chunk k is evaluated). Lane l copies and takes entries
// l, l + 32, ... of the row, so no lane idles inside a row but in its last
// 32; per entry it computes W_ij + W_ji from the 4 bits and T
// from tp, then D, R and R (x_i - x_j) for up to 8 balls, all of the entry's
// x_j loads issued before any use. x is first copied ball-interleaved,
// xt[group][j][slot] = (x[8 group + slot][j], tp[j][slot] in the w of slots
// 0-2), so an entry's 8 balls and its tp_j are one 128-byte line (reading x
// [B, Mp, 3] as it is, 8 + 1 scattered 12-byte loads an entry, was slower
// on the card). The 32 lanes' sums meet in a fixed xor-shuffle tree and
// the warp writes dx's row once: no atomics, and two runs give the same bits. Rows differ ~10x in
// length (every `global_stride`-th row carries the global descriptor's
// pairs); the warps take the rows longest first (`row_order`), so the long
// rows start early and the short ones fill the tail.
//
// What bounds it on this card: ~20 operations per entry and ~20 per entry
// and ball, against a few bytes per entry (the list, 4 bytes an entry, is
// read once; x and tp stay in the 50 MB L2): operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                   // rows (one per warp) per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;                 // entries per shared-memory stage
constexpr int kPerLane = kChunk / 32;
constexpr int kColBits = 28;                // an entry: column, then code[i, j], code[j, i]
constexpr int kBalls = 8;                   // balls per pass over a row's entries
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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The "memory" clobbers keep the compiler from moving shared-memory reads
// across the copies and the wait (no barrier follows the wait here).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// xt [groups][Mp][kBalls] float4 from x [B, Mp, 3] and tp [Mp, 3] (see above);
// slots of balls past B hold zeros.
__global__ void interleave_kernel(const float* __restrict__ x, const float* __restrict__ tp,
                                  int num_balls, int mp, long long total,
                                  float4* __restrict__ xt) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int slot = static_cast<int>(t % kBalls);
  const long long gj = t / kBalls;
  const int j = static_cast<int>(gj % mp);
  const int b = static_cast<int>(gj / mp) * kBalls + slot;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (b < num_balls) {
    const float* p = x + (static_cast<size_t>(b) * mp + j) * 3;
    v.x = p[0];
    v.y = p[1];
    v.z = p[2];
  }
  if (slot < 3) v.w = tp[3 * j + slot];
  xt[t] = v;
}

__global__ void __launch_bounds__(kThreads, 2)
desc_grad_kernel(const float* __restrict__ tp,        // [Mp, 3]
                 const float4* __restrict__ xt,       // [groups, Mp, kBalls]
                 const int* __restrict__ row_ptr,     // [Mp + 1]
                 const uint32_t* __restrict__ entries,  // [P]
                 const int* __restrict__ row_order,   // [Mp]
                 int num_balls, int mp, float cg, float cl,
                 float* __restrict__ dx) {            // [B, Mp, 3]
  __shared__ uint32_t s_list[kWarps][2][kChunk];  // slot 32 u + l: lane l's entry u
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= mp) return;  // the whole warp
  const int i = row_order[w];
  const int start = row_ptr[i], end = row_ptr[i + 1];
  const size_t ball_stride = static_cast<size_t>(mp) * 3;
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
    float xi[kBalls][3], acc[kBalls][3];
#pragma unroll
    for (int b = 0; b < kBalls; ++b) {
      const float4 q = xg[static_cast<size_t>(i) * kBalls + b];
      xi[b][0] = q.x;
      xi[b][1] = q.y;
      xi[b][2] = q.z;
      acc[b][0] = acc[b][1] = acc[b][2] = 0.0f;
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
        const int j = static_cast<int>(ent & ((1u << kColBits) - 1u));
        const uint32_t bits = ent >> kColBits;
        float4 q[kBalls];  // x_j of each ball; tp_j in the w of q[0..2]
#pragma unroll
        for (int b = 0; b < kBalls; ++b) q[b] = __ldg(xg + static_cast<size_t>(j) * kBalls + b);
        const float wsum = __fadd_rn(weight(bits & 3u, cg, cl), weight((bits >> 2) & 3u, cg, cl));
        const float t = dist(tix, tiy, tiz, q[0].w, q[1].w, q[2].w);
#pragma unroll
        for (int b = 0; b < kBalls; ++b) {
          if (b < nb) {
            const float ex = __fsub_rn(xi[b][0], q[b].x), ey = __fsub_rn(xi[b][1], q[b].y),
                        ez = __fsub_rn(xi[b][2], q[b].z);
            const float d = sqrtf(dot3(ex, ey, ez, ex, ey, ez));
            const float f = __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, wsum), __fsub_rn(d, t)),
                                      fmaxf(d, kEps));
            acc[b][0] = __fadd_rn(acc[b][0], __fmul_rn(f, ex));
            acc[b][1] = __fadd_rn(acc[b][1], __fmul_rn(f, ey));
            acc[b][2] = __fadd_rn(acc[b][2], __fmul_rn(f, ez));
          }
        }
      }
    }
    cp_async_wait<0>();

    // The 32 lanes' sums, by a fixed xor tree (every lane ends with the total).
#pragma unroll
    for (int b = 0; b < kBalls; ++b) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc[b][k] = __fadd_rn(acc[b][k], __shfl_xor_sync(0xffffffffu, acc[b][k], off));
        }
      }
    }
    if (lane < 3 * nb) {
      float v = 0.0f;
#pragma unroll
      for (int b = 0; b < kBalls; ++b) {
#pragma unroll
        for (int k = 0; k < 3; ++k) v = lane == 3 * b + k ? acc[b][k] : v;
      }
      dx[static_cast<size_t>(b0 + lane / 3) * ball_stride + 3 * i + lane % 3] = v;
    }
  }
}

}  // namespace

extern "C" {

// dx [B, Mp, 3] = d(sum of K4's per-ball losses)/dx (see above). x [B, Mp, 3],
// tp [Mp, 3] float32; the pair list: row_ptr [Mp + 1], entries [P] and
// row_order [Mp], int32; scratch: ceil(B / 8) * Mp * 32 floats, 16-byte
// aligned, for the interleaved copy. Launches the copy and the kernel on
// `stream` and returns cudaGetLastError() (0 = success).
int w3d_desc_grad(const void* x, const void* tp, const void* row_ptr, const void* entries,
                  const void* row_order, void* scratch, int num_balls, int mp, float cg,
                  float cl, void* dx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mp <= 0 || num_balls <= 0 || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* tpp = static_cast<const float*>(tp);
  float4* xt = static_cast<float4*>(scratch);
  const long long total = static_cast<long long>((num_balls + kBalls - 1) / kBalls) * mp * kBalls;
  interleave_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      xp, tpp, num_balls, mp, total, xt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  desc_grad_kernel<<<(mp + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      tpp, xt, static_cast<const int*>(row_ptr), static_cast<const uint32_t*>(entries),
      static_cast<const int*>(row_order), num_balls, mp, cg, cl, static_cast<float*>(dx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
