// What K4 (`desc_loss.cu`) and K5 (`desc_grad.cu`) share: the distance and
// weight of a pair, the pair list's entry layout, the asynchronous 4-byte
// copies that stream a row's entries through shared memory, and the
// ball-interleaved copy of x that both kernels read.
//
// Distances come from the coordinate differences, with explicitly rounded
// products and sums (no FMA contraction): D and T are exactly symmetric,
// exactly 0 for coincident points, and accurate for near-coincident ones.
// The TPU kernels use the MXU's expansion |a|^2 + |b|^2 - 2 a.b, whose
// float32 error of ~1e-7 |a|^2 in D^2 is all of D^2 for points 1e-4 apart;
// through K5's 1 / D it put the gradient 1.85e5 x max |g| from a float64
// evaluation (chip_smoke.py, k4k5_near_coincident, on an H100).
//
// The pair list (`desc_kernel.build_pair_list`): CSR over code | code^T,
// rows with their columns ascending, each entry one int32, the column j in
// bits 0-27, code[i, j] in bits 28-29 and code[j, i] in bits 30-31, and
// `row_order`, the rows longest first.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColBits = 28;                // an entry: column, then code[i, j], code[j, i]
constexpr uint32_t kColMask = (1u << kColBits) - 1u;
constexpr int kBalls = 8;                   // balls per pass over a row's entries

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

// W of a 2-bit code: cg * bit0 + cl * bit1.
__device__ __forceinline__ float weight(uint32_t c, float cg, float cl) {
  return __fadd_rn(__fmul_rn(cg, static_cast<float>(c & 1u)),
                   __fmul_rn(cl, static_cast<float>((c >> 1) & 1u)));
}

// W_ij + W_ji of an entry's 4 code bits.
__device__ __forceinline__ float weight_both(uint32_t bits, float cg, float cl) {
  return __fadd_rn(weight(bits & 3u, cg, cl), weight((bits >> 2) & 3u, cg, cl));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The "memory" clobbers keep the compiler from moving shared-memory reads
// across the copies and the wait (no barrier follows the wait in K4 or K5:
// each lane reads back only the slots it copied itself).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// xt [groups][Mp][kBalls] float4 from x [B, Mp, 3] and tp [Mp, 3]:
// xt[g][j][slot] = (x[8 g + slot][j], tp[j][slot] in the w of slots 0-2),
// so an entry's 8 balls and its tp_j are one 128-byte line; slots of balls
// past B hold zeros.
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

// Launches the interleaved copy into `xt` (ceil(B / 8) * Mp * 8 float4).
inline cudaError_t launch_interleave(const float* x, const float* tp, int num_balls, int mp,
                                     float4* xt, cudaStream_t s) {
  const long long total = static_cast<long long>((num_balls + kBalls - 1) / kBalls) * mp * kBalls;
  interleave_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      x, tp, num_balls, mp, total, xt);
  return cudaGetLastError();
}

}  // namespace
