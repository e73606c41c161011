// Kg, the serving gather of the bf16 tier (`RasterizeSettings.pack_gather`),
// for Hopper (sm_90a).
//
// Replaces the `pack_gather` branch of
// `wast3d_tpu/ops/rasterizer/pallas_path.py::render_pallas` (:150-190), which
// XLA compiles there (it is not a `pallas_call`). It builds the rows that K1f
// reads, [K, 16] bf16 (mx, my, A, B, C, opa, depth, r, g, b, six zeros; the
// means recentred on the owning tile's pixel origin), from 24 bytes a
// duplicate instead of the f32 gather's 40:
//
//   pack (one thread per slot i <= N): for i < N, g = depth_order[i],
//     hi = bf(m), lo = bf(m - f32(hi)) for each mean coordinate m, and the
//     eight other fields rounded to bf16; packed[i] = (hi_x, lo_x, hi_y,
//     lo_y, A, B, C, opa, depth, r, g, b), 12 bf16 = 6 words = 24 bytes;
//     packed[N] = 0, the sentinel row.
//   gather (one thread per duplicate k < K): p = packed[rank[k]], tile
//     t = tile_of_dup[k], ox = 16 (t mod grid_x), oy = 16 (t div grid_x);
//     mx = bf((f32(hi_x) - ox) + f32(lo_x)) and my likewise, in that order,
//     each operation rounded to nearest in f32; the other fields are copied.
//
// bf(x) rounds to bfloat16, to nearest with ties to even (`cvt.rn.bf16.f32`,
// as `.to(torch.bfloat16)` and JAX's `astype` round). A packed row's words 2-5
// (A B, C opa, depth r, g b) are already the output row's words 1-4, so the
// gather computes one word and copies four. A packed row is three 8-byte
// loads (24-byte rows are 8-byte aligned) and an output row two 16-byte
// stores. What bounds it: bytes, N (40 + 8 + 24) for the pack and
// K (16 + 24 + 32) for the gather, the packed rows read in random order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 16;

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  unsigned short d;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(d) : "f"(x));
  return d;
}

__device__ __forceinline__ float bf16_value(uint32_t bits) { return __uint_as_float(bits << 16); }

__device__ __forceinline__ uint32_t pair(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// The two words of one mean coordinate: hi in the low half, lo in the high.
__device__ __forceinline__ uint32_t split(float m) {
  const uint32_t hi = bf16_bits(m);
  return hi | (bf16_bits(__fsub_rn(m, bf16_value(hi))) << 16);
}

__global__ void __launch_bounds__(kBlock)
pack_kernel(const float* __restrict__ means2d, const float* __restrict__ conics,
            const float* __restrict__ opacities, const float* __restrict__ depths,
            const float* __restrict__ colors, const long long* __restrict__ depth_order, int n,
            uint2* __restrict__ packed) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i > n) return;
  uint2* out = packed + 3 * static_cast<long long>(i);
  if (i == n) {
    out[0] = out[1] = out[2] = make_uint2(0u, 0u);
    return;
  }
  const long long g = depth_order[i];
  const float2 m = __ldg(reinterpret_cast<const float2*>(means2d) + g);
  const float* c = conics + 3 * g;
  const float* rgb = colors + 3 * g;
  out[0] = make_uint2(split(m.x), split(m.y));
  out[1] = make_uint2(pair(__ldg(c), __ldg(c + 1)), pair(__ldg(c + 2), __ldg(opacities + g)));
  out[2] = make_uint2(pair(__ldg(depths + g), __ldg(rgb)), pair(__ldg(rgb + 1), __ldg(rgb + 2)));
}

__global__ void __launch_bounds__(kBlock)
gather_kernel(const uint2* __restrict__ packed, const long long* __restrict__ rank,
              const long long* __restrict__ tile_of_dup, int k, int grid_x,
              uint4* __restrict__ rows) {
  const int d = blockIdx.x * kBlock + threadIdx.x;
  if (d >= k) return;
  const uint2* p = packed + 3 * __ldg(rank + d);
  const long long t = __ldg(tile_of_dup + d);
  const uint2 w01 = __ldg(p), w23 = __ldg(p + 1), w45 = __ldg(p + 2);
  const float ox = static_cast<float>(static_cast<int>(t % grid_x) * kTile);
  const float oy = static_cast<float>(static_cast<int>(t / grid_x) * kTile);
  const float mx = __fadd_rn(__fsub_rn(bf16_value(w01.x & 0xFFFFu), ox), bf16_value(w01.x >> 16));
  const float my = __fadd_rn(__fsub_rn(bf16_value(w01.y & 0xFFFFu), oy), bf16_value(w01.y >> 16));
  uint4* out = rows + 2 * static_cast<long long>(d);
  out[0] = make_uint4(pair(mx, my), w23.x, w23.y, w45.x);
  out[1] = make_uint4(w45.y, 0u, 0u, 0u);
}

}  // namespace

extern "C" {

// Kg. means2d [N, 2], conics [N, 3], opacities [N], depths [N], colors [N, 3]
// float32 contiguous; depth_order [N] int64; packed [(N + 1) * 6] uint32
// scratch. Launches the pack on `stream` and returns cudaGetLastError()
// (0 = success). Synchronises nothing and allocates nothing.
int w3d_pack_rows(const void* means2d, const void* conics, const void* opacities,
                  const void* depths, const void* colors, const void* depth_order, void* packed,
                  int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  pack_kernel<<<n / kBlock + 1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means2d), static_cast<const float*>(conics),
      static_cast<const float*>(opacities), static_cast<const float*>(depths),
      static_cast<const float*>(colors), static_cast<const long long*>(depth_order), n,
      static_cast<uint2*>(packed));
  return static_cast<int>(cudaGetLastError());
}

// The gather: packed from w3d_pack_rows, rank and tile_of_dup [K] int64 with
// rank in [0, N], rows [K, 16] bf16 out (32-byte rows, 16-byte aligned).
int w3d_gather_rows(const void* packed, const void* rank, const void* tile_of_dup, void* rows,
                    int k, int grid_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 0 || grid_x < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0) {
    gather_kernel<<<(k + kBlock - 1) / kBlock, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint2*>(packed), static_cast<const long long*>(rank),
        static_cast<const long long*>(tile_of_dup), k, grid_x, static_cast<uint4*>(rows));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
