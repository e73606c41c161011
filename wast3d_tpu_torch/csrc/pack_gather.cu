// Kg, the serving gather of the bf16 tier (`RasterizeSettings.pack_gather`),
// for Hopper (sm_90a).
//
// Replaces the `pack_gather` branch of
// `wast3d_tpu/ops/rasterizer/pallas_path.py::render_pallas` (:150-190), which
// XLA compiles there (it is not a `pallas_call`). It builds the rows that K1f
// reads, [K, 16] bf16 (mx, my, A, B, C, opa, depth, r, g, b, six zeros; the
// means recentred on the owning tile's pixel origin), with JAX's roundings:
//
//   per Gaussian i < N in depth order (g = depth_order[i]): hi = bf(m),
//     lo = bf(m - f32(hi)) for each mean coordinate m, and the eight other
//     fields rounded to bf16; the sentinel i = N is all zeros;
//   per duplicate k < K: the row of i = rank[k] on tile t = tile_of_dup[k],
//     ox = 16 (t mod grid_x), oy = 16 (t div grid_x),
//     mx = bf((f32(hi_x) - ox) + f32(lo_x)) and my likewise, in that order,
//     each operation rounded to nearest in f32; the other fields copied.
//
// bf(x) rounds to bfloat16, to nearest with ties to even (`cvt.rn.bf16.f32`,
// as `.to(torch.bfloat16)` and JAX's `astype` round).
//
// What bounds it: bytes. Each input read once and each row written once is
// N (40 + 8) + K (16 + 32) bytes, 41.9 MB at 200k / 800² (K = 673,197),
// 12.5 us at 3.35 TB/s; the duplicates read their Gaussian in random order,
// which L2 (50 MB) absorbs. One persistent, cooperative launch: one block
// per resident slot (SMs x occupancy), launched with
// cudaLaunchCooperativeKernel.
//
//   Phase 1 packs the N Gaussians, in memory order so that the fields are
//     read coalesced, into 32-byte rows (16 bf16 slots, 12 used: hi_x lo_x
//     hi_y lo_y A B C opa depth r g b), one L2 sector each, plus the zero
//     row N, stored with an L2 evict_last policy.
//   grid.sync().
//   Phase 2 takes a duplicate's Gaussian g = depth_order[rank] (N for the
//     sentinel rank) and reads row g as a 16-byte and an 8-byte load from
//     that one sector (ld.global.cg with the evict_last policy, so the 6.4 MB
//     of rows and the depth order stay in L2 while the 21.5 MB of output
//     streams past them with st.global.cs). The packed row's words 2-4 (A B,
//     C opa, depth r) and 5 (g b) are the output row's words 1-3 and 4: the
//     gather computes one word and copies four.
//
// Both phases write a row as two 16-byte halves from two neighbouring
// threads, so that a warp's store covers 512 contiguous bytes. rank and
// tile_of_dup are read under an L2 evict_first policy. `tools/kg_variants.py`
// times this kernel beside other forms of it (whole rows a thread, the pack
// in depth order, no L2 hints, more duplicates in flight a thread, and a
// design without the packed rows). A launch error, or a grid larger than can
// be resident, returns an error; nothing falls back.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 16;
constexpr int kMaxDevices = 64;

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

// bf((f32(hi) - o) + f32(lo)) of a split word.
__device__ __forceinline__ float recentre(uint32_t w, float o) {
  return __fadd_rn(__fsub_rn(bf16_value(w & 0xFFFFu), o), bf16_value(w >> 16));
}

// L2 policies: evict_last for what is read again (the packed rows, the
// depth order), evict_first for what streams past (the fields, rank,
// tile_of_dup; the output uses st.global.cs). The read-only inputs' loads
// (.nc) may move; the packed rows' loads stay after the grid barrier.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ long long load_i64(const long long* p, uint64_t policy) {
  long long v;
  asm("ld.global.nc.L2::cache_hint.s64 %0, [%1], %2;" : "=l"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ float load_f32(const float* p, uint64_t policy) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ float2 load_f32x2(const float2* p, uint64_t policy) {
  float2 v;
  asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void store_keep(uint4* p, uint4 v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy)
               : "memory");
}

__device__ __forceinline__ uint4 load_keep4(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.cg.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint2 load_keep2(const uint2* p, uint64_t policy) {
  uint2 v;
  asm volatile("ld.global.cg.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

struct Fields {
  const float* means2d;
  const float* conics;
  const float* opacities;
  const float* depths;
  const float* colors;
};

// Half `half` of the 32-byte packed row of Gaussian g: half 0 is (hi_x
// lo_x, hi_y lo_y, A B, C opa), half 1 (depth r, g b, 0, 0); the fields
// read under `policy`.
__device__ __forceinline__ uint4 packed_half(const Fields& f, long long g, int half,
                                             uint64_t policy) {
  if (half) {
    const float* rgb = f.colors + 3 * g;
    return make_uint4(pair(load_f32(f.depths + g, policy), load_f32(rgb, policy)),
                      pair(load_f32(rgb + 1, policy), load_f32(rgb + 2, policy)), 0u, 0u);
  }
  const float2 m = load_f32x2(reinterpret_cast<const float2*>(f.means2d) + g, policy);
  const float* c = f.conics + 3 * g;
  return make_uint4(split(m.x), split(m.y), pair(load_f32(c, policy), load_f32(c + 1, policy)),
                    pair(load_f32(c + 2, policy), load_f32(f.opacities + g, policy)));
}

// The output row's 16-byte half `half` for a duplicate on tile t, from the
// packed words a = (hi_x lo_x, hi_y lo_y, A B, C opa) and b = (depth r,
// g b): half 0 is (mx my, A B, C opa, depth r), half 1 (g b, 0, 0, 0).
__device__ __forceinline__ uint4 row_half(int half, uint4 a, uint2 b, long long t, int grid_x) {
  if (half) return make_uint4(b.y, 0u, 0u, 0u);
  const int tile = static_cast<int>(t);  // 32-bit division: tiles < 2^31
  const float ox = static_cast<float>((tile % grid_x) * kTile);
  const float oy = static_cast<float>((tile / grid_x) * kTile);
  return make_uint4(pair(recentre(a.x, ox), recentre(a.y, oy)), a.z, a.w, b.x);
}

__global__ void __launch_bounds__(kBlock)
pack_gather_cooperative(Fields f, const long long* __restrict__ depth_order, int n,
                        const long long* __restrict__ rank,
                        const long long* __restrict__ tile_of_dup, int k, int grid_x,
                        uint4* __restrict__ packed, uint4* __restrict__ rows) {
  const uint64_t keep = evict_last_policy(), stream = evict_first_policy();
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  const long long first = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  // Phase 1, two slots a row: row g holds Gaussian g; row N is the zero
  // sentinel.
  for (long long s = first; s < 2 * (static_cast<long long>(n) + 1); s += stride) {
    const long long g = s >> 1;
    const int half = static_cast<int>(s & 1);
    store_keep(packed + 2 * g + half,
               g < n ? packed_half(f, g, half, stream) : make_uint4(0u, 0u, 0u, 0u), keep);
  }
  cg::this_grid().sync();
  // Phase 2, two slots a duplicate: rank -> the Gaussian (depth_order, or
  // the sentinel) -> its packed row.
  for (long long s = first; s < 2 * static_cast<long long>(k); s += stride) {
    const long long d = s >> 1;
    const int half = static_cast<int>(s & 1);
    const long long r = load_i64(rank + d, stream);
    const long long t = load_i64(tile_of_dup + d, stream);
    const long long g = r < n ? load_i64(depth_order + r, keep) : n;
    const uint4* p = packed + 2 * g;
    const uint4 a = load_keep4(p, keep);
    const uint2 b = load_keep2(reinterpret_cast<const uint2*>(p + 1), keep);
    store_stream(rows + 2 * d + half, row_half(half, a, b, t, grid_x));
  }
}

// The cooperative grid of each device: SMs x resident blocks of the kernel.
int cooperative_blocks(int device, int* blocks) {
  static int cached[kMaxDevices] = {0};
  if (device >= 0 && device < kMaxDevices && cached[device] > 0) {
    *blocks = cached[device];
    return 0;
  }
  int sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pack_gather_cooperative, kBlock, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || sms * per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks = sms * per_sm;
  if (device >= 0 && device < kMaxDevices) cached[device] = *blocks;
  return 0;
}

}  // namespace

extern "C" {

// Kg. means2d [N, 2], conics [N, 3], opacities [N], depths [N], colors
// [N, 3] float32 contiguous (means2d 8-byte aligned); depth_order [N], rank
// [K] (in [0, N]) and tile_of_dup [K] int64; packed [(N + 1) * 32] bytes of
// scratch, 16-byte aligned; rows [K, 16] bf16 out.
// One launch on `stream`; returns its cudaError_t (0 = success).
// Synchronises nothing and allocates nothing.
int w3d_pack_gather(const void* means2d, const void* conics, const void* opacities,
                    const void* depths, const void* colors, const void* depth_order,
                    const void* rank, const void* tile_of_dup, void* packed, void* rows, int n,
                    int k, int grid_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || k < 0 || grid_x < 1) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  int rc = cooperative_blocks(device, &resident);
  if (rc != 0) return rc;
  const long long most = k > n + 1LL ? k : n + 1LL;  // rows of the longer phase
  const long long need = (2 * most + kBlock - 1) / kBlock;  // two threads a row
  int grid = static_cast<int>(need < resident ? need : resident);
  Fields f{static_cast<const float*>(means2d), static_cast<const float*>(conics),
           static_cast<const float*>(opacities), static_cast<const float*>(depths),
           static_cast<const float*>(colors)};
  const long long* order = static_cast<const long long*>(depth_order);
  const long long* rk = static_cast<const long long*>(rank);
  const long long* tl = static_cast<const long long*>(tile_of_dup);
  uint4* pk = static_cast<uint4*>(packed);
  uint4* out = static_cast<uint4*>(rows);
  void* args[] = {&f, &order, &n, &rk, &tl, &k, &grid_x, &pk, &out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(pack_gather_cooperative),
                                    dim3(grid), dim3(kBlock), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
