// Forms of Kg (`wast3d_tpu_torch/csrc/pack_gather.cu`) that the port does
// not ship, built and timed by `tools/kg_variants.py` beside the port's own
// kernel. Each gives the port's rows bit for bit. The macros choose a form;
// their defaults give the shipped kernel's code:
//
//   KGV_HALF_ROWS 1: two neighbouring threads write a row's two 16-byte
//     halves (a warp's store is 512 contiguous bytes); 0: one thread writes
//     its whole row (lanes 32 bytes apart).
//   KGV_CHAINS 1: duplicates in flight a thread in phase 2 (rank -> depth
//     order -> packed row), their loads issued together.
//   KGV_L2_HINTS 1: L2 evict_last / evict_first policies on the loads and
//     the packed rows' stores, st.global.cs on the output; 0: plain loads
//     (__ldg / __ldcg) and stores.
//   KGV_DEPTH_ORDER_PACK 0: phase 1 packs row g from Gaussian g, in memory
//     order, and phase 2 reads row depth_order[rank]; 1: phase 1 packs row
//     i from Gaussian depth_order[i] (the fields read at random) and phase
//     2 reads row rank.
//
// kgv_pack_gather is the cooperative design (pack, grid.sync(), gather), as
// the port's w3d_pack_gather takes its arguments. kgv_pack_gather_recompute
// is the design without the packed rows: each duplicate reads
// depth_order[rank[k]] and that Gaussian's f32 fields (about six L2 sectors)
// and rounds them itself.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef KGV_HALF_ROWS
#define KGV_HALF_ROWS 1
#endif
#ifndef KGV_CHAINS
#define KGV_CHAINS 1
#endif
#ifndef KGV_L2_HINTS
#define KGV_L2_HINTS 1
#endif
#ifndef KGV_DEPTH_ORDER_PACK
#define KGV_DEPTH_ORDER_PACK 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 16;
constexpr int kMaxDevices = 64;
constexpr int kSlotsPerRow = KGV_HALF_ROWS ? 2 : 1;
constexpr int kChains = KGV_CHAINS;

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  unsigned short d;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(d) : "f"(x));
  return d;
}

__device__ __forceinline__ float bf16_value(uint32_t bits) { return __uint_as_float(bits << 16); }

__device__ __forceinline__ uint32_t pair(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

__device__ __forceinline__ uint32_t split(float m) {
  const uint32_t hi = bf16_bits(m);
  return hi | (bf16_bits(__fsub_rn(m, bf16_value(hi))) << 16);
}

__device__ __forceinline__ float recentre(uint32_t w, float o) {
  return __fadd_rn(__fsub_rn(bf16_value(w & 0xFFFFu), o), bf16_value(w >> 16));
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy = 0;
#if KGV_L2_HINTS
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
#endif
  return policy;
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy = 0;
#if KGV_L2_HINTS
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
#endif
  return policy;
}

#if KGV_L2_HINTS
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
#else
__device__ __forceinline__ long long load_i64(const long long* p, uint64_t) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const float* p, uint64_t) { return __ldg(p); }
__device__ __forceinline__ float2 load_f32x2(const float2* p, uint64_t) { return __ldg(p); }
__device__ __forceinline__ void store_keep(uint4* p, uint4 v, uint64_t) { *p = v; }
__device__ __forceinline__ uint4 load_keep4(const uint4* p, uint64_t) { return __ldcg(p); }
__device__ __forceinline__ uint2 load_keep2(const uint2* p, uint64_t) { return __ldcg(p); }
__device__ __forceinline__ void store_stream(uint4* p, uint4 v) { *p = v; }
#endif

struct Fields {
  const float* means2d;
  const float* conics;
  const float* opacities;
  const float* depths;
  const float* colors;
};

// Half `half` of Gaussian g's packed row: (hi_x lo_x, hi_y lo_y, A B, C opa)
// or (depth r, g b, 0, 0).
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

// Output half `half` on tile t from the packed words a and b.
__device__ __forceinline__ uint4 row_half(int half, uint4 a, uint2 b, long long t, int grid_x) {
  if (half) return make_uint4(b.y, 0u, 0u, 0u);
  const int tile = static_cast<int>(t);
  const float ox = static_cast<float>((tile % grid_x) * kTile);
  const float oy = static_cast<float>((tile / grid_x) * kTile);
  return make_uint4(pair(recentre(a.x, ox), recentre(a.y, oy)), a.z, a.w, b.x);
}

// Slot s's share of output row d: its half, or the whole row.
__device__ __forceinline__ void write_slot(uint4* rows, long long d, long long s, uint4 a, uint2 b,
                                           long long t, int grid_x) {
  uint4* out = rows + 2 * d;
  if (KGV_HALF_ROWS) {
    const int half = static_cast<int>(s & 1);
    store_stream(out + half, row_half(half, a, b, t, grid_x));
  } else {
    store_stream(out, row_half(0, a, b, t, grid_x));
    store_stream(out + 1, row_half(1, a, b, t, grid_x));
  }
}

__global__ void __launch_bounds__(kBlock)
pack_gather_cooperative(Fields f, const long long* __restrict__ depth_order, int n,
                        const long long* __restrict__ rank,
                        const long long* __restrict__ tile_of_dup, int k, int grid_x,
                        uint4* __restrict__ packed, uint4* __restrict__ rows) {
  const uint64_t keep = evict_last_policy(), stream = evict_first_policy();
  const int stride = gridDim.x * kBlock;
  const int first = blockIdx.x * kBlock + threadIdx.x;
  const long long packed_slots = (static_cast<long long>(n) + 1) * kSlotsPerRow;
  for (long long s = first; s < packed_slots; s += stride) {
    const long long g = s / kSlotsPerRow;
#if KGV_DEPTH_ORDER_PACK
    const long long src = g < n ? load_i64(depth_order + g, stream) : n;
#else
    const long long src = g;
#endif
    uint4* out = packed + 2 * g;
    const bool live = g < n;
    if (KGV_HALF_ROWS) {
      const int half = static_cast<int>(s & 1);
      store_keep(out + half, live ? packed_half(f, src, half, stream) : make_uint4(0u, 0u, 0u, 0u),
                 keep);
    } else {
      store_keep(out, live ? packed_half(f, src, 0, stream) : make_uint4(0u, 0u, 0u, 0u), keep);
      store_keep(out + 1, live ? packed_half(f, src, 1, stream) : make_uint4(0u, 0u, 0u, 0u),
                 keep);
    }
  }
  cg::this_grid().sync();
  const long long slots = static_cast<long long>(k) * kSlotsPerRow;
  for (long long base = first; base < slots; base += static_cast<long long>(kChains) * stride) {
    long long s[kChains], d[kChains], r[kChains], t[kChains], g[kChains];
    uint4 a[kChains];
    uint2 b[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      s[c] = base + static_cast<long long>(c) * stride;
      d[c] = (s[c] < slots ? s[c] : base) / kSlotsPerRow;
      r[c] = load_i64(rank + d[c], stream);
      t[c] = load_i64(tile_of_dup + d[c], stream);
    }
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
#if KGV_DEPTH_ORDER_PACK
      g[c] = r[c];
#else
      g[c] = r[c] < n ? load_i64(depth_order + r[c], keep) : n;
#endif
    }
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const uint4* p = packed + 2 * g[c];
      a[c] = load_keep4(p, keep);
      b[c] = load_keep2(reinterpret_cast<const uint2*>(p + 1), keep);
    }
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (s[c] < slots) write_slot(rows, d[c], s[c], a[c], b[c], t[c], grid_x);
    }
  }
}

__global__ void __launch_bounds__(kBlock)
pack_gather_recompute(Fields f, const long long* __restrict__ depth_order, int n,
                      const long long* __restrict__ rank, const long long* __restrict__ tile_of_dup,
                      int k, int grid_x, uint4* __restrict__ rows) {
  const long long s = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (s >= static_cast<long long>(k) * kSlotsPerRow) return;
  const long long d = s / kSlotsPerRow;
  const uint64_t keep = evict_last_policy(), stream = evict_first_policy();
  const long long r = load_i64(rank + d, stream);
  const long long t = load_i64(tile_of_dup + d, stream);
  uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
  if (r < n) {
    const long long g = load_i64(depth_order + r, keep);
    if (!KGV_HALF_ROWS || (s & 1) == 0) a = packed_half(f, g, 0, keep);  // half 1 needs only b
    b = packed_half(f, g, 1, keep);
  }
  write_slot(rows, d, s, a, make_uint2(b.x, b.y), t, grid_x);
}

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

Fields fields(const void* means2d, const void* conics, const void* opacities, const void* depths,
              const void* colors) {
  return Fields{static_cast<const float*>(means2d), static_cast<const float*>(conics),
                static_cast<const float*>(opacities), static_cast<const float*>(depths),
                static_cast<const float*>(colors)};
}

}  // namespace

extern "C" {

// The cooperative design: w3d_pack_gather's arguments and contract.
int kgv_pack_gather(const void* means2d, const void* conics, const void* opacities,
                    const void* depths, const void* colors, const void* depth_order,
                    const void* rank, const void* tile_of_dup, void* packed, void* rows, int n,
                    int k, int grid_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || k < 0 || grid_x < 1) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  int rc = cooperative_blocks(device, &resident);
  if (rc != 0) return rc;
  const long long packed_slots = (static_cast<long long>(n) + 1) * kSlotsPerRow;
  const long long slots = static_cast<long long>(k) * kSlotsPerRow;
  const long long work = packed_slots > slots ? packed_slots : slots;
  const long long need = (work + kBlock - 1) / kBlock;
  int grid = static_cast<int>(need < resident ? need : resident);
  Fields f = fields(means2d, conics, opacities, depths, colors);
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

// The recompute design: kgv_pack_gather's arguments without the scratch.
int kgv_pack_gather_recompute(const void* means2d, const void* conics, const void* opacities,
                              const void* depths, const void* colors, const void* depth_order,
                              const void* rank, const void* tile_of_dup, void* rows, int n, int k,
                              int grid_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || k < 0 || grid_x < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0) {
    const long long slots = static_cast<long long>(k) * kSlotsPerRow;
    pack_gather_recompute<<<static_cast<unsigned>((slots + kBlock - 1) / kBlock), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        fields(means2d, conics, opacities, depths, colors),
        static_cast<const long long*>(depth_order), n, static_cast<const long long*>(rank),
        static_cast<const long long*>(tile_of_dup), k, grid_x, static_cast<uint4*>(rows));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
