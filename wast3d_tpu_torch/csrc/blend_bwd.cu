// K2, the per-tile alpha-blend backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wast3d_tpu/ops/rasterizer/pallas_blend.py::_bwd_kernel`
// (reached through `blend`'s VJP -> `_blend_bwd_impl`) in its exact f32 tier.
// One block of 256 threads per 16x16 tile, one thread per pixel, the same walk
// as K1 (`blend_fwd.cu`): the tile's depth-sorted range [start, end) front to
// back, with the same skip rules (power > 0, alpha < 1/255) and the same stop
// (before the entry that would take T below 1e-4), in the same order. alpha
// and T are recomputed; nothing per entry is stored by the forward.
//
// Gradients use the identity of the TPU kernel (not the reference CUDA
// backward's back-to-front walk, which needs a per-pixel last-contributor
// index that K1 does not store):
//   dL/dalpha_i = q_i T_i - (S_total - prefix_i(q w)) / (1 - alpha_i),
// q_i = dcolor . rgb_i + ddepth depth_i, w_i = alpha_i T_i, the prefix
// inclusive and taken in walk order in f32, and
//   S_total = dcolor . acc + ddepth depth + T_final dT_eff
// from the forward outputs. K1 composites the background itself
// (colour = acc + T_final bg), so acc = colour - T_final bg and
// dT_eff = dfinal_T + dcolour . bg. Where alpha was clamped to 0.99, or the
// entry was skipped or came after the stop, it gets no alpha gradient.
//
// Per entry the kernel needs ten sums over the tile's 256 pixels: of dpow =
// dL/dalpha alpha, of dpow dx, dpow dy, dpow dx^2, dpow dx dy, dpow dy^2, and
// of w ddepth, w dr, w dg, w db. They are formed by a transposed warp
// reduction: each lane holds the ten values of a group of three
// consecutive entries (30 slots, padded to 32), and one reduce-scatter
// butterfly (xor offsets 16, 8, 4, 2, 1; at each step a lane keeps half of
// its slots and adds its partner's copy of that half) leaves lane k with
// the warp's sum of slot k: 31 shuffle-and-adds per group of three, where
// a shuffle tree per value would take 3 x 10 x 5 = 150. Lanes 0-29 each
// store one sum to the per-warp partials. A group in which no lane of the
// warp contributes skips the butterfly and stores zeros; a warp whose 32
// pixels have all stopped skips the batch, and the final sums leave its
// partials out (they would add zeros: the same bits).
//
// Rows arrive in batches of 128 entries (48 B each), copied with 16-byte
// cp.async into one of two shared-memory buffers while the previous batch
// is walked, so a tile pays two barriers per 128 entries. After a batch's
// walk, thread j adds the 8 warps' partials of entry j in a fixed order
// and turns them into the row gradient (mx, my, A, B, C, opa, depth, r, g,
// b; columns 10 and 11 stay zero). The partials, [8 warps][128][10]
// floats, and the two row buffers take 52 KB of dynamic shared memory, so
// four blocks fit an SM (64 registers a thread allow four too).
// Every duplicate belongs to one tile, so no two blocks write one row: there
// are no atomics, the trees are fixed, and the result is the same bit for
// bit from run to run.
//
// What bounds it on this card: bytes are 48 B x K of rows in and out plus
// 40 B per pixel of forward outputs and cotangents; work is (pixel, entry)
// evaluations x about 60 f32 operations (recompute, gradient, and the
// ten-value reduction). Operations bound it, at ~0.08 ms for the
// 200k / 800x800 scene. The kernel spends instructions on every (pixel,
// entry) slot of a live warp, stopped or skipped pixels included: ~75 of
// recompute and gradient and ~40 of the butterfly's shuffles, selects and
// adds per lane and entry, over 256 x K slots, so the instruction rate
// holds it above that bound (more resident warps did not make it faster on
// the H100).
// Left for later: splitting long tiles over several blocks (the forward
// would have to store T at the split), the bf16 tier, tensor cores.
//
// Built without --use_fast_math, so expf and the divisions are the accurate
// ones, as in K1 and in the plain version
// (`wast3d_tpu_torch/ops/rasterizer/blend.py::blend_bwd_reference`).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr int kWarps = kBlock / 32;
constexpr int kBatch = 128;  // entries per batch
constexpr int kVecs = 3;     // float4 per row
constexpr int kVals = 10;
constexpr int kGroup = 3;    // entries per butterfly: kGroup * kVals <= 32 slots
constexpr size_t kSmemBytes =
    2 * kBatch * kVecs * sizeof(float4) + kWarps * kBatch * kVals * sizeof(float);
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One step of the reduce-scatter over the first 2H slots of v: the lane
// keeps the upper H slots if its bit H is set, else the lower H, and adds
// the partner's (lane ^ H) copy of them into v[0, H).
template <int H>
__device__ __forceinline__ void scatter_step(float (&v)[32], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? v[k] : v[k + H];
    const float keep = upper ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

__global__ void __launch_bounds__(kBlock)
blend_bwd_kernel(const float4* __restrict__ rows,  // [K, 3] float4 = [K, 12] f32
                 const int* __restrict__ starts, const int* __restrict__ ends,
                 const float2* __restrict__ offsets,  // [H, W] or null
                 const float* __restrict__ bg,        // [3]
                 const float* __restrict__ color,     // [H, W, 3] forward output
                 const float* __restrict__ depth,     // [H, W]
                 const float* __restrict__ final_t,   // [H, W]
                 const float* __restrict__ dcolor,    // cotangents, same shapes
                 const float* __restrict__ ddepth,
                 const float* __restrict__ dfinal_t,
                 float4* __restrict__ drows,  // [K, 3] float4, zero on entry
                 int width, int height, int grid_x) {
  extern __shared__ float4 smem[];
  __shared__ int s_live[kWarps];  // the warp had a pixel still walking this batch
  float4* const batches = smem;  // [2][kBatch * kVecs]
  float* const partial = reinterpret_cast<float*>(smem + 2 * kBatch * kVecs);  // [warp][entry][kVals]

  const int tile = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int x = (tile % grid_x) * kTile + threadIdx.x % kTile;
  const int y = (tile / grid_x) * kTile + threadIdx.x / kTile;
  const bool inside = x < width && y < height;
  float px = static_cast<float>(x);
  float py = static_cast<float>(y);
  float gr = 0.0f, gg = 0.0f, gb = 0.0f, gd = 0.0f, s_total = 0.0f;
  if (inside) {
    const size_t p = static_cast<size_t>(y) * width + x;
    if (offsets != nullptr) {
      const float2 o = offsets[p];
      px += o.x;
      py += o.y;
    }
    gr = dcolor[3 * p + 0];
    gg = dcolor[3 * p + 1];
    gb = dcolor[3 * p + 2];
    gd = ddepth[p];
    const float t_fin = final_t[p];
    const float dt_eff = dfinal_t[p] + gr * bg[0] + gg * bg[1] + gb * bg[2];
    s_total = gr * (color[3 * p + 0] - t_fin * bg[0]) +
              gg * (color[3 * p + 1] - t_fin * bg[1]) +
              gb * (color[3 * p + 2] - t_fin * bg[2]) + gd * depth[p] +
              t_fin * dt_eff;
  }

  const int start = starts[tile];
  const int end = ends[tile];
  float T = 1.0f;
  float prefix = 0.0f;
  bool done = !inside;

  // Rows [base, base + kBatch) of the tile's range into buffer `which`; one
  // commit group per call on every thread.
  auto stage = [&](int base, int which) {
    const int n = kVecs * min(kBatch, end - base);
    float4* dst = batches + which * kBatch * kVecs;
    for (int t = threadIdx.x; t < n; t += kBlock) {
      cp_async16(dst + t, rows + kVecs * static_cast<size_t>(base) + t);
    }
    cp_async_commit();
  };

  if (start < end) stage(start, 0);
  int which = 0;
  for (int base = start; base < end; base += kBatch, which ^= 1) {
    cp_async_wait_all();  // this thread's copies of the batch have landed
    // Makes the batch visible to every thread, and keeps the other buffer
    // and the partials alive until the previous batch's rows are written.
    if (__syncthreads_count(done) == kBlock) break;
    const int count = min(kBatch, end - base);
    if (base + kBatch < end) stage(base + kBatch, which ^ 1);
    const float4* batch = batches + which * kBatch * kVecs;
    const bool warp_live = __any_sync(kFull, !done);
    if (lane == 0) s_live[warp] = warp_live;

    for (int g = 0; warp_live && g < count; g += kGroup) {
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = 0.0f;
      bool live = false;
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        const int j = g + e;
        if (j < count && !done) {
          const float4 a = batch[kVecs * j + 0];  // mx, my, A, B
          const float4 b = batch[kVecs * j + 1];  // C, opa, depth, r
          const float4 c = batch[kVecs * j + 2];  // g, b, pad, pad
          const float dx = a.x - px;
          const float dy = a.y - py;
          const float power = -0.5f * (a.z * dx * dx + b.x * dy * dy) - a.w * dx * dy;
          // Written as K1's tests, negated, so that the two agree on every input.
          if (!(power > 0.0f)) {
            const float alpha = fminf(kAlphaMax, b.y * expf(power));
            if (!(alpha < kAlphaMin)) {
              const float test_t = T * (1.0f - alpha);
              if (test_t < kTEps) {
                done = true;
              } else {
                const float w = alpha * T;
                const float q = gr * b.w + gg * c.x + gb * c.y + gd * b.z;
                prefix += q * w;
                const float dpow =
                    alpha < kAlphaMax
                        ? (q * T - (s_total - prefix) / (1.0f - alpha)) * alpha
                        : 0.0f;
                v[kVals * e + 0] = dpow;
                v[kVals * e + 1] = dpow * dx;
                v[kVals * e + 2] = dpow * dy;
                v[kVals * e + 3] = dpow * dx * dx;
                v[kVals * e + 4] = dpow * dx * dy;
                v[kVals * e + 5] = dpow * dy * dy;
                v[kVals * e + 6] = w * gd;
                v[kVals * e + 7] = w * gr;
                v[kVals * e + 8] = w * gg;
                v[kVals * e + 9] = w * gb;
                T = test_t;
                live = true;
              }
            }
          }
        }
      }
      if (__any_sync(kFull, live)) {
        scatter_step<16>(v, lane);
        scatter_step<8>(v, lane);
        scatter_step<4>(v, lane);
        scatter_step<2>(v, lane);
        scatter_step<1>(v, lane);
      }
      // v[0]: the warp's sum of slot `lane` = value lane % 10 of entry g + lane / 10.
      const int j = g + lane / kVals;
      if (lane < kGroup * kVals && j < count) {
        partial[(warp * kBatch + j) * kVals + lane % kVals] = v[0];
      }
    }
    __syncthreads();

    if (threadIdx.x < count) {
      const int j = threadIdx.x;
      float s[kVals];
#pragma unroll
      for (int k = 0; k < kVals; ++k) {
        float t = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (s_live[w]) t += partial[(w * kBatch + j) * kVals + k];
        }
        s[k] = t;
      }
      const float A = batch[kVecs * j + 0].z;
      const float B = batch[kVecs * j + 0].w;
      const float C = batch[kVecs * j + 1].x;
      const float opa = batch[kVecs * j + 1].y;
      float4* dst = drows + kVecs * static_cast<size_t>(base + j);
      // mx, my, A, B | C, opa, depth, r | g, b, 0, 0
      dst[0] = make_float4(-(A * s[1] + B * s[2]), -(C * s[2] + B * s[1]),
                           -0.5f * s[3], -s[4]);
      dst[1] = make_float4(-0.5f * s[5], opa > 0.0f ? s[0] / opa : 0.0f, s[6], s[7]);
      dst[2] = make_float4(s[8], s[9], 0.0f, 0.0f);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = success). `drows` must be zero on entry: entries after a tile's
// early stop are not written. Synchronises nothing and allocates nothing.
int w3d_blend_bwd(const void* rows, const void* starts, const void* ends,
                  const void* offsets, const void* bg, const void* color,
                  const void* depth, const void* final_t, const void* dcolor,
                  const void* ddepth, const void* dfinal_t, void* drows, int width,
                  int height, int grid_x, int num_tiles, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Dynamic shared memory past 48 KB needs the attribute, set once per
  // device (devices 0-31; any other on every call).
  static unsigned configured = 0;
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (!(configured & bit) || bit == 0u) {
    err = cudaFuncSetAttribute(blend_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  if (num_tiles > 0) {
    blend_bwd_kernel<<<num_tiles, kBlock, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(rows), static_cast<const int*>(starts),
        static_cast<const int*>(ends), static_cast<const float2*>(offsets),
        static_cast<const float*>(bg), static_cast<const float*>(color),
        static_cast<const float*>(depth), static_cast<const float*>(final_t),
        static_cast<const float*>(dcolor), static_cast<const float*>(ddepth),
        static_cast<const float*>(dfinal_t), static_cast<float4*>(drows), width,
        height, grid_x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
