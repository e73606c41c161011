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
// of w ddepth, w dr, w dg, w db. Entries are taken in batches of 32 through
// shared memory. Each warp reduces the ten values of an entry with shuffles
// (skipped when no lane of the warp contributes), lane 0 stores the warp's
// partial sums, and after a barrier 32 threads add the 8 warps' partials in a
// fixed order and turn them into the row gradient (mx, my, A, B, C, opa,
// depth, r, g, b; columns 10 and 11 stay zero). Every duplicate belongs to
// one tile, so no two blocks write one row: there are no atomics and the
// result is the same bit for bit from run to run.
//
// What bounds it on this card: bytes are 48 B x K of rows in and out plus
// 40 B per pixel of forward outputs and cotangents; work is (pixel, entry)
// evaluations x about 64 f32 operations (recompute, gradient, and the
// ten-value reduction). Both are far below what the card can do at the
// 200k / 800x800 scene, so this simple version is bound by latency: the
// serial walk, the shuffle reductions per entry and warp, and two barriers
// per batch of 32. Left for later: reducing only the live lanes, larger
// batches with per-warp partials kept across entries, and splitting long
// tiles over several blocks.
//
// Built without --use_fast_math, so expf and the divisions are the accurate
// ones, as in K1 and in the plain version
// (`wast3d_tpu_torch/ops/rasterizer/blend.py::blend_bwd_reference`).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr int kWarps = kBlock / 32;
constexpr int kBatch = 32;
constexpr int kVals = 10;
constexpr int kPad = kVals + 1;  // odd stride: no bank conflicts in the final sum
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

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
  __shared__ float4 batch[kBatch * 3];
  __shared__ float partial[kWarps][kBatch][kPad];

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

  for (int base = start; base < end; base += kBatch) {
    // Also the barrier that keeps the previous batch and partials alive
    // until the final sums of that batch are written.
    if (__syncthreads_count(done) == kBlock) break;
    const int count = min(kBatch, end - base);
    if (threadIdx.x < 3 * count) {
      batch[threadIdx.x] = rows[3 * static_cast<size_t>(base) + threadIdx.x];
    }
    __syncthreads();

    for (int j = 0; j < count; ++j) {
      float v[kVals];
#pragma unroll
      for (int k = 0; k < kVals; ++k) v[k] = 0.0f;
      bool live = false;
      if (!done) {
        const float4 a = batch[3 * j + 0];  // mx, my, A, B
        const float4 b = batch[3 * j + 1];  // C, opa, depth, r
        const float4 c = batch[3 * j + 2];  // g, b, pad, pad
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
              v[0] = dpow;
              v[1] = dpow * dx;
              v[2] = dpow * dy;
              v[3] = dpow * dx * dx;
              v[4] = dpow * dx * dy;
              v[5] = dpow * dy * dy;
              v[6] = w * gd;
              v[7] = w * gr;
              v[8] = w * gg;
              v[9] = w * gb;
              T = test_t;
              live = true;
            }
          }
        }
      }
      if (__any_sync(kFull, live)) {
#pragma unroll
        for (int k = 0; k < kVals; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v[k] += __shfl_down_sync(kFull, v[k], off);
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kVals; ++k) partial[warp][j][k] = v[k];
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
        for (int w = 0; w < kWarps; ++w) t += partial[w][j][k];
        s[k] = t;
      }
      const float A = batch[3 * j + 0].z;
      const float B = batch[3 * j + 0].w;
      const float C = batch[3 * j + 1].x;
      const float opa = batch[3 * j + 1].y;
      float4* dst = drows + 3 * static_cast<size_t>(base + j);
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
  if (num_tiles > 0) {
    blend_bwd_kernel<<<num_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
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
