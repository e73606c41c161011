// K1, the per-tile alpha-blend forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wast3d_tpu/ops/rasterizer/pallas_blend.py::_fwd_kernel`
// (reached through `blend` -> `_blend_fwd_impl`) in its exact f32 tier. It is
// the reference `renderCUDA` forward: one block of 256 threads per 16x16 tile,
// one thread per pixel. The TPU kernel turns the serial transmittance
// recurrence into triangular-matrix products for its matrix unit; a thread per
// pixel walks the recurrence directly here, so nothing like that is needed.
//
// Per tile, the depth-sorted range [start, end) of the sorted rows is walked
// in batches of 256: each thread copies one row (48 B as three 16-byte loads)
// into shared memory, then every thread walks the batch in order with its own
// T. Per entry: power = -1/2 (A dx^2 + C dy^2) - B dx dy; skip if power > 0;
// alpha = min(0.99, opa exp(power)); skip if alpha < 1/255; if
// T (1 - alpha) < 1e-4 the pixel is done and this entry is not added;
// otherwise colour and depth gain weight alpha T and T <- T (1 - alpha).
// The block stops when __syncthreads_count(done) == 256.
//
// Rows are [K, 12] f32: mx, my, A, B, C, opa, depth, r, g, b, pad, pad, with
// means in image pixel coordinates. The TPU path recentres means on the tile
// for its bf16 tier; this f32 kernel does not need that.
// Outputs are written in image layout with the background composited
// (colour [H,W,3], depth [H,W], final_T [H,W]); pixels beyond W x H of an
// edge tile take part in nothing and write nothing.
//
// What bounds it on this card: bytes are 48 B x K of rows plus 20 B x H x W of
// output (plus 8 B per tile of ranges); work is (pixel, entry) evaluations x
// about 25 f32 operations plus one expf. At the 200k / 800x800 scene that is
// far below the f32 peak and the memory rate alike, so this simple version is
// bound by latency: the serial per-pixel walk, one block per tile, and the
// barrier per batch. Left for a later change: warp-level culling of entries
// that miss the whole warp, `cp.async` double buffering of the batches, and
// balancing long tiles across blocks.
//
// Built without --use_fast_math, so expf is the accurate one and the kernel
// can be held tightly to its plain PyTorch version
// (`wast3d_tpu_torch/ops/rasterizer/blend.py::blend_fwd_reference`).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kBlock)
blend_fwd_kernel(const float4* __restrict__ rows,  // [K, 3] float4 = [K, 12] f32
                 const int* __restrict__ starts, const int* __restrict__ ends,
                 const float2* __restrict__ offsets,  // [H, W] or null
                 const float* __restrict__ bg,        // [3]
                 float* __restrict__ color, float* __restrict__ depth,
                 float* __restrict__ final_t, int width, int height, int grid_x) {
  __shared__ float4 batch[kBlock * 3];

  const int tile = blockIdx.x;
  const int x = (tile % grid_x) * kTile + threadIdx.x % kTile;
  const int y = (tile / grid_x) * kTile + threadIdx.x / kTile;
  const bool inside = x < width && y < height;
  float px = static_cast<float>(x);
  float py = static_cast<float>(y);
  if (inside && offsets != nullptr) {
    const float2 o = offsets[static_cast<size_t>(y) * width + x];
    px += o.x;
    py += o.y;
  }

  const int start = starts[tile];
  const int end = ends[tile];
  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  bool done = !inside;

  for (int base = start; base < end; base += kBlock) {
    // Also the barrier that keeps the previous batch alive until all are done.
    if (__syncthreads_count(done) == kBlock) break;
    const int i = base + threadIdx.x;
    if (i < end) {
      const float4* src = rows + 3 * static_cast<size_t>(i);
      batch[3 * threadIdx.x + 0] = src[0];
      batch[3 * threadIdx.x + 1] = src[1];
      batch[3 * threadIdx.x + 2] = src[2];
    }
    __syncthreads();
    const int count = min(kBlock, end - base);
    for (int j = 0; !done && j < count; ++j) {
      const float4 a = batch[3 * j + 0];  // mx, my, A, B
      const float4 b = batch[3 * j + 1];  // C, opa, depth, r
      const float4 c = batch[3 * j + 2];  // g, b, pad, pad
      const float dx = a.x - px;
      const float dy = a.y - py;
      const float power = -0.5f * (a.z * dx * dx + b.x * dy * dy) - a.w * dx * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(kAlphaMax, b.y * expf(power));
      if (alpha < kAlphaMin) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < kTEps) {
        done = true;
        break;
      }
      const float w = alpha * T;
      acc_d += b.z * w;
      acc_r += b.w * w;
      acc_g += c.x * w;
      acc_b += c.y * w;
      T = test_t;
    }
  }

  if (inside) {
    const size_t p = static_cast<size_t>(y) * width + x;
    color[3 * p + 0] = acc_r + T * bg[0];
    color[3 * p + 1] = acc_g + T * bg[1];
    color[3 * p + 2] = acc_b + T * bg[2];
    depth[p] = acc_d;
    final_t[p] = T;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = success). Synchronises nothing and allocates nothing.
int w3d_blend_fwd(const void* rows, const void* starts, const void* ends,
                  const void* offsets, const void* bg, void* color, void* depth,
                  void* final_t, int width, int height, int grid_x, int num_tiles,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    blend_fwd_kernel<<<num_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(rows), static_cast<const int*>(starts),
        static_cast<const int*>(ends), static_cast<const float2*>(offsets),
        static_cast<const float*>(bg), static_cast<float*>(color),
        static_cast<float*>(depth), static_cast<float*>(final_t), width, height,
        grid_x);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* w3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
