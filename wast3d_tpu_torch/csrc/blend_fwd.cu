// K1, the per-tile alpha-blend forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wast3d_tpu/ops/rasterizer/pallas_blend.py::_fwd_kernel`
// (reached through `blend` -> `_blend_fwd_impl`) in its exact f32 tier. It is
// the reference `renderCUDA` forward: one block of 256 threads per 16x16 tile,
// one thread per pixel. The TPU kernel turns the serial transmittance
// recurrence into triangular-matrix products for its matrix unit; a thread per
// pixel walks the recurrence directly here, so nothing like that is needed.
//
// Per pixel, the tile's depth-sorted range [start, end) is walked in order
// with the pixel's own T. Per entry: power = -1/2 (A dx^2 + C dy^2) - B dx dy;
// skip if power > 0; alpha = min(0.99, opa exp(power)); skip if alpha < 1/255;
// if T (1 - alpha) < 1e-4 the pixel is done and this entry is not added;
// otherwise colour and depth gain weight alpha T and T <- T (1 - alpha).
//
// Rows are [K, 12] f32: mx, my, A, B, C, opa, depth, r, g, b, pad, pad, with
// means in image pixel coordinates. Outputs are written in image layout with
// the background composited (colour [H,W,3], depth [H,W], final_T [H,W]);
// pixels beyond W x H of an edge tile take part in nothing and write nothing.
//
// Batches: rows arrive 128 entries at a time, copied with 16-byte cp.async
// into one of two shared-memory buffers (12 KB) while the previous batch is
// walked. A barrier per batch makes it visible and ends the block once all 256
// pixels are done (__syncthreads_count); a second one follows the batch's
// per-entry part of the cull.
//
// Per-warp culling: a warp holds 8 x 4 pixels, and most entries of a tile
// reach only some of its warps. At the start each warp takes the box of its
// inside lanes' sample positions (pixel plus jitter offset; min and max by
// shuffles). Per batch, thread t computes the per-entry part of the test for
// entry t (`cull_prelude`: validity, 1/A, 1/C, the threshold from logf), and
// lane l of each warp then tests entries l, l + 32, l + 64 and l + 96 against
// the warp's box (`culled`); a ballot turns the tests into four 32-bit keep
// words, and the warp walks only the kept entries, in order (__ffs, clear the
// lowest bit). An entry is culled only where every lane of the warp would
// skip it, and a skipped entry changes neither T nor the sums, so every pixel
// sees the same accepted entries in the same order, with the same
// expressions: the output is the same bit for bit as without the cull (and as
// the parent's one-thread-per-pixel kernel). `w3d_blend_fwd_walk_all` runs
// the same kernel with the cull off, so that a check can show it.
// 8 x 4 rather than 16 x 2 pixels: a splat meets the squarer box less often
// (1.54 M against 1.97 M warp iterations at the 200k / 800x800 scene, from
// 3.65 M without the cull). The walk takes two kept entries per step: both
// alphas first, then each entry in order, so their latencies overlap.
//
// What bounds it on this card: bytes are 48 B x K of rows plus 20 B x H x W of
// output; work is about 26 f32 operations per (pixel, entry) pair that
// contributes. At the 200k / 800x800 scene (K ~ 673k, 22.1 M contributing
// pairs) that is 45 MB, 0.0135 ms at 3.35 TB/s, against 0.009 ms of
// operations: bytes bound it. The kernel is held instead by instruction
// issue: a warp iteration is ~49 instructions (three shared loads, the conic,
// an accurate expf of ~10, the tests, four FMAs) for all 32 lanes, of which
// only ~45% take the entry, and the tests add ~0.02 ms. Left for later: the
// bf16 tier, and balancing long tiles across blocks (the stop rule makes
// compositing split segments inexact).
//
// Built without --use_fast_math, so expf and logf are the accurate ones and
// the kernel can be held tightly to its plain PyTorch version
// (`wast3d_tpu_torch/ops/rasterizer/blend.py::blend_fwd_reference`; the cull's
// plain version is `warp_keep_reference` there).
//
// K1f, the bf16 tier (`fast_chain`, JAX's serving default): the same kernel
// with kFast set replaces the `fast=True` body of the same TPU kernel
// (`_chunk_quantities_fast` / `_fast_quad`, `pallas_blend.py:276-400`). The
// walk, batches and cull are K1's; per (pixel, entry) power stays f32 (as
// JAX's serving route, `quad_power`, computes it at f32 class), and the
// chain rounds to bfloat16 from alpha on, with __float2bfloat16_rn at the
// points of `blend.py`'s module docstring: alpha = min(bf(0.99),
// bf(bf(opa) bf(expf(power)))), s = bf(log1pf(-alpha)), T = bf(expf(bf(logT)))
// from the f32 running sum logT of s, the stop on bf(T bf(1 - alpha)), and
// w = bf(alpha T); compares, logT, final_T = expf(logT) and the sums stay
// f32. No coordinate is rounded, so JAX's recentring on the tile origin
// before its casts is not needed. Its cull widens the margin by the bf16
// roundings (`cull_prelude`). Its plain versions are
// `blend_fwd_fast_reference` and `warp_keep_reference(..., fast=True)`.
// It reads and writes K1's bytes and adds a log1pf, an expf and seven
// roundings per taken pair (~36 f32 operations a contributing pair, each
// rounding and transcendental counted as one, against K1's ~26): as a simple
// kernel that is right it computes in f32 and rounds, so it is no faster
// than K1; two entries per bf16x2 op and bf16 rows are for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr int kWarpW = 8, kWarpH = 4;  // each warp's pixels
constexpr int kBatch = 128;         // entries per batch
constexpr int kVecs = 3;            // float4 per row
constexpr int kWords = kBatch / 32;  // keep words per warp and batch
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

// The cull's constants (see `culled`).
constexpr float kU = 5.9604645e-8f;  // 2^-24, the unit roundoff of f32
constexpr float kOpaCull = kAlphaMin * (1.0f - 64.0f * kU);
constexpr float kConicMin = 1e-30f;
constexpr float kTermMax = 1e30f;

// The bf16 tier's clamp (0.99 rounded to bfloat16) and its cull's margins.
constexpr float kAlphaMaxBf16 = 0.98828125f;
constexpr float kOpaCullFast = kAlphaMin * (1.0f - 0.015625f);  // 1 - 2^-6
constexpr float kTauFast = 0.03125f;                            // 2^-5

// x rounded to bfloat16 (to nearest, ties to even) and back.
__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

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

__device__ __forceinline__ float quad(float A, float B, float C, float dx, float dy) {
  return A * dx * dx + 2.0f * B * dx * dy + C * dy * dy;
}

// The cull: true where no sample of a warp's box [x0, x1] x [y0, y1] can take
// an entry, split into a part per entry (`cull_prelude`, once per block) and
// a part per box (`culled`, once per warp).
//
// A lane takes an entry only if alpha = opa expf(power) >= 1/255, with power
// = -Q/2, Q(dx, dy) = A dx^2 + 2B dx dy + C dy^2, i.e. only if Q <= tau =
// 2 ln(255 opa). The test culls where opa < 1/255 (less a margin), or where
// the least Q over the box exceeds tau by a margin. It keeps every row with a
// non-finite value, a conic that is not positive definite (power > 0 is then
// possible; A C (1 - 2^-20) > B^2 makes the exact A C - B^2 positive), A or C
// below 1e-30 (so 1/A and 1/C are finite), or terms that could overflow.
//
// The least Q: each lane's dx = fl(mx - px) lies in [fl(mx - x1), fl(mx - x0)]
// (rounding is monotone), likewise dy. Q is convex, so its least value over
// that rectangle is 0 if the mean lies inside and otherwise lies on an edge:
// on the edge dx = d it is at dy = -B d / C clamped to the edge, likewise for
// the others. Computing that point with a few roundings moves Q by C e^2 for a
// point error e of a few ulps: second order, well inside the margin.
//
// The margin, with u = 2^-24 and Tmax = A ex^2 + C ey^2 + 2|B| ex ey the
// largest sum of the terms' magnitudes over the box (ex, ey: largest |dx|,
// |dy|). (1) A lane's Q from its own dx, dy has at most ~5 roundings relative
// to the terms' magnitudes: |Q_lane - Q| <= 5u Tmax (FMA contraction only
// removes roundings); this does not depend on how close B^2 is to AC, which a
// relative margin on Q would. (2) expf is within 2 ulp (4u relative), the
// product opa expf within u, and the float 1/255 within u of the real one,
// so a lane that takes the entry has Q_lane <= tau + 14u. (3) This test's Q at
// a point of the box is within 5u Tmax of the exact one; tau = 2 logf(255 opa)
// is within 2u + 4u |tau| (the product's rounding, logf within 1 ulp); Tmax
// is computed within 5u; the two additions of the margin round by u each.
// Culling where qmin > (tau + 8u |tau|) + 64u (Tmax + 1) thus leaves the exact
// least Q above tau + 14u + 5u Tmax, above every lane's acceptance bound with
// ~50u Tmax to spare. For opa alone: expf(power) <= 1 + 4u for power <= 0, so
// opa < (1/255)(1 - 64u) gives alpha < 1/255.

//
// The bf16 tier (kFast) rounds opa, expf(power) and their product to bf16
// (8 significant bits), each within 2^-8 relative, so a lane that takes the
// entry has opa e^power >= (1/255) (1 - u) / ((1 + 4u) (1 + 2^-8)^3):
// Q_lane <= tau + 6 2^-8 + 14u, about tau + 0.0234. K1f adds 2^-5 = 8 2^-8
// to tau', 1.33 times the 6 2^-8 that needs, and culls by opa alone below
// (1/255)(1 - 2^-6): bf(expf(power)) <= 1 for power <= 0, so there alpha <=
// opa (1 + 2^-8)^2 < (1/255)(1 - 2^-7) < (1/255)(1 - u).

// Per entry: (1/A, 1/C, tau', C), where tau' is tau + 8u |tau| (+ 2^-5 in
// the bf16 tier), or -inf where opa alone culls, or +inf where the row is
// never culled.
template <bool kFast>
__device__ __forceinline__ float4 cull_prelude(const float4 a, const float4 b) {
  const float mx = a.x, my = a.y, A = a.z, B = a.w, C = b.x, opa = b.y;
  const bool cullable = isfinite(mx) && isfinite(my) && isfinite(A) && isfinite(B) &&
                        isfinite(C) && isfinite(opa) && A > kConicMin && C > kConicMin &&
                        A * C * (1.0f - 16.0f * kU) > B * B;
  if (!cullable) return make_float4(0.0f, 0.0f, CUDART_INF_F, C);
  float tau = -CUDART_INF_F;
  if (!(opa < (kFast ? kOpaCullFast : kOpaCull))) {
    tau = 2.0f * logf(255.0f * opa);
    tau += 8.0f * kU * fabsf(tau);
    if (kFast) tau += kTauFast;
  }
  return make_float4(1.0f / A, 1.0f / C, tau, C);
}

// Per box: `a` is the row's mx, my, A, B; `pre` its `cull_prelude`.
__device__ __forceinline__ bool culled(const float4 a, const float4 pre, float x0, float x1,
                                       float y0, float y1) {
  const float mx = a.x, my = a.y, A = a.z, B = a.w;
  const float ia = pre.x, ic = pre.y, tau = pre.z, C = pre.w;
  const float dx0 = mx - x1, dx1 = mx - x0;  // every lane's dx lies in [dx0, dx1]
  const float dy0 = my - y1, dy1 = my - y0;
  const float ex = fmaxf(fabsf(dx0), fabsf(dx1));
  const float ey = fmaxf(fabsf(dy0), fabsf(dy1));
  const float tmax = A * ex * ex + C * ey * ey + 2.0f * fabsf(B) * ex * ey;
  if (!(tmax < kTermMax)) return false;
  float qmin = 0.0f;
  if (!(dx0 <= 0.0f && dx1 >= 0.0f && dy0 <= 0.0f && dy1 >= 0.0f)) {
    const float e0 = fminf(fmaxf(-B * dx0 * ic, dy0), dy1);
    const float e1 = fminf(fmaxf(-B * dx1 * ic, dy0), dy1);
    const float f0 = fminf(fmaxf(-B * dy0 * ia, dx0), dx1);
    const float f1 = fminf(fmaxf(-B * dy1 * ia, dx0), dx1);
    qmin = fminf(fminf(quad(A, B, C, dx0, e0), quad(A, B, C, dx1, e1)),
                 fminf(quad(A, B, C, f0, dy0), quad(A, B, C, f1, dy1)));
  }
  return qmin > tau + 64.0f * kU * (tmax + 1.0f);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// power = -1/2 (A dx^2 + C dy^2) - B dx dy at sample (px, py), for a row
// whose first two float4 are `a` (mx, my, A, B) and `b` (C, ...).
__device__ __forceinline__ float power_at(const float4 a, const float4 b, float px, float py) {
  const float dx = a.x - px;
  const float dy = a.y - py;
  return -0.5f * (a.z * dx * dx + b.x * dy * dy) - a.w * dx * dy;
}

// alpha before the skips: K1's f32 expression, or the bf16 tier's.
template <bool kFast>
__device__ __forceinline__ float alpha_of(float opa, float power) {
  if (kFast) return fminf(kAlphaMaxBf16, bf(bf(opa) * bf(expf(power))));
  return fminf(kAlphaMax, opa * expf(power));
}

// One entry applied to a pixel, the parent kernel's per-entry step (the same
// expressions in the same order). `c` points at the row's third float4, read
// only if the entry is taken. Returns false if the pixel stops at this entry,
// which is then not added. In the bf16 tier `T` holds log T (module note).
template <bool kFast>
__device__ __forceinline__ bool apply(float power, float alpha, const float4 b, const float4* c,
                                      float& T, float& acc_r, float& acc_g, float& acc_b,
                                      float& acc_d) {
  if (power > 0.0f || alpha < kAlphaMin) return true;
  if (kFast) {
    const float t = bf(expf(bf(T)));
    if (bf(t * bf(1.0f - alpha)) < kTEps) return false;
    const float4 g = *c;  // g, b, pad, pad
    const float w = bf(alpha * t);
    acc_d += b.z * w;
    acc_r += b.w * w;
    acc_g += g.x * w;
    acc_b += g.y * w;
    T += bf(log1pf(-alpha));
    return true;
  }
  const float test_t = T * (1.0f - alpha);
  if (test_t < kTEps) return false;
  const float4 g = *c;  // g, b, pad, pad
  const float w = alpha * T;
  acc_d += b.z * w;
  acc_r += b.w * w;
  acc_g += g.x * w;
  acc_b += g.y * w;
  T = test_t;
  return true;
}

template <bool kCull, bool kFast>
__global__ void __launch_bounds__(kBlock)
blend_fwd_kernel(const float4* __restrict__ rows,  // [K, 3] float4 = [K, 12] f32
                 const int* __restrict__ starts, const int* __restrict__ ends,
                 const float2* __restrict__ offsets,  // [H, W] or null
                 const float* __restrict__ bg,        // [3]
                 float* __restrict__ color, float* __restrict__ depth,
                 float* __restrict__ final_t, int width, int height, int grid_x) {
  __shared__ float4 batches[2][kBatch * kVecs];
  __shared__ float4 prelude[kBatch];  // the batch's `cull_prelude`s

  const int tile = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Warp w holds the 8 x 4 pixels at (8 (w % 2), 4 (w / 2)) of the tile.
  const int x = (tile % grid_x) * kTile + kWarpW * (warp % 2) + lane % kWarpW;
  const int y = (tile / grid_x) * kTile + kWarpH * (warp / 2) + lane / kWarpW;
  const bool inside = x < width && y < height;
  float px = static_cast<float>(x);
  float py = static_cast<float>(y);
  if (inside && offsets != nullptr) {
    const float2 o = offsets[static_cast<size_t>(y) * width + x];
    px += o.x;
    py += o.y;
  }

  // The warp's sample box (a warp with no inside lane is done from the start).
  const float x0 = warp_min(inside ? px : CUDART_INF_F);
  const float x1 = warp_max(inside ? px : -CUDART_INF_F);
  const float y0 = warp_min(inside ? py : CUDART_INF_F);
  const float y1 = warp_max(inside ? py : -CUDART_INF_F);

  const int start = starts[tile];
  const int end = ends[tile];
  float T = kFast ? 0.0f : 1.0f;  // log T in the bf16 tier
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  bool done = !inside;

  // Rows [base, base + kBatch) of the tile's range into buffer `which`; one
  // commit group per call on every thread.
  auto stage = [&](int base, int which) {
    const int n = kVecs * min(kBatch, end - base);
    float4* dst = batches[which];
    for (int t = threadIdx.x; t < n; t += kBlock) {
      cp_async16(dst + t, rows + kVecs * static_cast<size_t>(base) + t);
    }
    cp_async_commit();
  };

  if (start < end) stage(start, 0);
  int which = 0;
  for (int base = start; base < end; base += kBatch, which ^= 1) {
    cp_async_wait_all();  // this thread's copies of the batch have landed
    // Makes the batch visible to every thread, keeps the other buffer alive
    // until every warp has walked it, and ends the block once all are done.
    if (__syncthreads_count(done) == kBlock) break;
    const int count = min(kBatch, end - base);
    if (base + kBatch < end) stage(base + kBatch, which ^ 1);
    const float4* batch = batches[which];
    if (kCull) {
      const int t = threadIdx.x;
      if (t < count) {
        prelude[t] = cull_prelude<kFast>(batch[kVecs * t + 0], batch[kVecs * t + 1]);
      }
      __syncthreads();
    }
    if (__all_sync(kFull, done)) continue;

    unsigned keep[kWords];  // bit l of keep[k]: the warp walks entry 32 k + l
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int j = 32 * k + lane;
      bool take = j < count;
      if (kCull && take) {
        take = !culled(batch[kVecs * j + 0], prelude[j], x0, x1, y0, y1);
      }
      keep[k] = __ballot_sync(kFull, take);
    }

#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      unsigned bits = keep[k];
      // Two kept entries per step: both powers and alphas first (an entry's
      // alpha does not depend on T), then each entry applied in order, so
      // that the two chains of latency overlap. Per pixel these are the
      // same expressions, in the same order, as one entry at a time.
      while (bits != 0u && !done) {
        const int j = 32 * k + __ffs(bits) - 1;
        bits &= bits - 1u;
        const bool two = bits != 0u;
        const int j2 = two ? 32 * k + __ffs(bits) - 1 : j;
        if (two) bits &= bits - 1u;
        const float4 a = batch[kVecs * j + 0];  // mx, my, A, B
        const float4 b = batch[kVecs * j + 1];  // C, opa, depth, r
        const float4 a2 = batch[kVecs * j2 + 0];
        const float4 b2 = batch[kVecs * j2 + 1];
        const float power = power_at(a, b, px, py);
        const float power2 = power_at(a2, b2, px, py);
        const float alpha = alpha_of<kFast>(b.y, power);
        const float alpha2 = alpha_of<kFast>(b2.y, power2);
        if (!apply<kFast>(power, alpha, b, batch + kVecs * j + 2, T, acc_r, acc_g, acc_b,
                          acc_d) ||
            (two && !apply<kFast>(power2, alpha2, b2, batch + kVecs * j2 + 2, T, acc_r, acc_g,
                                  acc_b, acc_d))) {
          done = true;
          break;
        }
      }
    }
  }

  if (kFast) T = expf(T);
  if (inside) {
    const size_t p = static_cast<size_t>(y) * width + x;
    color[3 * p + 0] = acc_r + T * bg[0];
    color[3 * p + 1] = acc_g + T * bg[1];
    color[3 * p + 2] = acc_b + T * bg[2];
    depth[p] = acc_d;
    final_t[p] = T;
  }
}

template <bool kCull, bool kFast>
int launch(const void* rows, const void* starts, const void* ends, const void* offsets,
           const void* bg, void* color, void* depth, void* final_t, int width, int height,
           int grid_x, int num_tiles, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    blend_fwd_kernel<kCull, kFast><<<num_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(rows), static_cast<const int*>(starts),
        static_cast<const int*>(ends), static_cast<const float2*>(offsets),
        static_cast<const float*>(bg), static_cast<float*>(color),
        static_cast<float*>(depth), static_cast<float*>(final_t), width, height, grid_x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = success). Synchronises nothing and allocates nothing.
int w3d_blend_fwd(const void* rows, const void* starts, const void* ends,
                  const void* offsets, const void* bg, void* color, void* depth,
                  void* final_t, int width, int height, int grid_x, int num_tiles,
                  int device, void* stream) {
  return launch<true, false>(rows, starts, ends, offsets, bg, color, depth, final_t, width,
                             height, grid_x, num_tiles, device, stream);
}

// The same kernel with the cull off: every warp walks every entry. Only the
// chip check calls it, to show that the cull changes no bit of the output.
int w3d_blend_fwd_walk_all(const void* rows, const void* starts, const void* ends,
                           const void* offsets, const void* bg, void* color, void* depth,
                           void* final_t, int width, int height, int grid_x, int num_tiles,
                           int device, void* stream) {
  return launch<false, false>(rows, starts, ends, offsets, bg, color, depth, final_t, width,
                              height, grid_x, num_tiles, device, stream);
}

// K1f, the bf16 tier, with the same arguments.
int w3d_blend_fwd_fast(const void* rows, const void* starts, const void* ends,
                       const void* offsets, const void* bg, void* color, void* depth,
                       void* final_t, int width, int height, int grid_x, int num_tiles,
                       int device, void* stream) {
  return launch<true, true>(rows, starts, ends, offsets, bg, color, depth, final_t, width,
                            height, grid_x, num_tiles, device, stream);
}

// K1f with its cull off; only the chip check calls it, as for K1.
int w3d_blend_fwd_fast_walk_all(const void* rows, const void* starts, const void* ends,
                                const void* offsets, const void* bg, void* color,
                                void* depth, void* final_t, int width, int height,
                                int grid_x, int num_tiles, int device, void* stream) {
  return launch<false, true>(rows, starts, ends, offsets, bg, color, depth, final_t, width,
                             height, grid_x, num_tiles, device, stream);
}

const char* w3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
