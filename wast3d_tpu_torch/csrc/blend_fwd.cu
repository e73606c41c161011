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
// only ~45% take the entry, and the tests add ~0.02 ms. Left for later:
// balancing long tiles across blocks (the stop rule makes compositing split
// segments inexact).
//
// Built without --use_fast_math, so expf and logf are the accurate ones and
// the kernel can be held tightly to its plain PyTorch version
// (`wast3d_tpu_torch/ops/rasterizer/blend.py::blend_fwd_reference`; the cull's
// plain version is `warp_keep_reference` there).
//
// K1f, the bf16 tier (`fast_chain`, JAX's serving default), is its own kernel
// below, `blend_fwd_fast_kernel`: it replaces the `fast=True` body of the same
// TPU kernel (`_chunk_quantities_fast`, `pallas_blend.py:276-339`) and reads
// JAX's bf16 rows, 32 bytes, recentred on the tile (`blend_fast.cuh`). It
// keeps K1's walk: one thread per pixel, the 8 x 4 warps, the per-warp cull
// and two kept entries per step. Per (pixel, entry)
// it computes the function of `blend.py`'s module docstring: power in f32 in
// the plain version's order of roundings, then bf(power); alpha = min(bf(0.99),
// bf(opa E[bf(power)])); the stop on bf(T bf(1 - alpha)) with T = E[bf(logT)];
// w = bf(alpha T); logT += L[alpha]. E and L are tables (in shared memory), so
// no transcendental is evaluated per pair, and the bf16 products are bf16x2
// instructions: both entries' opa E, min and 1 - alpha in one instruction
// each, and (T (1 - alpha), alpha T) in one. Colour and depth add w c in f32
// one entry at a time (each product is exact) and the background is composited
// with separate roundings, as in the plain version
// (`blend_fwd_fast_reference`), whose output K1f can equal bit for bit.
//
// K1f's batches hold 256 entries (8 KB of bf16 rows, where 128 of K1's take
// 6 KB), so that each thread prepares one entry a batch in shared memory
// (`FastEntry`): its geometry, power coefficients and colour in f32, converted
// once per block rather than once per warp that walks the entry, and its cull
// prelude. The table's addresses stay in registers (`Tables`). Its bytes
// are 32 B x K of rows, the 5,376-byte table and 20 B x H x W of output:
// 34 MB at the 200k / 800x800 scene, 0.010 ms at 3.35 TB/s.
//
// The quad route (JAX's `quad_power`, `_chunk_quantities(..., pix8=)` and
// `_chunk_quantities_fast_quad`, `pallas_blend.py:172-226`, `:341-388`; the
// function is in `blend.py`'s module docstring) is a template instance of each
// kernel: K1q (`blend_fwd_kernel<.., true>`) and K1fq (`blend_fwd_fast_kernel
// <.., true>`), for jitter-off renders. The TPU kernel turns power into two or
// three (P, 8) x (8, G) products on its matrix unit; here each thread holds its
// pixel's monomials (px^2, py^2, px py, px, py) at tile-local integer
// coordinates, exact in f32, and the thread that stages an entry in shared
// memory computes its coefficients (from the mean recentred on the tile in
// f32, as JAX packs it) and splits them into bf16 parts once per block (18
// values in K1q, 12 in K1fq, kept as f32). Per pair, each part's sum is a fixed
// chain, a product and four FMAs and an add (every product of a bf16 part and
// a monomial below 256 is exact, so the chain rounds where the plain version's
// separate operations round), then JAX's clamp. K1q rounds every operation of
// its walk explicitly (`__fmul_rn` / `__fadd_rn`), so that it equals its plain
// version bit for bit; K1fq walks as K1f does. The cull's margin is widened by
// the route's own error (`cull_prelude`). Left for later: the tensor-core form
// (`mma.sync` m16n8k16 bf16, the parts sharing the K dimension).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "blend_fast.cuh"

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

// K1f: entries per batch, and its cull's margin (see `culled`).
constexpr int kFastBatch = 256;
constexpr int kFastWords = kFastBatch / 32;
constexpr float kTauFast = 0.03125f;     // 2^-5
constexpr float kTauFastRel = 0.0078125f;  // 2^-7

// The quad route: JAX's skip allowances, the cull's margin per unit of
// `quad_term_bound` (see `cull_prelude`), and the largest tile-local pixel
// coordinate.
constexpr float kQuadEps = 1e-3f;
constexpr float kQuadEpsFast = 0.05f;
constexpr float kQuadMargin = 64.0f * kU;
constexpr float kQuadMarginFast = 6.103515625e-05f;  // 2^-14
constexpr float kSpan = static_cast<float>(kTile - 1);

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
// K1f (kFast) rounds power, exp and the product with opacity to bf16 (8
// significant bits, each within 2^-8 relative) and reads E from a table of
// bf(exp) computed in f32 (within 4u before its rounding); opa is the row's
// bf16 value, read as it is. A lane that takes the entry has bf(opa E) >=
// (1/255)(1 - u), so opa e^(pb) (1 + 2^-8)^2 (1 + 4u) >= (1/255)(1 - u) for
// pb = bf(power): -2 pb <= tau + 4 2^-8 + 10u. Rounding power moves it by at
// most 2^-8 of itself, so Q_lane (1 - 2^-8) <= -2 pb and Q_lane <= (tau +
// 4 2^-8 + 10u) / (1 - 2^-8) <= tau + 0.0158 + 0.004 max(tau, 0) (tau <=
// 2 ln 255 = 11.1; tau >= -3u where opa >= 1/255). K1f adds 2^-5 + 2^-7 |tau|
// to tau', twice that, and culls by opa alone below 1/255 itself: E <= 1, so
// bf(opa E) <= opa, and an opa below the float 1/255 gives an alpha below it,
// which the skip test drops.

//
// The quad route (K1q, K1fq) computes power otherwise, so its lanes' error is
// another one. Take the tile-local mean (mx, my) as the row's (K1q recentres
// the f32 mean on the tile once, and both its walk and its cull use that
// value; K1fq's rows are local already), so the exact power at a lane is
// P = sum_k c*_k m_k over the monomials m (px, py integers in [0, 15]) with
// the exact coefficients c*. Let S = 225 (|A|/2 + |C|/2 + |B|) + 15 (|A mx| +
// |B my| + |C my| + |B mx|) + (|A| mx^2 / 2 + |C| my^2 / 2 + |B mx my|), which
// bounds sum_k |c*_k| m_k and the magnitudes every coefficient is computed
// from (`quad_term_bound`). The lane's power differs from P by: the
// coefficients' roundings, c3 and c4 one product and one difference (2u of
// their terms), c5 three products of two roundings and two sums (4u); the
// split's remainder, 2^-24 |c| in K1q's triple split and 2^-16 |c| in K1fq's
// double split (each bf16 rounding leaves 2^-8 of what it rounds); each part's
// chain of five sums (5u of its terms, the parts' terms summing to (1 + 2^-7)
// |c| m); the two (one) sums of the parts (2u). So |power - P| <= 12.2u S in
// K1q and (2^-16 + 9u) S < 1.05 2^-16 S in K1fq, and Q = -2 power moves by
// twice that. JAX's clamp then gives power' = min(power, 0) wherever the lane
// does not skip (power <= eps; above eps, power' = power - eps > 0 is
// skipped), so the allowance eps takes no entry beyond this: a lane that
// takes the entry has -2 power' <= tau + 14u (tau + 0.0158 + 0.004 max(tau,
// 0) in K1f's terms) as above, and -2 P <= -2 power + 2 |power - P| <= -2
// power' + 2 |power - P|. The lane's exact point (mx - px, my - py) may lie
// outside the box's rounded edges by a rounding, which moves the box's least
// Q by at most 4u Tmax, inside the 64u (Tmax + 1) above. The quad cull adds
// 64u S (K1q: over twice 24.4u S) or 2^-14 S (K1fq: twice 2.1 2^-16 S) to
// tau'; an S that is not finite makes tau' +inf (never culled).

// The quad route's S (above) for a row with tile-local mean (mx, my).
__device__ __forceinline__ float quad_term_bound(float mx, float my, float A, float B,
                                                 float C) {
  const float a = 0.5f * fabsf(A), c = 0.5f * fabsf(C), b = fabsf(B);
  return kSpan * kSpan * (a + c + b) +
         kSpan * (fabsf(A * mx) + fabsf(B * my) + fabsf(C * my) + fabsf(B * mx)) +
         (a * mx * mx + c * my * my + b * fabsf(mx * my));
}

// Per entry: (1/A, 1/C, tau', C), where tau' is tau + 8u |tau| (+ 2^-5 +
// 2^-7 |tau| in K1f; + the quad margin on the quad route), or -inf where opa
// alone culls, or +inf where the row is never culled. `a` is the row's (mx,
// my, A, B), tile-local on the quad route.
template <bool kFast, bool kQuad = false>
__device__ __forceinline__ float4 cull_prelude(const float4 a, float C, float opa) {
  const float mx = a.x, my = a.y, A = a.z, B = a.w;
  const bool cullable = isfinite(mx) && isfinite(my) && isfinite(A) && isfinite(B) &&
                        isfinite(C) && isfinite(opa) && A > kConicMin && C > kConicMin &&
                        A * C * (1.0f - 16.0f * kU) > B * B;
  if (!cullable) return make_float4(0.0f, 0.0f, CUDART_INF_F, C);
  float tau = -CUDART_INF_F;
  if (!(opa < (kFast ? kAlphaMin : kOpaCull))) {
    tau = 2.0f * logf(255.0f * opa);
    tau += 8.0f * kU * fabsf(tau);
    if (kFast) tau += kTauFast + kTauFastRel * fabsf(tau);
    if (kQuad) {
      const float margin = (kFast ? kQuadMarginFast : kQuadMargin) *
                           quad_term_bound(mx, my, A, B, C);
      tau = isfinite(margin) ? tau + margin : CUDART_INF_F;
    }
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

// One entry applied to a pixel, the parent kernel's per-entry step (the same
// expressions in the same order). `c` points at the row's third float4, read
// only if the entry is taken. Returns false if the pixel stops at this entry,
// which is then not added.
__device__ __forceinline__ bool apply(float power, float alpha, const float4 b, const float4* c,
                                      float& T, float& acc_r, float& acc_g, float& acc_b,
                                      float& acc_d) {
  if (power > 0.0f || alpha < kAlphaMin) return true;
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

// ---- the quad route (the file's head note) ----------------------------------

// x rounded to bf16 (to nearest, ties to even), as f32.
__device__ __forceinline__ float bf_rn(float x) {
  return __uint_as_float(static_cast<uint32_t>(w3d_fast::bits_rn(x)) << 16);
}

// A pixel's monomials at tile-local integer coordinates (exact in f32).
struct Mono {
  float xx, yy, xy, x, y;
};

__device__ __forceinline__ Mono monomials(float px, float py) {
  return {px * px, py * py, px * py, px, py};
}

// The coefficients of power in (px^2, py^2, px py, px, py, 1) for a row with
// tile-local mean (mx, my), each operation rounded as the plain version
// rounds it (`blend.py::_quad_coefficients`; JAX's c8), then split into
// kParts bf16 parts: parts[p][k], hi = bf(c), then the rounding of what is
// left (`blend.py::_split`).
template <int kParts>
__device__ __forceinline__ void quad_parts(float mx, float my, float A, float B, float C,
                                           float parts[kParts][6]) {
  const float ah = __fmul_rn(-0.5f, A), ch = __fmul_rn(-0.5f, C), bn = -B;
  const float c[6] = {
      ah, ch, bn,
      __fsub_rn(__fmul_rn(__fmul_rn(-2.0f, ah), mx), __fmul_rn(bn, my)),
      __fsub_rn(__fmul_rn(__fmul_rn(-2.0f, ch), my), __fmul_rn(bn, mx)),
      __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ah, mx), mx), __fmul_rn(__fmul_rn(ch, my), my)),
                __fmul_rn(__fmul_rn(bn, mx), my))};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float rest = c[k];
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      parts[p][k] = bf_rn(rest);
      rest = __fsub_rn(rest, parts[p][k]);
    }
  }
}

// One part's sum in the plain version's order: ((((c0 m0 + c1 m1) + c2 m2) +
// c3 m3) + c4 m4) + c5; every product is exact, so each FMA rounds once,
// where the plain version's sum rounds.
__device__ __forceinline__ float quad_chain(float c0, float c1, float c2, float c3, float c4,
                                            float c5, const Mono& m) {
  float d = __fmul_rn(c0, m.xx);
  d = __fmaf_rn(c1, m.yy, d);
  d = __fmaf_rn(c2, m.xy, d);
  d = __fmaf_rn(c3, m.x, d);
  d = __fmaf_rn(c4, m.y, d);
  return __fadd_rn(d, c5);
}

// JAX's clamp, min(p, 0) + max(p - eps, 0), with NaN kept as torch.minimum /
// torch.maximum keep it.
__device__ __forceinline__ float quad_clamp(float p, float eps) {
  const float below = (p < 0.0f || p != p) ? p : 0.0f;
  const float d = __fsub_rn(p, eps);
  const float above = (d > 0.0f || d != d) ? d : 0.0f;
  return __fadd_rn(below, above);
}

// K1q's batch entry, prepared once per block: the tile-local geometry (the
// cull's) and the 18 split coefficients, hi c0-c5, mid c0-c5, lo c0-c5, then
// opa and a zero.
struct QuadEntry {
  float4 geom;  // tile-local mx, my, A, B
  float4 c[5];
};

__device__ __forceinline__ QuadEntry quad_entry(const float4 a, float C, float opa) {
  float parts[3][6];
  quad_parts<3>(a.x, a.y, a.z, a.w, C, parts);
  QuadEntry e;
  e.geom = a;
  e.c[0] = make_float4(parts[0][0], parts[0][1], parts[0][2], parts[0][3]);
  e.c[1] = make_float4(parts[0][4], parts[0][5], parts[1][0], parts[1][1]);
  e.c[2] = make_float4(parts[1][2], parts[1][3], parts[1][4], parts[1][5]);
  e.c[3] = make_float4(parts[2][0], parts[2][1], parts[2][2], parts[2][3]);
  e.c[4] = make_float4(parts[2][4], parts[2][5], opa, 0.0f);
  return e;
}

// K1q's power at a pixel (clamped, f32 tier), and the entry's opacity.
__device__ __forceinline__ float quad_power(const QuadEntry& e, const Mono& m, float& opa) {
  const float4 v0 = e.c[0], v1 = e.c[1], v2 = e.c[2], v3 = e.c[3], v4 = e.c[4];
  const float hi = quad_chain(v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, m);
  const float mid = quad_chain(v1.z, v1.w, v2.x, v2.y, v2.z, v2.w, m);
  const float lo = quad_chain(v3.x, v3.y, v3.z, v3.w, v4.x, v4.y, m);
  opa = v4.z;
  return quad_clamp(__fadd_rn(__fadd_rn(hi, mid), lo), kQuadEps);
}

// K1q's alpha: min(0.99, opa expf(power)), NaN kept as torch.clamp_max keeps it.
__device__ __forceinline__ float quad_alpha(float opa, float power) {
  const float a = __fmul_rn(opa, expf(power));
  return a > kAlphaMax ? kAlphaMax : a;
}

// `apply` with every operation rounded on its own, as the plain version
// rounds it (no FMA contraction); `depth`, `red` are the row's, `c` points at
// its (g, b, pad, pad).
__device__ __forceinline__ bool apply_rn(float power, float alpha, float depth, float red,
                                         const float4* c, float& T, float& acc_r,
                                         float& acc_g, float& acc_b, float& acc_d) {
  if (power > 0.0f || alpha < kAlphaMin) return true;
  const float test_t = __fmul_rn(T, __fsub_rn(1.0f, alpha));
  if (test_t < kTEps) return false;
  const float4 g = *c;
  const float w = __fmul_rn(alpha, T);
  acc_d = __fadd_rn(acc_d, __fmul_rn(depth, w));
  acc_r = __fadd_rn(acc_r, __fmul_rn(red, w));
  acc_g = __fadd_rn(acc_g, __fmul_rn(g.x, w));
  acc_b = __fadd_rn(acc_b, __fmul_rn(g.y, w));
  T = test_t;
  return true;
}

// K1fq's batch entry: K1f's with the 12 split coefficients (hi c0-c5, lo
// c0-c5) in place of the direct form's.
struct FastQuadEntry {
  float4 geom;   // mx, my, A, B: the cull's
  float4 c[3];   // hi c0-c5, lo c0-c5
  float4 color;  // depth, r, g, b
  float4 pre;    // `cull_prelude`
};

// K1fq's power at a pixel (clamped with the bf16 tier's allowance, in f32).
__device__ __forceinline__ float fast_quad_power(const FastQuadEntry& e, const Mono& m) {
  const float4 v0 = e.c[0], v1 = e.c[1], v2 = e.c[2];
  const float hi = quad_chain(v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, m);
  const float lo = quad_chain(v1.z, v1.w, v2.x, v2.y, v2.z, v2.w, m);
  return quad_clamp(__fadd_rn(hi, lo), kQuadEpsFast);
}

// K1 (kQuad false) and K1q (kQuad true: the quad route, tile-local samples,
// no offsets).
template <bool kCull, bool kQuad>
__global__ void __launch_bounds__(kBlock)
blend_fwd_kernel(const float4* __restrict__ rows,  // [K, 3] float4 = [K, 12] f32
                 const int* __restrict__ starts, const int* __restrict__ ends,
                 const float2* __restrict__ offsets,  // [H, W] or null
                 const float* __restrict__ bg,        // [3]
                 float* __restrict__ color, float* __restrict__ depth,
                 float* __restrict__ final_t, int width, int height, int grid_x,
                 int row0) {
  __shared__ float4 batches[2][kBatch * kVecs];
  __shared__ float4 prelude[kBatch];  // the batch's `cull_prelude`s
  __shared__ QuadEntry quads[kQuad ? kBatch : 1];  // K1q: the batch's coefficients

  const int tile = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Warp w holds the 8 x 4 pixels at (8 (w % 2), 4 (w / 2)) of the tile.
  const int lx = kWarpW * (warp % 2) + lane % kWarpW;
  const int ly = kWarpH * (warp / 2) + lane / kWarpW;
  const int x = (tile % grid_x) * kTile + lx;
  const int y = (tile / grid_x) * kTile + ly;
  const bool inside = x < width && y < height;
  // K1q samples at tile-local positions and recentres the means on the
  // tile's pixel origin (ox, oy) in the image, whose first row the frame's
  // row 0 is (`row0`: 0, or a tile-sharded strip's first row).
  float px = static_cast<float>(kQuad ? lx : x);
  float py = static_cast<float>(kQuad ? ly : y);
  const float ox = static_cast<float>((tile % grid_x) * kTile);
  const float oy = static_cast<float>(row0 + (tile / grid_x) * kTile);
  const Mono mono = monomials(px, py);
  if (!kQuad && inside && offsets != nullptr) {
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
  float T = 1.0f;
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
    if (kCull || kQuad) {
      const int t = threadIdx.x;
      if (t < count) {
        float4 a = batch[kVecs * t + 0];
        const float4 b = batch[kVecs * t + 1];
        if (kQuad) {
          a.x = __fsub_rn(a.x, ox);
          a.y = __fsub_rn(a.y, oy);
          quads[t] = quad_entry(a, b.x, b.y);
        }
        if (kCull) prelude[t] = cull_prelude<false, kQuad>(a, b.x, b.y);
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
        take = !culled(kQuad ? quads[j].geom : batch[kVecs * j + 0], prelude[j], x0, x1, y0,
                       y1);
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
        const float4 b = batch[kVecs * j + 1];  // C, opa, depth, r
        const float4 b2 = batch[kVecs * j2 + 1];
        bool stop;
        if (kQuad) {
          float opa, opa2;
          const float power = quad_power(quads[j], mono, opa);
          const float power2 = quad_power(quads[j2], mono, opa2);
          const float alpha = quad_alpha(opa, power);
          const float alpha2 = quad_alpha(opa2, power2);
          stop = !apply_rn(power, alpha, b.z, b.w, batch + kVecs * j + 2, T, acc_r, acc_g, acc_b,
                           acc_d) ||
                 (two && !apply_rn(power2, alpha2, b2.z, b2.w, batch + kVecs * j2 + 2, T, acc_r,
                                   acc_g, acc_b, acc_d));
        } else {
          const float4 a = batch[kVecs * j + 0];  // mx, my, A, B
          const float4 a2 = batch[kVecs * j2 + 0];
          const float power = power_at(a, b, px, py);
          const float power2 = power_at(a2, b2, px, py);
          const float alpha = fminf(kAlphaMax, b.y * expf(power));
          const float alpha2 = fminf(kAlphaMax, b2.y * expf(power2));
          stop = !apply(power, alpha, b, batch + kVecs * j + 2, T, acc_r, acc_g, acc_b, acc_d) ||
                 (two && !apply(power2, alpha2, b2, batch + kVecs * j2 + 2, T, acc_r, acc_g,
                                acc_b, acc_d));
        }
        if (stop) {
          done = true;
          break;
        }
      }
    }
  }

  if (inside) {
    const size_t p = static_cast<size_t>(y) * width + x;
    if (kQuad) {
      color[3 * p + 0] = __fadd_rn(acc_r, __fmul_rn(T, bg[0]));
      color[3 * p + 1] = __fadd_rn(acc_g, __fmul_rn(T, bg[1]));
      color[3 * p + 2] = __fadd_rn(acc_b, __fmul_rn(T, bg[2]));
    } else {
      color[3 * p + 0] = acc_r + T * bg[0];
      color[3 * p + 1] = acc_g + T * bg[1];
      color[3 * p + 2] = acc_b + T * bg[2];
    }
    depth[p] = acc_d;
    final_t[p] = T;
  }
}

// A batch entry as K1f's walk reads it, prepared once per block (16-byte
// fields, one base address).
struct FastEntry {
  float4 geom;   // mx, my, A, B: the cull's
  float4 power;  // Ah, Bn, Ch (`power_rn`), and the row's (C, opa) word
  float4 color;  // depth, r, g, b
  float4 pre;    // `cull_prelude`
};

// K1f (the file's head note). Per batch, thread t prepares entry t: its f32
// geometry, power coefficients and colour, and its cull prelude; then each
// warp takes its keep words and walks its kept entries two at a time, as K1
// does. K1fq (kQuad): the quad route's coefficients in place of the direct
// form's, with the entry's (C, opa) word beside them.
template <bool kCull, bool kQuad>
__global__ void __launch_bounds__(kBlock)
blend_fwd_fast_kernel(const uint4* __restrict__ rows,  // [K, 2] uint4 = [K, 16] bf16
                      const int* __restrict__ starts, const int* __restrict__ ends,
                      const float2* __restrict__ offsets,  // [H, W] or null
                      const float* __restrict__ bg,        // [3]
                      const uint4* __restrict__ tables,    // E and L, bf16
                      float* __restrict__ color, float* __restrict__ depth,
                      float* __restrict__ final_t, int width, int height, int grid_x) {
  using namespace w3d_fast;
  using Entry = typename std::conditional<kQuad, FastQuadEntry, FastEntry>::type;
  __shared__ uint4 batches[2][kFastBatch * 2];
  __shared__ Entry entries[kFastBatch];
  __shared__ uint32_t opa_words[kQuad ? kFastBatch : 1];  // K1fq: each entry's (C, opa)
  __shared__ uint4 table[kTableVecs];
  const Tables tab(static_cast<uint32_t>(__cvta_generic_to_shared(table)));

  const int tile = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Warp w holds the 8 x 4 pixels at (8 (w % 2), 4 (w / 2)) of the tile,
  // sampled at tile-local positions.
  const int lx = kWarpW * (warp % 2) + lane % kWarpW;
  const int ly = kWarpH * (warp / 2) + lane / kWarpW;
  const int x = (tile % grid_x) * kTile + lx;
  const int y = (tile / grid_x) * kTile + ly;
  const bool inside = x < width && y < height;
  float px = static_cast<float>(lx);
  float py = static_cast<float>(ly);
  const Mono mono = monomials(px, py);
  if (!kQuad && inside && offsets != nullptr) {
    const float2 o = offsets[static_cast<size_t>(y) * width + x];
    px = __fadd_rn(px, o.x);
    py = __fadd_rn(py, o.y);
  }

  const float x0 = warp_min(inside ? px : CUDART_INF_F);
  const float x1 = warp_max(inside ? px : -CUDART_INF_F);
  const float y0 = warp_min(inside ? py : CUDART_INF_F);
  const float y1 = warp_max(inside ? py : -CUDART_INF_F);

  const int start = starts[tile];
  const int end = ends[tile];
  float log_t = 0.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  bool done = !inside;

  // Rows [base, base + kFastBatch) into buffer `which`; one commit group per
  // call on every thread.
  auto stage = [&](int base, int which) {
    const int n = 2 * min(kFastBatch, end - base);
    uint4* dst = batches[which];
    for (int t = threadIdx.x; t < n; t += kBlock) {
      cp_async16(dst + t, rows + 2 * static_cast<size_t>(base) + t);
    }
    cp_async_commit();
  };

  if (start < end) {
    for (int t = threadIdx.x; t < kTableVecs; t += kBlock) cp_async16(table + t, tables + t);
    stage(start, 0);  // one commit group with the table's copies
  }

  // One entry applied to the pixel; `pair` holds the entry's bf16 1 - alpha
  // (low half) and alpha (high half). Returns false if the pixel stops at
  // this entry, which is then not added. alpha < 1/255 is read from alpha's
  // bits (`kAlphaMinBits`).
  auto take = [&](float power, uint32_t pair, const float4 c) {
    if (power > 0.0f || static_cast<int>(pair) < kAlphaMinBits) return true;
    // (T (1 - alpha), alpha T) in one bf16x2 product, T = E[bf(log T)]
    const uint32_t tw = mul2_dup(tab.exp_log_t(bits_rn(log_t)), pair);
    if (lo_f(tw) < kTEps) return false;
    const float wt = hi_f(tw);
    // c: depth, r, g, b; each product is exact: one rounding, as the plain sum
    acc_d = fmaf(c.x, wt, acc_d);
    acc_r = fmaf(c.y, wt, acc_r);
    acc_g = fmaf(c.z, wt, acc_g);
    acc_b = fmaf(c.w, wt, acc_b);
    log_t = __fadd_rn(log_t, lo_f(tab.log1m_pair(pair)));
    return true;
  };

  int which = 0;
  for (int base = start; base < end; base += kFastBatch, which ^= 1) {
    cp_async_wait_all();
    if (__syncthreads_count(done) == kBlock) break;
    const int count = min(kFastBatch, end - base);
    if (base + kFastBatch < end) stage(base + kFastBatch, which ^ 1);
    {
      const int t = threadIdx.x;
      if (t < count) {
        const uint4 v = batches[which][2 * t];      // (mx, my), (A, B), (C, opa), (depth, r)
        const uint4 v2 = batches[which][2 * t + 1];  // (g, b), zeros
        const float4 g = geometry(v);
        Entry& e = entries[t];
        e.geom = g;
        if constexpr (kQuad) {
          float parts[2][6];
          quad_parts<2>(g.x, g.y, g.z, g.w, lo_f(v.z), parts);
          e.c[0] = make_float4(parts[0][0], parts[0][1], parts[0][2], parts[0][3]);
          e.c[1] = make_float4(parts[0][4], parts[0][5], parts[1][0], parts[1][1]);
          e.c[2] = make_float4(parts[1][2], parts[1][3], parts[1][4], parts[1][5]);
          opa_words[t] = v.z;
        } else {
          const float3 k = power_coefficients(v);
          e.power = make_float4(k.x, k.y, k.z, __uint_as_float(v.z));
        }
        e.color = make_float4(lo_f(v.w), hi_f(v.w), lo_f(v2.x), hi_f(v2.x));
        if (kCull) e.pre = cull_prelude<true, kQuad>(g, lo_f(v.z), hi_f(v.z));
      }
      __syncthreads();
    }
    if (__all_sync(kFull, done)) continue;

    unsigned keep[kFastWords];  // bit l of keep[k]: the warp walks entry 32 k + l
#pragma unroll
    for (int k = 0; k < kFastWords; ++k) {
      const int j = 32 * k + lane;
      bool take_it = j < count;
      if (kCull && take_it) take_it = !culled(entries[j].geom, entries[j].pre, x0, x1, y0, y1);
      keep[k] = __ballot_sync(kFull, take_it);
    }

#pragma unroll
    for (int k = 0; k < kFastWords; ++k) {
      unsigned bits = keep[k];
      // Two kept entries per step: both powers and alphas first, in bf16x2
      // pairs (an entry's alpha does not depend on T), then each entry
      // applied in order. Per pixel these are the same values, in the same
      // order, as one entry at a time.
      while (bits != 0u && !done) {
        const int j = 32 * k + __ffs(bits) - 1;
        bits &= bits - 1u;
        const bool two = bits != 0u;
        const int j2 = two ? 32 * k + __ffs(bits) - 1 : j;
        if (two) bits &= bits - 1u;
        const Entry& e1 = entries[j];
        const Entry& e2 = entries[j2];
        const float4 c1 = e1.color, c2 = e2.color;  // loaded here: cheaper than in `take`
        float power, power2;
        uint32_t opa;
        if constexpr (kQuad) {
          power = fast_quad_power(e1, mono);
          power2 = fast_quad_power(e2, mono);
          opa = __byte_perm(opa_words[j], opa_words[j2], 0x7632);
        } else {
          const float4 p1 = e1.power, p2 = e2.power;
          power = power_rn(p1.x, p1.y, p1.z, __fsub_rn(e1.geom.x, px), __fsub_rn(e1.geom.y, py));
          power2 = power_rn(p2.x, p2.y, p2.z, __fsub_rn(e2.geom.x, px), __fsub_rn(e2.geom.y, py));
          opa = __byte_perm(__float_as_uint(p1.w), __float_as_uint(p2.w), 0x7632);
        }
        const uint32_t ex = tab.exp_pair(pack_rn(power, power2));
        const uint32_t alpha = min2(mul2(opa, ex), kAlphaMax2);
        const uint32_t om = sub2(kOne2, alpha);
        if (!take(power, __byte_perm(om, alpha, 0x5410), c1) ||
            (two && !take(power2, __byte_perm(om, alpha, 0x7632), c2))) {
          done = true;
          break;
        }
      }
    }
  }

  if (inside) {
    const float T = expf(log_t);
    const size_t p = static_cast<size_t>(y) * width + x;
    color[3 * p + 0] = __fadd_rn(acc_r, __fmul_rn(T, bg[0]));
    color[3 * p + 1] = __fadd_rn(acc_g, __fmul_rn(T, bg[1]));
    color[3 * p + 2] = __fadd_rn(acc_b, __fmul_rn(T, bg[2]));
    depth[p] = acc_d;
    final_t[p] = T;
  }
}

template <bool kCull, bool kQuad = false>
int launch(const void* rows, const void* starts, const void* ends, const void* offsets,
           const void* bg, void* color, void* depth, void* final_t, int width, int height,
           int grid_x, int num_tiles, int row0, int device, void* stream) {
  if (kQuad && offsets != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    blend_fwd_kernel<kCull, kQuad><<<num_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(rows), static_cast<const int*>(starts),
        static_cast<const int*>(ends), static_cast<const float2*>(offsets),
        static_cast<const float*>(bg), static_cast<float*>(color),
        static_cast<float*>(depth), static_cast<float*>(final_t), width, height, grid_x,
        row0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kCull, bool kQuad = false>
int launch_fast(const void* rows, const void* starts, const void* ends, const void* offsets,
                const void* bg, const void* tables, void* color, void* depth, void* final_t,
                int width, int height, int grid_x, int num_tiles, int device, void* stream) {
  if (kQuad && offsets != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    blend_fwd_fast_kernel<kCull, kQuad><<<num_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(rows), static_cast<const int*>(starts),
        static_cast<const int*>(ends), static_cast<const float2*>(offsets),
        static_cast<const float*>(bg), static_cast<const uint4*>(tables),
        static_cast<float*>(color), static_cast<float*>(depth), static_cast<float*>(final_t),
        width, height, grid_x);
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
  return launch<true>(rows, starts, ends, offsets, bg, color, depth, final_t, width, height,
                      grid_x, num_tiles, 0, device, stream);
}

// The same kernel with the cull off: every warp walks every entry. Only the
// chip check calls it, to show that the cull changes no bit of the output.
int w3d_blend_fwd_walk_all(const void* rows, const void* starts, const void* ends,
                           const void* offsets, const void* bg, void* color, void* depth,
                           void* final_t, int width, int height, int grid_x, int num_tiles,
                           int device, void* stream) {
  return launch<false>(rows, starts, ends, offsets, bg, color, depth, final_t, width, height,
                       grid_x, num_tiles, 0, device, stream);
}

// K1f, the bf16 tier: K1's arguments on [K, 16] bf16 rows, and after `bg`
// the tables E and L (`blend.fast_tables`, 16-byte aligned).
int w3d_blend_fwd_fast(const void* rows, const void* starts, const void* ends,
                       const void* offsets, const void* bg, const void* tables, void* color,
                       void* depth, void* final_t, int width, int height, int grid_x,
                       int num_tiles, int device, void* stream) {
  return launch_fast<true>(rows, starts, ends, offsets, bg, tables, color, depth, final_t,
                           width, height, grid_x, num_tiles, device, stream);
}

// K1f with its cull off; only the chip check calls it, as for K1.
int w3d_blend_fwd_fast_walk_all(const void* rows, const void* starts, const void* ends,
                                const void* offsets, const void* bg, const void* tables,
                                void* color, void* depth, void* final_t, int width,
                                int height, int grid_x, int num_tiles, int device,
                                void* stream) {
  return launch_fast<false>(rows, starts, ends, offsets, bg, tables, color, depth, final_t,
                            width, height, grid_x, num_tiles, device, stream);
}

// K1q, K1 on the quad route: K1's arguments, `offsets` null (else
// cudaErrorInvalidValue, launching nothing), and after `num_tiles` the image
// row of the frame's first row (`row0`, a multiple of 16: 0, or a
// tile-sharded strip's first row), on whose tiles the means are recentred.
int w3d_blend_fwd_quad(const void* rows, const void* starts, const void* ends,
                       const void* offsets, const void* bg, void* color, void* depth,
                       void* final_t, int width, int height, int grid_x, int num_tiles,
                       int row0, int device, void* stream) {
  return launch<true, true>(rows, starts, ends, offsets, bg, color, depth, final_t, width,
                            height, grid_x, num_tiles, row0, device, stream);
}

// K1q with its cull off; only the chip check calls it, as for K1.
int w3d_blend_fwd_quad_walk_all(const void* rows, const void* starts, const void* ends,
                                const void* offsets, const void* bg, void* color, void* depth,
                                void* final_t, int width, int height, int grid_x,
                                int num_tiles, int row0, int device, void* stream) {
  return launch<false, true>(rows, starts, ends, offsets, bg, color, depth, final_t, width,
                             height, grid_x, num_tiles, row0, device, stream);
}

// K1fq, K1f on the quad route: K1f's arguments, `offsets` null.
int w3d_blend_fwd_fast_quad(const void* rows, const void* starts, const void* ends,
                            const void* offsets, const void* bg, const void* tables,
                            void* color, void* depth, void* final_t, int width, int height,
                            int grid_x, int num_tiles, int device, void* stream) {
  return launch_fast<true, true>(rows, starts, ends, offsets, bg, tables, color, depth, final_t,
                                 width, height, grid_x, num_tiles, device, stream);
}

// K1fq with its cull off; only the chip check calls it.
int w3d_blend_fwd_fast_quad_walk_all(const void* rows, const void* starts, const void* ends,
                                     const void* offsets, const void* bg, const void* tables,
                                     void* color, void* depth, void* final_t, int width,
                                     int height, int grid_x, int num_tiles, int device,
                                     void* stream) {
  return launch_fast<false, true>(rows, starts, ends, offsets, bg, tables, color, depth,
                                  final_t, width, height, grid_x, num_tiles, device, stream);
}

const char* w3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
