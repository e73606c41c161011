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
// it computes the function of `blend.py`'s module docstring: power in JAX's
// bf16 chain, every product and sum rounded to bf16 as XLA rounds it
// (`power_pair`, both entries of a step at once); alpha = min(bf(0.99),
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
// three (P, 8) x (8, G) products on its matrix unit, and so do these, on the
// tensor cores (`mma.sync`, bf16 in, f32 out). Each warp holds its 32 pixels'
// monomials [x^2, y^2, x y, x, y, 1, 0, 0] (tile-local integers, exact in
// bf16) as two m16 A fragments, built once per block as JAX hoists its pix8.
// Per batch, the thread that stages an entry computes its coefficients (from
// the mean recentred on the tile in f32, as JAX packs it), splits them into
// bf16 parts and stores them as the B fragments read them (`stage_quad`: 48 B
// an entry in K1q, hi, mid and lo; 32 B in K1fq, hi and lo). Each warp lists
// the entries it keeps after its cull (`kept_list`) and takes them 32 at a
// time: for each group of 8, two m16 tiles of MMAs, K1fq hi|lo as one
// m16n8k16, K1q hi|mid as one m16n8k16 and lo as one m16n8k8 onto its sum
// (`quad_slab`; one MMA fewer than three m16n8k8, and the parts' sum stays in
// the tensor core, so no f32 add a value; the error model beside
// `cull_prelude` covers the joint sum). The powers go to the warp's slab in
// shared memory (32 entries x 32 pixels; K1q raw f32, K1fq clamped and
// rounded to bf16), laid out so that neither the fragment stores nor the
// walk's reads conflict; the walk reads each pair of entries' powers with one
// shared load where it evaluated the chain and goes on as before, K1q (JAX's
// clamp, then K1's steps) as K1 walks, K1fq as K1f does; it reads the list,
// the slab and the rows at 32-bit shared addresses taken once a chunk
// (`smem_base`), and two list positions a load. The cull stays per
// warp and the walk visits only kept entries. `wgmma` does not fit: it takes
// 64-row warpgroup tiles, while the walk and the cull work one warp at a
// time. The slabs (32 KB a block in K1q, 16 KB in K1fq), lists and
// coefficient words are dynamic shared memory, past the 48 KB default beside
// the static buffers, so the launch sets the attribute. The tensor cores'
// accumulation is not IEEE round-to-nearest per addition, so the kernels are
// not bit-equal to their plain versions (the chip check's limits are in
// `chip_smoke.py`, QUAD_TOL); the cull's margin covers the route's error
// with the tensor cores' (`cull_prelude`). What bounds them on this card:
// bytes, as K1's and K1f's (power's products take ~1 us at the tensor
// cores' rate); they are held instead, as K1 and K1f are, by the walk, and
// beyond it by each batch's staging and barrier, the cull and the list, and
// the MMAs (the section timers, `Sections`, split a launch's warp time so;
// PERF.md §6), with fewer blocks an SM than K1 and K1f (63-64 registers).
// `w3d_blend_quad_power_probe` runs the same staging and MMAs on a list of
// entries and writes their powers, for the chip check's float64 witness.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <type_traits>
#include <vector>

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

// K1f: entries per batch, and its cull's margins (see `culled`): on tau, the
// widening of the warp's box by the rounding of its samples to bf16 (relative
// to the largest coordinate), and the bf16 chain's error relative to Tmax.
constexpr int kFastBatch = 256;
constexpr int kFastWords = kFastBatch / 32;
constexpr float kTauFast = 0.03125f;     // 2^-5
constexpr float kTauFastRel = 0.0078125f;  // 2^-7
constexpr float kFastBox = 0.00390625f;    // 2^-8
constexpr float kFastTerm = 0.0625f;       // 2^-4

// The quad route: JAX's skip allowances, the cull's margin per unit of
// `quad_term_bound` (see `cull_prelude`), and the largest tile-local pixel
// coordinate.
constexpr float kQuadEps = 1e-3f;
constexpr float kQuadEpsFast = 0.05f;
constexpr float kQuadMargin = 3.0517578125e-05f;      // 2^-15
constexpr float kQuadMarginFast = 1.220703125e-04f;  // 2^-13
constexpr float kSpan = static_cast<float>(kTile - 1);

// The quad route's shared memory beyond the static buffers (dynamic, see
// `quad_slab`): each batch entry's coefficient words (`stage_quad`), each
// warp's list of the batch's kept entries (one byte an entry), and each
// warp's slab of the powers of 32 kept entries at its 32 pixels (K1q f32,
// K1fq bf16).
constexpr int kWarps = kBlock / 32;
constexpr int kQuadChunk = 32;  // the kept entries a slab holds
constexpr size_t kQuadSmem = sizeof(uint32_t) * kBatch * 12 + kWarps * kBatch +
                             kWarps * kQuadChunk * 32 * sizeof(float);
constexpr size_t kFastQuadSmem = sizeof(uint32_t) * kFastBatch * 8 + kWarps * kFastBatch +
                                 kWarps * kQuadChunk * 32 * sizeof(uint16_t);

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

// Shared-memory loads at 32-bit shared addresses, for the quad kernels'
// walks, which take their bases once per chunk (`smem_base`, which the
// compiler cannot see through): through generic pointers it rebuilt the
// shared window's base (S2R, LEA) at every step of the walk. Volatile, so
// that they stay between the barriers around the walk.
__device__ __forceinline__ uint32_t smem_base(const void* p) {
  return w3d_fast::opaque(static_cast<uint32_t>(__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ float4 lds_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// Section timers, compiled in only with -DW3D_SECTION_TIMERS (`tools/
// chip_phases.py quad_sections` builds such a library beside the default
// one): lane 0 of each warp writes the clock64() cycles of each of its
// sections, and its whole span, to its own slot of g_sections[kernel]
// (kernel K1, K1q, K1f, K1fq, their culled instances; sections the batch's
// barrier and staging, the cull and the quad route's kept list, the quad
// route's MMAs, the walk), so no two warps write one word and nothing is
// atomic; blocks past kTimedBlocks are not timed. `w3d_section_timers`
// sums them. Without the flag `Sections` is empty.
#ifdef W3D_SECTION_TIMERS
constexpr int kTimedBlocks = 8192;
__device__ unsigned long long g_sections[4][kTimedBlocks][kWarps][5];
struct Sections {
  long long start, last;
  unsigned long long cycles[4] = {0, 0, 0, 0};
  __device__ Sections() {
    start = clock64();
    last = start;
  }
  __device__ void tick(int section) {
    const long long now = clock64();
    cycles[section] += now - last;
    last = now;
  }
  __device__ void flush(int kernel) {
    if (blockIdx.x < kTimedBlocks && threadIdx.x % 32 == 0) {
      unsigned long long* slot = g_sections[kernel][blockIdx.x][threadIdx.x / 32];
      for (int i = 0; i < 4; ++i) slot[i] = cycles[i];
      slot[4] = static_cast<unsigned long long>(clock64() - start);
    }
  }
};
#else
struct Sections {
  __device__ void tick(int) {}
  __device__ void flush(int) {}
};
#endif

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
// K1f (kFast) rounds exp and the product with opacity to bf16 (8 significant
// bits, each within v = 2^-8 relative) and reads E from a table of bf(exp)
// computed in f32 (within 4u before its rounding); opa is the row's bf16
// value, read as it is. A lane that takes the entry has bf(opa E) >= (1/255)
// (1 - u), so opa e^pw (1 + v)^2 (1 + 4u) >= (1/255) (1 - u) for its bf16
// power pw: -2 pw <= tau + 4v + 10u <= tau + 0.0157 (tau <= 2 ln 255 = 11.1;
// tau >= -3u where opa >= 1/255). Where pw is an f32 power rounded once (K1fq,
// below), Q_lane (1 - v) <= -2 pw, so Q_lane <= tau + 0.0158 + 0.004 max(tau,
// 0): the 2^-5 + 2^-7 |tau| that K1f and K1fq add to tau' is twice that.
// pw is JAX's bf16 chain (`power_pair`): dx = bf(mx - bf(px)), dy likewise,
// then ((Ah dx) dx + (Ch dy) dy) + (Bn dx) dy with each product and sum
// rounded to bf16 after its f32 operation. Let d* = (mx - bf(px), my -
// bf(py)) exactly and T(d) = A dx^2 + C dy^2 + 2 |B dx dy|, the magnitudes
// of Q's terms. (1) dx = d*x (1 + e) with |e| <= v, likewise dy, and Q is a
// quadratic form: Q(dx, dy) is within (2v + v^2) T(d*) of Q(d*). (2) Each of
// the three products of the chain carries two bf16 roundings and each of
// the two sums one f32 and one bf16 rounding (Ah = bf(-A/2) and Bn = -B are
// exact), so -2 pw is within ((1 + v)^4 (1 + u)^2 - 1) T(dx, dy) <= 4.03v
// T(dx, dy) of Q(dx, dy), and T(dx, dy) <= (1 + v)^2 T(d*). Together: |-2 pw
// - Q(d*)| <= 6.1v T(d*) = 0.0238 T(d*). (3) bf(px) lies in [bf(x0),
// bf(x1)], within v max(|x0|, |x1|) of [x0, x1] (rounding is monotone), so
// d* lies in the box of [mx - x1, mx - x0] widened by v max(|x0|, |x1|) on
// each side, likewise in y: K1f widens its warp's box so (`kFastBox`), and
// then T(d*) <= Tmax of the widened box. A lane that takes the entry thus has
// Q(d*) <= tau + 0.0157 + 0.0238 Tmax. K1f adds 2^-5 + 2^-7 |tau| to tau'
// and 2^-4 Tmax to the threshold (`kFastTerm`), each over twice its term,
// beside the 64u (Tmax + 1) that covers the test's own roundings, and culls
// by opa alone below 1/255 itself: E <= 1, so bf(opa E) <= opa, and an opa
// below the float 1/255 gives an alpha below it, which the skip test drops.

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
// double split (each bf16 rounding leaves 2^-8 of what it rounds); and the
// tensor cores' sum of the parts' products (`quad_slab`). Its model, from
// Fasi, Higham, Mikaitis and Pranesh ("Numerical behavior of NVIDIA tensor
// cores", PeerJ Computer Science 7:e330, 2021), taken conservatively for
// Hopper: each product of two bf16 values is exact; the products and the
// accumulator are added in blocks, the significands aligned to the block's
// largest exponent and truncated (no guard bits), and each block's sum is
// truncated to f32. The paper found blocks of 4 products (V100, T4) and of 8
// (A100); Hopper's are not published, so take the worst, blocks of one: every
// product then costs at most two units of 2^-23 of the magnitudes summed
// (one truncation at the alignment, one of the sum), and an MMA of depth K is
// within 2K 2^-23 (|C| + sum |a_i b_i|) = 4K u (...) of its exact sum (zero
// products, the two zero monomials', cost nothing). The parts' terms sum to
// at most (1 + v)^2 S < (1 + 2^-6) S. K1q: hi|mid in one m16n8k16 (64u of
// their terms), then lo in one m16n8k8 with that sum as C (32u of |C| and
// lo's terms): 97.5u S. K1fq: hi|lo in one m16n8k16, 65u S. So |power - P|
// <= (6 + 1 + 97.5)u S < 105u S in K1q and (6 + 256 + 65)u S < 1.28 2^-16 S
// in K1fq (`chip_smoke.py`'s float64 witness holds the kernel's power to
// these), and Q = -2 power moves by twice that. JAX's clamp then gives
// power' = min(power, 0) wherever the lane does not skip (power <= eps;
// above eps, power' = power - eps > 0 is skipped), so the allowance eps takes
// no entry beyond this: a lane that takes the entry has -2 power' <= tau +
// 14u (K1fq: tau + 0.0158 + 0.004 max(tau, 0); it adds K1f's tau', not its
// box or Tmax terms, which are the direct chain's) as above, and -2 P <= -2
// power + 2 |power - P| <= -2 power' + 2 |power - P|. The lane's exact point
// (mx - px, my - py) may lie outside the box's rounded edges by a rounding,
// which moves the box's least Q by at most 4u Tmax, inside the 64u (Tmax +
// 1) above. The quad cull adds 2^-15 S = 512u S (K1q: over twice 210u S) or
// 2^-13 S (K1fq: over twice 2.56 2^-16 S) to tau'; an S that is not finite
// makes tau' +inf (never culled).

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

// Per box: `a` is the row's mx, my, A, B; `pre` its `cull_prelude`. kChain:
// K1f's test, on its widened box, with its margin for the bf16 chain.
template <bool kChain = false>
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
  if (kChain) return qmin > tau + 64.0f * kU * (tmax + 1.0f) + kFastTerm * tmax;
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
// expressions in the same order). `third()` reads the row's third float4,
// only if the entry is taken. Returns false if the pixel stops at this entry,
// which is then not added.
template <typename Third>
__device__ __forceinline__ bool apply(float power, float alpha, const float4 b, Third third,
                                      float& T, float& acc_r, float& acc_g, float& acc_b,
                                      float& acc_d) {
  if (power > 0.0f || alpha < kAlphaMin) return true;
  const float test_t = T * (1.0f - alpha);
  if (test_t < kTEps) return false;
  const float4 g = third();  // g, b, pad, pad
  const float w = alpha * T;
  acc_d += b.z * w;
  acc_r += b.w * w;
  acc_g += g.x * w;
  acc_b += g.y * w;
  T = test_t;
  return true;
}

// ---- the quad route on the tensor cores (the file's head note) ---------------

using w3d_fast::bf_rn;

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

// An entry's split coefficients as the B fragments read them (4 kParts
// words, 48 B in K1q, 32 B in K1fq): word kParts q + p holds part p of the
// coefficients of monomials 2q and 2q + 1 (q = 3: the two zero monomials,
// as JAX pads pix8 to 8), the lower in the low half. Thread q of a fragment
// reads its kParts words at once, and the 32 lanes of one load meet every
// bank once.
template <int kParts>
__device__ __forceinline__ void stage_quad(float mx, float my, float A, float B, float C,
                                           uint32_t* words) {
  float parts[kParts][6];
  quad_parts<kParts>(mx, my, A, B, C, parts);
  uint32_t w[4 * kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      w[kParts * q + p] = w3d_fast::pack_rn(parts[p][2 * q], parts[p][2 * q + 1]);
    }
    w[kParts * 3 + p] = 0u;
  }
#pragma unroll
  for (int i = 0; i < kParts; ++i) {  // 16-byte stores: the rows are 16 kParts bytes
    reinterpret_cast<uint4*>(words)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                                    w[4 * i + 3]);
  }
}

// The A fragments of a warp's 32 pixels, built once per block: JAX's pix8
// [x^2, y^2, x y, x, y, 1, 0, 0] at tile-local integer coordinates (exact in
// bf16: below 256), as two m16 tiles. Row g + 8h (g = lane / 4, h = 0, 1) of
// tile mt holds the warp's pixel 16 mt + 2g + h (the lane that owns it), so
// that a thread's two rows are neighbouring pixels of the slab; a[mt][h] is
// that row's word of monomials (2q, 2q + 1), q = lane % 4.
struct QuadA {
  uint32_t a[2][2];
};

__device__ __forceinline__ QuadA quad_a(int warp, int lane) {
  QuadA f;
  const int q = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * mt + 2 * (lane / 4) + h;
      const float x = static_cast<float>(kWarpW * (warp % 2) + p % kWarpW);
      const float y = static_cast<float>(kWarpH * (warp / 2) + p / kWarpW);
      const float lo = q == 0 ? x * x : q == 1 ? x * y : q == 2 ? y : 0.0f;
      const float hi = q == 0 ? y * y : q == 1 ? x : q == 2 ? 1.0f : 0.0f;
      f.a[mt][h] = w3d_fast::pack_rn(lo, hi);
    }
  }
  return f;
}

// d += A B on the tensor cores, bf16 inputs and f32 accumulation, d 16 x 8
// (four values a thread): m16n8k16 with A 16 x 16 (four words a thread) and B
// 16 x 8 (two), m16n8k8 with A 16 x 8 (two) and B 8 x 8 (one).
__device__ __forceinline__ void mma_k16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, "
      "{%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// JAX's clamp, min(p, 0) + max(p - eps, 0), with NaN kept as torch.minimum /
// torch.maximum keep it (`min.NaN`, `max.NaN`).
__device__ __forceinline__ float quad_clamp(float p, float eps) {
  float below, above;
  asm("min.NaN.f32 %0, %1, 0f00000000;" : "=f"(below) : "f"(p));
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(above) : "f"(__fsub_rn(p, eps)));
  return __fadd_rn(below, above);
}

// A warp's slab holds the powers of up to 32 kept entries (positions in the
// warp's list) at its 32 pixels: for each pair of positions (2 r, 2 r + 1)
// and pixel p, the two powers side by side, pixel p of pair r at slot 32 r +
// (p ^ s(r)). K1q keeps the raw f32 powers (8 bytes a slot), K1fq the
// clamped ones rounded to bf16 (`kQuadEpsFast`; 4 bytes a slot, the word the
// walk's bf16x2 table lookup takes); the swizzle s(r) (4 (r % 4) in K1q, 8 (r
// % 4) in K1fq) leaves neither a thread's fragment store (two pixels of two
// positions: 16 or 8 bytes) nor the walk's read (one pair at pixel = lane)
// with a bank conflict, and the slab needs no padding.
__device__ __forceinline__ int slab_slot(int pair, int pixel, int swizzle) {
  return 32 * pair + (pixel ^ (swizzle * (pair & 3)));
}

// The powers of the warp's kept entries at positions [0, m) of `list` (batch
// indices, m <= kQuadChunk) into its slab: for each group of 8 positions and
// each of the two m16 tiles of pixels, K1q's (kParts 3) hi|mid as one
// m16n8k16 and lo as one m16n8k8 onto that sum, or K1fq's (2) hi|lo as one
// m16n8k16, the monomials twice along K. Straight-line code: every group's
// loads, then the groups' independent MMA chains and stores, so that their
// latencies overlap (a group past m reads position 0's words and writes
// slots the walk does not read). `raw`: f32 raw powers in K1q's layout
// whatever kParts (the probe's). Each output (pixel, entry) depends on its
// own row and column only, so a kernel and its walk of every entry get the
// same bits.
template <int kParts, bool kRaw = (kParts == 3)>
__device__ __forceinline__ void quad_slab(void* slab, const uint32_t* coef, const uint8_t* list,
                                          int m, const QuadA& fa, int lane) {
  constexpr int kGroups = kQuadChunk / 8;
  const int g = lane / 4, q = lane % 4;
  uint32_t b[kGroups][kParts];
#pragma unroll
  for (int nt = 0; nt < kGroups; ++nt) {
    const int e = 8 * nt + g;  // this thread's B column
    const uint32_t* w = coef + 4 * kParts * list[e < m ? e : 0] + kParts * q;
    if constexpr (kParts == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(w);
      b[nt][0] = v.x;
      b[nt][1] = v.y;
    } else {
#pragma unroll
      for (int p = 0; p < kParts; ++p) b[nt][p] = w[p];
    }
  }
  // Half the groups at a time: their MMA chains, then their stores (all
  // groups at once held 32 accumulators and ran K1q slower on the H100).
#pragma unroll
  for (int h = 0; h < kGroups; h += kGroups / 2) {
    float d[kGroups / 2][2][4];
#pragma unroll
    for (int nn = 0; nn < kGroups / 2; ++nn) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) d[nn][mt][i] = 0.0f;
        mma_k16(d[nn][mt], fa.a[mt][0], fa.a[mt][1], fa.a[mt][0], fa.a[mt][1], b[h + nn][0],
                b[h + nn][1]);
      }
    }
    if constexpr (kParts == 3) {
#pragma unroll
      for (int nn = 0; nn < kGroups / 2; ++nn) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_k8(d[nn][mt], fa.a[mt][0], fa.a[mt][1], b[h + nn][2]);
        }
      }
    }
#pragma unroll
    for (int nn = 0; nn < kGroups / 2; ++nn) {
      const int pair = 4 * (h + nn) + q;  // positions 2 pair, 2 pair + 1 of its D columns
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* v = d[nn][mt];
        const int p = 16 * mt + 2 * g;  // rows g, g + 8: pixels p, p + 1
        if constexpr (kRaw) {
          // (p, 2 pair), (p, 2 pair + 1), (p + 1, 2 pair), (p + 1, 2 pair + 1)
          reinterpret_cast<float4*>(slab)[slab_slot(pair, p, 4) / 2] =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
          reinterpret_cast<uint2*>(slab)[slab_slot(pair, p, 8) / 2] = make_uint2(
              w3d_fast::pack_rn(quad_clamp(v[0], kQuadEpsFast), quad_clamp(v[1], kQuadEpsFast)),
              w3d_fast::pack_rn(quad_clamp(v[2], kQuadEpsFast),
                                quad_clamp(v[3], kQuadEpsFast)));
        }
      }
    }
  }
}

// The warp's kept entries of a batch in order, from its keep words: list[i]
// is the batch index of its i-th kept entry; returns their count.
template <int kW>
__device__ __forceinline__ int kept_list(const unsigned (&keep)[kW], uint8_t* list, int lane) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    if ((keep[k] >> lane) & 1u) list[n + __popc(keep[k] & ((1u << lane) - 1u))] = 32 * k + lane;
    n += __popc(keep[k]);
  }
  __syncwarp();
  return n;
}

// K1q's alpha: min(0.99, opa expf(power)), NaN kept as torch.clamp_max keeps it.
__device__ __forceinline__ float quad_alpha(float opa, float power) {
  const float a = __fmul_rn(opa, expf(power));
  return a > kAlphaMax ? kAlphaMax : a;
}

// K1 (kQuad false) and K1q (kQuad true: the quad route, tile-local samples,
// no offsets; its coefficient words and the warps' slabs in dynamic shared
// memory, kQuadSmem bytes).
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
  extern __shared__ uint4 quad_smem[];  // K1q: kQuadSmem bytes
  uint32_t* const coef = reinterpret_cast<uint32_t*>(quad_smem);  // [kBatch][12]

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
  if (!kQuad && inside && offsets != nullptr) {
    const float2 o = offsets[static_cast<size_t>(y) * width + x];
    px += o.x;
    py += o.y;
  }
  uint8_t* const list = reinterpret_cast<uint8_t*>(coef + kBatch * 12) + warp * kBatch;
  float* const slab =
      reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(coef + kBatch * 12) + kWarps * kBatch) +
      warp * kQuadChunk * 32;
  const QuadA fa = kQuad ? quad_a(warp, lane) : QuadA{};
  // K1q's cull takes the recentred mean, as the thread that stages an entry
  // computes it
  auto local = [&](float4 a) {
    a.x = __fsub_rn(a.x, ox);
    a.y = __fsub_rn(a.y, oy);
    return a;
  };

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
  Sections sections;

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
        if constexpr (kQuad) {
          a = local(a);
          stage_quad<3>(a.x, a.y, a.z, a.w, b.x, coef + 12 * t);
        }
        if (kCull) prelude[t] = cull_prelude<false, kQuad>(a, b.x, b.y);
      }
      __syncthreads();
    }
    sections.tick(0);
    if (__all_sync(kFull, done)) continue;

    if constexpr (kQuad) {
      // The warp's kept entries in order (`kept_list`), 32 at a time: their
      // powers on the tensor cores into the warp's slab, then the walk as
      // K1's below, reading each pair of powers from the slab.
      unsigned keep[kWords];
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int j = 32 * k + lane;
        bool take = j < count;
        if (kCull && take) take = !culled(local(batch[kVecs * j]), prelude[j], x0, x1, y0, y1);
        keep[k] = __ballot_sync(kFull, take);
      }
      const int n = kept_list(keep, list, lane);
      sections.tick(1);
      for (int c0 = 0; c0 < n; c0 += kQuadChunk) {
        if (__all_sync(kFull, done)) break;
        const int m = min(kQuadChunk, n - c0);
        quad_slab<3>(slab, coef, list + c0, m, fa, lane);
        __syncwarp();
        sections.tick(2);
        const uint32_t slab_s = smem_base(slab), list_s = smem_base(list + c0);
        const uint32_t rows_s = smem_base(batch);
        for (int pos = 0; pos < m && !done; pos += 2) {
          const bool two = pos + 1 < m;
          const uint32_t jj = w3d_fast::lds_u16(list_s + pos);  // positions pos, pos + 1
          const uint32_t r1 = rows_s + 16u * kVecs * (jj & 0xffu);  // 16 kVecs bytes a row
          const uint32_t r2 = two ? rows_s + 16u * kVecs * (jj >> 8) : r1;
          const float2 pw = lds_f2(slab_s + 8u * slab_slot(pos / 2, lane, 4));
          const float4 b = lds_f4(r1 + 16u);  // C, opa, depth, r
          const float4 b2 = lds_f4(r2 + 16u);
          const float power = quad_clamp(pw.x, kQuadEps);
          const float power2 = quad_clamp(pw.y, kQuadEps);
          const float alpha = quad_alpha(b.y, power);
          const float alpha2 = quad_alpha(b2.y, power2);
          if (!apply(power, alpha, b, [=] { return lds_f4(r1 + 32u); }, T, acc_r, acc_g, acc_b,
                     acc_d) ||
              (two && !apply(power2, alpha2, b2, [=] { return lds_f4(r2 + 32u); }, T, acc_r,
                             acc_g, acc_b, acc_d))) {
            done = true;
          }
        }
        __syncwarp();  // the walk's reads before the next chunk's stores
        sections.tick(3);
      }
    } else {
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
      sections.tick(1);

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
          const float4 a = batch[kVecs * j + 0];  // mx, my, A, B
          const float4 a2 = batch[kVecs * j2 + 0];
          const float power = power_at(a, b, px, py);
          const float power2 = power_at(a2, b2, px, py);
          const float alpha = fminf(kAlphaMax, b.y * expf(power));
          const float alpha2 = fminf(kAlphaMax, b2.y * expf(power2));
          if (!apply(power, alpha, b, [&] { return batch[kVecs * j + 2]; }, T, acc_r, acc_g,
                     acc_b, acc_d) ||
              (two && !apply(power2, alpha2, b2, [&] { return batch[kVecs * j2 + 2]; }, T, acc_r,
                             acc_g, acc_b, acc_d))) {
            done = true;
            break;
          }
        }
      }
      sections.tick(3);
    }
  }

  sections.flush(kQuad ? 1 : 0);
  if (inside) {
    const size_t p = static_cast<size_t>(y) * width + x;
    color[3 * p + 0] = acc_r + T * bg[0];
    color[3 * p + 1] = acc_g + T * bg[1];
    color[3 * p + 2] = acc_b + T * bg[2];
    depth[p] = acc_d;
    final_t[p] = T;
  }
}

// A batch entry as K1f's walk reads it, prepared once per block (16-byte
// fields, one base address).
struct FastEntry {
  float4 geom;   // mx, my, A, B: the cull's
  float4 power;  // Ah, Bn, Ch (`power_coefficients`), and the row's (C, opa) word
  float4 color;  // depth, r, g, b
  float4 pre;    // `cull_prelude`
};

// K1fq's: K1f's colour and cull prelude (its coefficients are words in
// dynamic shared memory, `stage_quad`; its cull reads the geometry from the
// row itself, its walk the opacity).
struct FastQuadEntry {
  float4 color;
  float4 pre;
};

// K1f (the file's head note). Per batch, thread t prepares entry t: its f32
// geometry, power coefficients and colour, and its cull prelude; then each
// warp takes its keep words and walks its kept entries two at a time, as K1
// does. K1fq (kQuad): the quad route's coefficient words in place of the
// direct form's, the entry's (C, opa) word beside them, and each keep word's
// powers from the tensor cores (`quad_slab`), in dynamic shared memory
// (kFastQuadSmem bytes).
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
  __shared__ uint4 table[kTableVecs];
  extern __shared__ uint4 quad_smem[];  // K1fq: kFastQuadSmem bytes
  uint32_t* const coef = reinterpret_cast<uint32_t*>(quad_smem);  // [kFastBatch][8]
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
  if (!kQuad && inside && offsets != nullptr) {
    const float2 o = offsets[static_cast<size_t>(y) * width + x];
    px = __fadd_rn(px, o.x);
    py = __fadd_rn(py, o.y);
  }
  // K1f: the samples as the bf16 chain takes them
  const float pxb = bf_rn(px), pyb = bf_rn(py);
  uint8_t* const list = reinterpret_cast<uint8_t*>(coef + kFastBatch * 8) + warp * kFastBatch;
  uint32_t* const slab = reinterpret_cast<uint32_t*>(
                             reinterpret_cast<uint8_t*>(coef + kFastBatch * 8) +
                             kWarps * kFastBatch) +
                         warp * kQuadChunk * 16;
  const QuadA fa = kQuad ? quad_a(warp, lane) : QuadA{};

  float x0 = warp_min(inside ? px : CUDART_INF_F);
  float x1 = warp_max(inside ? px : -CUDART_INF_F);
  float y0 = warp_min(inside ? py : CUDART_INF_F);
  float y1 = warp_max(inside ? py : -CUDART_INF_F);
  if (!kQuad) {  // K1f's cull: the box of the rounded samples bf(px), bf(py) (`culled`)
    const float sx = kFastBox * fmaxf(fabsf(x0), fabsf(x1));
    const float sy = kFastBox * fmaxf(fabsf(y0), fabsf(y1));
    x0 -= sx;
    x1 += sx;
    y0 -= sy;
    y1 += sy;
  }

  const int start = starts[tile];
  const int end = ends[tile];
  float log_t = 0.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  bool done = !inside;
  Sections sections;

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

  // Two entries' powers (bf16, in one word: `pw`, whose halves as f32 are
  // `power`, `power2`) and opacities, then both alphas in bf16x2 pairs (an
  // entry's alpha does not depend on T), then each entry applied in order.
  // Per pixel these are the same values, in the same order, as one entry at
  // a time. Returns false where the pixel stops.
  auto take_two = [&](uint32_t pw, float power, float power2, uint32_t opa, const float4 c1,
                      const float4 c2, bool two) {
    const uint32_t ex = tab.exp_pair(pw);
    const uint32_t alpha = min2(mul2(opa, ex), kAlphaMax2);
    const uint32_t om = sub2(kOne2, alpha);
    return take(power, __byte_perm(om, alpha, 0x5410), c1) &&
           (!two || take(power2, __byte_perm(om, alpha, 0x7632), c2));
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
        if constexpr (kQuad) {
          stage_quad<2>(g.x, g.y, g.z, g.w, lo_f(v.z), coef + 8 * t);
        } else {
          const float3 k = power_coefficients(v);
          e.geom = g;
          e.power = make_float4(k.x, k.y, k.z, __uint_as_float(v.z));
        }
        e.color = make_float4(lo_f(v.w), hi_f(v.w), lo_f(v2.x), hi_f(v2.x));
        if (kCull) e.pre = cull_prelude<true, kQuad>(g, lo_f(v.z), hi_f(v.z));
      }
      __syncthreads();
    }
    sections.tick(0);
    if (__all_sync(kFull, done)) continue;

    if constexpr (kQuad) {
      // As K1q: the kept entries 32 at a time, their clamped bf16 powers on
      // the tensor cores, then their walk as K1f's, each pair of powers one
      // word of the slab.
      const uint32_t* words = reinterpret_cast<const uint32_t*>(batches[which]);
      unsigned keep[kFastWords];
#pragma unroll
      for (int k = 0; k < kFastWords; ++k) {
        const int j = 32 * k + lane;
        bool take_it = j < count;
        if (kCull && take_it) {
          take_it = !culled(geometry(batches[which][2 * j]), entries[j].pre, x0, x1, y0, y1);
        }
        keep[k] = __ballot_sync(kFull, take_it);
      }
      const int n = kept_list(keep, list, lane);
      sections.tick(1);
      for (int c0 = 0; c0 < n; c0 += kQuadChunk) {
        if (__all_sync(kFull, done)) break;
        const int m = min(kQuadChunk, n - c0);
        quad_slab<2>(slab, coef, list + c0, m, fa, lane);
        __syncwarp();
        sections.tick(2);
        const uint32_t slab_s = smem_base(slab), list_s = smem_base(list + c0);
        const uint32_t rows_s = smem_base(words), colour_s = smem_base(&entries[0].color);
        for (int pos = 0; pos < m && !done; pos += 2) {
          const bool two = pos + 1 < m;
          const uint32_t jj = lds_u16(list_s + pos);  // positions pos, pos + 1
          const uint32_t j = jj & 0xffu;
          const uint32_t j2 = two ? jj >> 8 : j;
          const uint32_t pw = lds_u32(slab_s + 4u * slab_slot(pos / 2, lane, 8));
          // (C, opa) of each row (4 kRowWords bytes): opacities in the high halves
          const uint32_t opa = __byte_perm(lds_u32(rows_s + 4u * (kRowWords * j + 2)),
                                           lds_u32(rows_s + 4u * (kRowWords * j2 + 2)), 0x7632);
          constexpr uint32_t kEntryBytes = sizeof(Entry);
          if (!take_two(pw, lo_f(pw), hi_f(pw), opa, lds_f4(colour_s + kEntryBytes * j),
                        lds_f4(colour_s + kEntryBytes * j2), two)) {
            done = true;
          }
        }
        __syncwarp();  // the walk's reads before the next chunk's stores
        sections.tick(3);
      }
    } else {
      unsigned keep[kFastWords];  // bit l of keep[k]: the warp walks entry 32 k + l
#pragma unroll
      for (int k = 0; k < kFastWords; ++k) {
        const int j = 32 * k + lane;
        bool take_it = j < count;
        if (kCull && take_it) {
          take_it = !culled<true>(entries[j].geom, entries[j].pre, x0, x1, y0, y1);
        }
        keep[k] = __ballot_sync(kFull, take_it);
      }
      sections.tick(1);

#pragma unroll
      for (int k = 0; k < kFastWords; ++k) {
        unsigned bits = keep[k];
        while (bits != 0u && !done) {
          const int j = 32 * k + __ffs(bits) - 1;
          bits &= bits - 1u;
          const bool two = bits != 0u;
          const int j2 = two ? 32 * k + __ffs(bits) - 1 : j;
          if (two) bits &= bits - 1u;
          const Entry& e1 = entries[j];
          const Entry& e2 = entries[j2];
          const float4 c1 = e1.color, c2 = e2.color;  // loaded here: cheaper than in `take`
          const float4 p1 = e1.power, p2 = e2.power;
          const uint32_t pw =
              power_pair(pair_of(p1.x, p2.x), pair_of(p1.y, p2.y), pair_of(p1.z, p2.z),
                         offset_pair(e1.geom.x, e2.geom.x, pxb),
                         offset_pair(e1.geom.y, e2.geom.y, pyb));
          if (!take_two(pw, lo_f(pw), hi_f(pw), pair_of(p1.w, p2.w), c1, c2, two)) {
            done = true;
            break;
          }
        }
      }
      sections.tick(3);
    }
  }

  sections.flush(kQuad ? 3 : 2);
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

// The quad route's raw power (before JAX's clamp) as K1q (kParts 3, [K, 12]
// f32 rows in image coordinates, recentred on the tile as K1q recentres
// them) and K1fq (2, [K, 16] bf16 rows) compute it, with the same
// `stage_quad`, fragments and `quad_slab`, for a list of entries: item i is
// entry idx[i] of tile tiles[i], written at every pixel of that tile,
// out[i][256] f32 (tile pixels row-major). Block b takes items [32 b, 32 b +
// 32), each warp its own 8 x 4 pixels. Only chip_smoke.py calls it, for its
// float64 witness of the kernels' power.
template <int kParts>
__global__ void __launch_bounds__(kBlock)
quad_power_probe(const void* __restrict__ rows, const int* __restrict__ idx,
                 const int* __restrict__ tiles, int n, int grid_x, int row0,
                 float* __restrict__ out) {
  __shared__ __align__(16) uint32_t words[32 * 4 * kParts];
  __shared__ __align__(16) float slabs[kWarps][32 * 32];
  __shared__ uint8_t list[32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int first = 32 * blockIdx.x;
  const int count = min(32, n - first);
  if (static_cast<int>(threadIdx.x) < count) {
    const int e = idx[first + threadIdx.x];
    const int t = tiles[first + threadIdx.x];
    list[threadIdx.x] = static_cast<uint8_t>(threadIdx.x);
    if constexpr (kParts == 3) {
      const float4* r = static_cast<const float4*>(rows) + kVecs * static_cast<size_t>(e);
      float4 a = r[0];
      const float4 b = r[1];
      a.x = __fsub_rn(a.x, static_cast<float>((t % grid_x) * kTile));
      a.y = __fsub_rn(a.y, static_cast<float>(row0 + (t / grid_x) * kTile));
      stage_quad<3>(a.x, a.y, a.z, a.w, b.x, words + 12 * threadIdx.x);
    } else {
      const uint4 v = static_cast<const uint4*>(rows)[2 * static_cast<size_t>(e)];
      const float4 g = w3d_fast::geometry(v);
      stage_quad<2>(g.x, g.y, g.z, g.w, w3d_fast::lo_f(v.z), words + 8 * threadIdx.x);
    }
  }
  __syncthreads();
  quad_slab<kParts, true>(slabs[warp], words, list, count, quad_a(warp, lane), lane);
  __syncwarp();
  const int pixel = (kWarpH * (warp / 2) + lane / kWarpW) * kTile + kWarpW * (warp % 2) +
                    lane % kWarpW;
  for (int e = 0; e < count; ++e) {
    out[static_cast<size_t>(first + e) * kBlock + pixel] =
        slabs[warp][2 * slab_slot(e / 2, lane, 4) + e % 2];
  }
}

template <bool kCull, bool kQuad = false>
int launch(const void* rows, const void* starts, const void* ends, const void* offsets,
           const void* bg, void* color, void* depth, void* final_t, int width, int height,
           int grid_x, int num_tiles, int row0, int device, void* stream) {
  if (kQuad && offsets != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = kQuad ? kQuadSmem : 0;
  if constexpr (kQuad) {
    static unsigned configured = 0;
    err = w3d_fast::allow_smem(blend_fwd_kernel<kCull, kQuad>, smem, device, configured);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_tiles > 0) {
    blend_fwd_kernel<kCull, kQuad><<<num_tiles, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
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
  const size_t smem = kQuad ? kFastQuadSmem : 0;
  if constexpr (kQuad) {
    static unsigned configured = 0;
    err = w3d_fast::allow_smem(blend_fwd_fast_kernel<kCull, kQuad>, smem, device, configured);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_tiles > 0) {
    blend_fwd_fast_kernel<kCull, kQuad><<<num_tiles, kBlock, smem,
                                          static_cast<cudaStream_t>(stream)>>>(
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

// The quad route's raw power for a list of entries (`quad_power_probe`):
// rows (K1q's f32 rows with `fast` 0, K1fq's bf16 rows with 1), idx and tiles
// [n] int32, out [n, 256] f32; row0 as K1q takes it. Only chip_smoke.py
// calls it.
int w3d_blend_quad_power_probe(const void* rows, const void* idx, const void* tiles, void* out,
                               int n, int grid_x, int row0, int fast, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int blocks = (n + 31) / 32;
    const auto s = static_cast<cudaStream_t>(stream);
    const int* i = static_cast<const int*>(idx);
    const int* t = static_cast<const int*>(tiles);
    float* o = static_cast<float*>(out);
    if (fast) {
      quad_power_probe<2><<<blocks, kBlock, 0, s>>>(rows, i, t, n, grid_x, row0, o);
    } else {
      quad_power_probe<3><<<blocks, kBlock, 0, s>>>(rows, i, t, n, grid_x, row0, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef W3D_SECTION_TIMERS
// The section timers (`Sections`): out[5 k + i] is kernel k's cycles in
// section i summed over its warps, out[5 k + 4] its longest warp span; with
// `reset`, zeroes them instead.
int w3d_section_timers(unsigned long long* out, int reset) {
  if (reset) {
    void* p = nullptr;
    const cudaError_t err = cudaGetSymbolAddress(&p, g_sections);
    return static_cast<int>(err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(g_sections)));
  }
  std::vector<unsigned long long> h(sizeof(g_sections) / sizeof(unsigned long long));
  const cudaError_t err = cudaMemcpyFromSymbol(h.data(), g_sections, sizeof(g_sections));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t warps = static_cast<size_t>(kTimedBlocks) * kWarps;
  for (int k = 0; k < 4; ++k) {
    for (int i = 0; i < 5; ++i) out[5 * k + i] = 0;
    for (size_t w = 0; w < warps; ++w) {
      const unsigned long long* slot = &h[(k * warps + w) * 5];
      for (int i = 0; i < 4; ++i) out[5 * k + i] += slot[i];
      out[5 * k + 4] = std::max(out[5 * k + 4], slot[4]);
    }
  }
  return 0;
}
#endif

const char* w3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
