// The bf16 tier's arithmetic, shared by K1f (blend_fwd.cu) and K2f
// (blend_bwd.cu), so that K2f recomputes alpha, T and the stops exactly as
// K1f computes them.
//
// Rows are [K, 16] bf16, 32 bytes, read as eight 32-bit words: (mx, my),
// (A, B), (C, opa), (depth, r), (g, b), then zeros; the first value of each
// pair is in the low half. The means are local to the entry's tile, and the
// kernels sample at tile-local positions.
//
// Every rounding point is that of `wast3d_tpu_torch/ops/rasterizer/blend.py`
// (its module docstring has the function). The product of two bf16 values is
// exact in f32, so one `mul.rn.bf16x2` rounds exactly where the plain version
// rounds its f32 product; the `.rn` forms also keep the compiler from fusing a
// product and a sum into one FMA, which would drop a rounding. Power is JAX's
// bf16 chain, one operation at a time as XLA evaluates a bf16 operation (the
// f32 operation, then one rounding to bf16): its products with
// `mul.rn.bf16x2`, its sums as an f32 `__fadd_rn` and then `cvt.rn` (a native
// bf16 add would round once where XLA rounds twice), so that K1f's and K2f's
// power equals the plain version's.
//
// E[x] = bf(exp(x)) and L[a] = bf(log1p(-a)) are read from one bf16 table
// that the wrapper passes (`blend.fast_tables`, built once; the plain
// versions read the same tensor): E at [0, kExpSize), L after it. A bf16
// value's bits index them: E[x] at clamp((bits & 0x7fff) - kExpLo + 1, 0,
// kExpSize - 1) (1 below 2^-9, 0 from 16 up), L[a] at kExpSize + bits -
// kLogLo for every bf16 a in [1/255, 0.98828125]. The kernels copy the table
// (5,376 bytes) into shared memory once per block, and keep its addresses in
// registers (`Tables`).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace w3d_fast {

constexpr int kRowWords = 8;  // 32-bit words per row
constexpr int kExpLo = 0x3B00, kExpHi = 0x4180;  // bits of 2^-9 and of 16
constexpr int kLogLo = 0x3B81, kLogHi = 0x3F7E;  // least bf16 >= 1/255; one past bf(0.99)
constexpr int kExpSize = kExpHi - kExpLo + 2;
constexpr int kTableUsed = kExpSize + kLogHi - kLogLo;
constexpr int kTableVecs = (kTableUsed + 7) / 8;  // 16-byte words of the table
constexpr uint32_t kAlphaMax2 = 0x3F7D3F7Du;  // bf(0.99) = 0.98828125, twice
constexpr uint32_t kOne2 = 0x3F803F80u;       // 1.0, twice
// alpha < 1/255 (f32) for a bf16 alpha in a word's high half: the signed
// word below this, the least bf16 above 1/255 (alpha is never NaN; -0 and
// negatives count as below, as in f32).
constexpr int kAlphaMinBits = 0x3B810000;

// The bf16 in the low / high half of a word, as f32 (exact).
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// lo and hi rounded to bf16 (to nearest, ties to even), in one word.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The bits of x rounded to bf16.
__device__ __forceinline__ unsigned short bits_rn(float x) {
  unsigned short d;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(d) : "f"(x));
  return d;
}

// Two bf16 operations at once, each rounded once (to nearest, ties to even).
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// One bf16 sum of the low halves, rounded once; the result in the low half.
__device__ __forceinline__ uint32_t add_lo(uint32_t a, uint32_t b) {
  unsigned short d;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(static_cast<unsigned short>(a)),
      "h"(static_cast<unsigned short>(b)));
  return d;
}

// x through an instruction the compiler cannot see through, so that the
// table's addresses are computed once: without it they were rebuilt from the
// shared window's base (S2R, LEA) at lookups, and K1f ran 5% slower on the
// H100.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

// A 16-bit load at a 32-bit shared-memory address. Volatile, so that it
// stays after the barrier that publishes the table.
__device__ __forceinline__ unsigned short lds_u16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr));
  return v;
}

// The table's addresses, from `base`, its shared-memory address. E[x] is at
// exp_base + 2 clamp(bits(x) & 0x7fff, kExpLo - 1, kExpHi) (the clamp maps
// magnitudes below 2^-9 to the entry 1 and from 16 up to the entry 0); L[a]
// at log_base + 2 bits(a).
struct Tables {
  uint32_t exp_base, log_base;
  __device__ __forceinline__ explicit Tables(uint32_t base)
      : exp_base(opaque(base - 2 * (kExpLo - 1))),
        log_base(opaque(base + 2 * (kExpSize - kLogLo))) {}

  // E[x] for the bf16 bits of x.
  __device__ __forceinline__ unsigned short exp_one(uint32_t bits) const {
    return lds_u16(exp_base + 2 * min(max(bits & 0x7fffu, kExpLo - 1u), kExpHi + 0u));
  }
  // E of both halves of a bf16x2 word, as a bf16x2 word (both clamps in two
  // 16x2 instructions).
  __device__ __forceinline__ uint32_t exp_pair(uint32_t pair) const {
    const uint32_t m = __vimin_s16x2_relu(__vimax_s16x2_relu(pair & 0x7fff7fffu,
                                                             (kExpLo - 1) * 0x10001u),
                                          kExpHi * 0x10001u);
    return lds_u16(exp_base + 2 * (m & 0xffffu)) |
           (static_cast<uint32_t>(lds_u16(exp_base + (m >> 15))) << 16);
  }
  // E[x] for x = log T <= 0: +0 or negative, its bits 0 or at least 0x8000,
  // so the sign needs no mask; and log T > -16, so no upper clamp: every
  // entry taken keeps bf(T bf(1 - alpha)) >= 1e-4, and log T then falls by
  // L[alpha], within 2^-8 of ln(1 - alpha), so log T stays above ln(1e-4) -
  // 0.1 > -9.5.
  __device__ __forceinline__ unsigned short exp_log_t(uint32_t bits) const {
    return lds_u16(exp_base - 0x10000u + 2 * max(bits, 0x8000u + kExpLo - 1u));
  }
  // L[a] for a word (1 - a, a) of two bf16, a in [1/255, 0.98828125]: 1 - a
  // is positive, so the word shifted right by 15 is twice a's bits.
  __device__ __forceinline__ unsigned short log1m_pair(uint32_t pair) const {
    return lds_u16(log_base + (pair >> 15));
  }
};

// (t, t) times b: a bf16x2 product with t in both halves of one operand.
__device__ __forceinline__ uint32_t mul2_dup(unsigned short t, uint32_t b) {
  uint32_t d;
  asm("{\n .reg .b32 tt;\n mov.b32 tt, {%1, %1};\n mul.rn.bf16x2 %0, tt, %2;\n}"
      : "=r"(d) : "h"(t), "r"(b));
  return d;
}

// x rounded to bf16 (to nearest, ties to even), as f32.
__device__ __forceinline__ float bf_rn(float x) {
  return __uint_as_float(static_cast<uint32_t>(bits_rn(x)) << 16);
}

// power = ((Ah dx) dx + (Ch dy) dy) + (Bn dx) dy for two entries at once,
// JAX's bf16 chain (`_chunk_quantities_fast`, `pallas_blend.py:301-310`)
// with Ah = bf(-A/2), Ch = bf(-C/2), Bn = -B and dx = bf(mx - bf(px)), dy
// likewise: every operand a bf16x2 word (entry 1 in the low half), every
// product and sum rounded to bf16 as the plain version rounds it. Returns
// both powers, bf16, in one word.
__device__ __forceinline__ uint32_t power_pair(uint32_t ah, uint32_t bn, uint32_t ch,
                                               uint32_t dx, uint32_t dy) {
  const uint32_t t1 = mul2(mul2(ah, dx), dx);
  const uint32_t t2 = mul2(mul2(ch, dy), dy);
  const uint32_t t3 = mul2(mul2(bn, dx), dy);
  const uint32_t s = pack_rn(__fadd_rn(lo_f(t1), lo_f(t2)), __fadd_rn(hi_f(t1), hi_f(t2)));
  return pack_rn(__fadd_rn(lo_f(s), lo_f(t3)), __fadd_rn(hi_f(s), hi_f(t3)));
}

// One bf16 product, rounded once: either half of `mul2`.
__device__ __forceinline__ unsigned short mul1(unsigned short a, unsigned short b) {
  unsigned short d;
  asm("mul.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

// The bf16 bits of x, a bf16-valued f32.
__device__ __forceinline__ unsigned short bits_of(float x) {
  return static_cast<unsigned short>(__float_as_uint(x) >> 16);
}

// `power_pair`'s chain for one entry, in the same operations and order (the
// same bits as either half): operands and result bf16 bits.
__device__ __forceinline__ unsigned short power_one(unsigned short ah, unsigned short bn,
                                                    unsigned short ch, unsigned short dx,
                                                    unsigned short dy) {
  const float t1 = lo_f(mul1(mul1(ah, dx), dx));
  const float t2 = lo_f(mul1(mul1(ch, dy), dy));
  const float t3 = lo_f(mul1(mul1(bn, dx), dy));
  return bits_rn(__fadd_rn(lo_f(bits_rn(__fadd_rn(t1, t2))), t3));
}

// The bf16 halves of two bf16-valued f32s (the low 16 bits of each are 0), in
// one word: a's in the low half.
__device__ __forceinline__ uint32_t pair_of(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// dx = bf(mx - pxb) for two entries' mx, in one word; pxb = bf(px).
__device__ __forceinline__ uint32_t offset_pair(float m1, float m2, float pxb) {
  return pack_rn(__fsub_rn(m1, pxb), __fsub_rn(m2, pxb));
}

// The row's first 16 bytes (words (mx, my), (A, B), ...) as f32 (mx, my, A, B).
__device__ __forceinline__ float4 geometry(const uint4 v) {
  return make_float4(lo_f(v.x), hi_f(v.x), lo_f(v.y), hi_f(v.y));
}

// power's coefficients of a row whose first 16 bytes are `v`: (Ah, Bn, Ch),
// each bf16-valued (JAX's bf(-0.5) A, rounded as XLA rounds it).
__device__ __forceinline__ float3 power_coefficients(const uint4 v) {
  return make_float3(bf_rn(__fmul_rn(-0.5f, lo_f(v.y))), -hi_f(v.y),
                     bf_rn(__fmul_rn(-0.5f, lo_f(v.z))));
}

// Dynamic shared memory past 48 KB needs the attribute, set once per device
// and kernel (devices 0-31; any other on every call).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device, unsigned& configured) {
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if ((configured & bit) && bit != 0u) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) configured |= bit;
  return err;
}

}  // namespace w3d_fast
