// wast3d_tpu_torch native JPEG 2000 (ISO/IEC 15444-1) decoding loops, as
// OpenJPEG 2.5.4 (the library PIL links) computes them. `utils/jpeg2000.py`
// parses the codestream and its packets and calls these:
//
//   w3d_j2k_t1(data, size, cblks, n, segs, steps, out, stride, reversible,
//              msg, msg_len): tier-1 on the code-blocks of one
//     tile-component. Each code-block (10 int32: x and y of its first sample
//     in `out`, width, height, band 0 LL / 1 HL / 2 LH / 3 HH, code-block
//     style, the bit-plane its first cleanup pass codes plus one, the ROI
//     shift, its first segment and its segment count) has segments of 3
//     int32 (offset into `data`, length, coding passes). The MQ decoder
//     reads each segment followed by two 0xFF bytes, as OpenJPEG appends
//     them; the lazy (bypass) passes read raw bits. Significance
//     propagation, magnitude refinement and cleanup with the 19 contexts,
//     vertically causal contexts, context reset, segmentation symbols. The
//     samples hold one bit below the last decoded plane (the midpoint of
//     what is left), then OpenJPEG's ROI down-shift, then: reversible, the
//     sample halved (C division) into int32 `out`; irreversible, the
//     sample times `steps[i]` (half the band's step) into float32 `out`.
//     Up to 8 threads take the code-blocks one at a time.
//   w3d_j2k_idwt(buf, stride, res, nres, reversible): the inverse 5/3
//     (int32, integer lifting) or 9/7 (float32, OpenJPEG's lifting
//     constants and order) over the resolutions' rectangles (4 int32 each,
//     on the tile-component's grid), rows then columns at each level.
//   w3d_j2k_mct(c0, c1, c2, n, reversible): the inverse RCT (int32) or ICT
//     (float32) in place.
//   w3d_j2k_level(buf, n, reversible, shift, lo, hi, out): the DC level
//     shift and clamp into int32 (the irreversible path rounds with
//     lrintf first).
//
// Float code is compiled without contraction: each product and sum is
// rounded as OpenJPEG's SIMD lanes round it. `utils/jpeg2000.py` holds the
// plain versions (`t1_reference`, `idwt53_reference`, `idwt97_reference`,
// `mct_reference`).

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

namespace {

struct J2kError {
  std::string msg;
};

// The MQ coder's probability states: Qe, next index after an MPS, after an
// LPS, and whether an LPS switches the MPS.
const uint32_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
    0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
    0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
    0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t kNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                           17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                           33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                           15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                           30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

enum { CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, N_CTX = 19 };

enum : uint32_t {  // code-block style bits (COD / COC SPcod)
  STY_LAZY = 1, STY_RESET = 2, STY_TERMALL = 4, STY_VSC = 8, STY_PTERM = 16, STY_SEGSYM = 32
};

struct Mq {
  const uint8_t* bp;
  uint32_t a, c, ct;
  uint8_t state[N_CTX], mps[N_CTX];

  void reset_states() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[0] = 4;
  }
  // `p` points at a segment followed by two 0xFF bytes.
  void byte_in() {
    if (*bp == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += static_cast<uint32_t>(*bp) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += static_cast<uint32_t>(*bp) << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* p) {
    bp = p;
    c = static_cast<uint32_t>(*bp) << 16;
    byte_in();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) byte_in();
      a <<= 1;
      c <<= 1;
      --ct;
    } while ((a & 0x8000) == 0);
  }
  uint32_t decode(int cx) {
    uint32_t i = state[cx], qe = kQe[i], d;
    a -= qe;
    if ((c >> 16) < qe) {  // LPS exchange
      if (a < qe) {
        a = qe;
        d = mps[cx];
        state[cx] = kNmps[i];
      } else {
        a = qe;
        d = 1 - mps[cx];
        if (kSwitch[i]) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
        state[cx] = kNlps[i];
      }
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {  // MPS exchange
        if (a < qe) {
          d = 1 - mps[cx];
          if (kSwitch[i]) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
          state[cx] = kNlps[i];
        } else {
          d = mps[cx];
          state[cx] = kNmps[i];
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // Bypass (raw) bits, with the 0xFF bit stuffing.
  void raw_init(const uint8_t* p) {
    bp = p;
    c = 0;
    ct = 0;
  }
  uint32_t raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (*bp > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1U;
  }
};

enum : uint8_t { F_SIG = 1, F_NEG = 2, F_VISIT = 4, F_REFINED = 8 };

struct T1 {
  int w, h, orient;
  bool vsc;
  std::vector<int32_t> data;
  std::vector<uint8_t> flags;  // (w + 2) x (h + 2), one sample of border
  Mq mq;

  uint8_t& flag(int x, int y) { return flags[(y + 1) * (w + 2) + x + 1]; }
  int32_t& value(int x, int y) { return data[y * w + x]; }
  // Whether the row below (x, y) is part of its context: not for the last
  // row of a stripe in vertically causal mode.
  bool south(int y) const { return !(vsc && (y & 3) == 3); }
  int sig(int x, int y) { return flag(x, y) & F_SIG; }

  int zc_context(int x, int y) {
    bool s = south(y);
    int hh = sig(x - 1, y) + sig(x + 1, y);
    int vv = sig(x, y - 1) + (s ? sig(x, y + 1) : 0);
    int dd = sig(x - 1, y - 1) + sig(x + 1, y - 1) + (s ? sig(x - 1, y + 1) + sig(x + 1, y + 1) : 0);
    if (orient == 1) std::swap(hh, vv);
    if (orient == 3) {
      int hv = hh + vv;
      if (dd >= 3) return 8;
      if (dd == 2) return hv >= 1 ? 7 : 6;
      if (dd == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
      return hv >= 2 ? 2 : hv;
    }
    if (hh == 2) return 8;
    if (hh == 1) return vv >= 1 ? 7 : dd >= 1 ? 6 : 5;
    if (vv == 2) return 4;
    if (vv == 1) return 3;
    return dd >= 2 ? 2 : dd;
  }
  bool any_neighbour(int x, int y) {
    bool s = south(y);
    return sig(x - 1, y - 1) | sig(x, y - 1) | sig(x + 1, y - 1) | sig(x - 1, y) | sig(x + 1, y) |
           (s ? sig(x - 1, y + 1) | sig(x, y + 1) | sig(x + 1, y + 1) : 0);
  }
  int chi(int x, int y) {
    uint8_t f = flag(x, y);
    return (f & F_SIG) ? ((f & F_NEG) ? -1 : 1) : 0;
  }
  // Sign context (Table D.3) and the bit it is XORed with.
  void sc_context(int x, int y, int* ctx, int* xorbit) {
    int hc = std::clamp(chi(x - 1, y) + chi(x + 1, y), -1, 1);
    int vc = std::clamp(chi(x, y - 1) + (south(y) ? chi(x, y + 1) : 0), -1, 1);
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
      *xorbit = 1;
    } else if (hc == 0 && vc < 0) {
      vc = -vc;
      *xorbit = 1;
    } else {
      *xorbit = 0;
    }
    // (hc, vc) now (1, 1) 13, (1, 0) 12, (1, -1) 11, (0, 1) 10, (0, 0) 9.
    *ctx = CTX_SC + (hc ? 3 + vc : vc);
  }
  void set_significant(int x, int y, uint32_t negative, int32_t magnitude) {
    value(x, y) = negative ? -magnitude : magnitude;
    flag(x, y) |= static_cast<uint8_t>(F_SIG | (negative ? F_NEG : 0));
  }
  void decode_sign(int x, int y, int32_t oneplushalf) {
    int ctx, xorbit;
    sc_context(x, y, &ctx, &xorbit);
    set_significant(x, y, mq.decode(ctx) ^ static_cast<uint32_t>(xorbit), oneplushalf);
  }

  void sigpass(int bpno, bool raw) {
    int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          uint8_t& f = flag(x, y);
          if ((f & (F_SIG | F_VISIT)) || !any_neighbour(x, y)) continue;
          if (raw) {
            if (mq.raw()) set_significant(x, y, mq.raw(), oneplushalf);
          } else if (mq.decode(zc_context(x, y))) {
            decode_sign(x, y, oneplushalf);
          }
          f |= F_VISIT;
        }
  }
  void refpass(int bpno, bool raw) {
    int32_t poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          uint8_t& f = flag(x, y);
          if ((f & (F_SIG | F_VISIT)) != F_SIG) continue;
          uint32_t v;
          if (raw) {
            v = mq.raw();
          } else {
            int ctx = (f & F_REFINED) ? CTX_MAG + 2 : any_neighbour(x, y) ? CTX_MAG + 1 : CTX_MAG;
            v = mq.decode(ctx);
          }
          int32_t& d = value(x, y);
          d += (v ^ static_cast<uint32_t>(d < 0)) ? poshalf : -poshalf;
          f |= F_REFINED;
        }
  }
  void clnpass(int bpno, bool segsym) {
    int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        int y = k, end = std::min(k + 4, h);
        if (k + 3 < h) {
          bool run = true;
          for (int j = k; j < k + 4 && run; ++j)
            run = !(flag(x, j) & (F_SIG | F_VISIT)) && !any_neighbour(x, j);
          if (run) {
            if (!mq.decode(CTX_AGG)) continue;
            int r = static_cast<int>(mq.decode(CTX_UNI) << 1);
            r |= static_cast<int>(mq.decode(CTX_UNI));
            y = k + r;
            decode_sign(x, y, oneplushalf);
            ++y;
          }
        }
        for (; y < end; ++y) {
          if (flag(x, y) & (F_SIG | F_VISIT)) continue;
          if (mq.decode(zc_context(x, y))) decode_sign(x, y, oneplushalf);
        }
      }
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) flag(x, y) &= static_cast<uint8_t>(~F_VISIT);
    if (segsym)
      for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
  }
};

struct Segment {
  int32_t offset, length, passes;
};

// One code-block: OpenJPEG's opj_t1_decode_cblk over its segments, then its
// ROI shift. `bpno_plus_one` counts down from the top coded plane.
void decode_cblk(T1& t1, const uint8_t* data, int64_t size, const Segment* segs, int nsegs,
                 int bpno_plus_one, uint32_t sty, int roishift) {
  if (bpno_plus_one >= 31) throw J2kError{"a code-block of 31 or more bit-planes"};
  std::fill(t1.data.begin(), t1.data.end(), 0);
  std::fill(t1.flags.begin(), t1.flags.end(), 0);
  t1.mq.reset_states();
  const int numbps = bpno_plus_one - roishift;
  int passtype = 2;
  std::vector<uint8_t> buf;
  for (int s = 0; s < nsegs; ++s) {
    const Segment& seg = segs[s];
    if (seg.offset < 0 || seg.length < 0 || seg.offset + static_cast<int64_t>(seg.length) > size)
      throw J2kError{"a code-block segment outside the tile's data"};
    buf.assign(data + seg.offset, data + seg.offset + seg.length);
    buf.push_back(0xFF);
    buf.push_back(0xFF);
    bool raw = bpno_plus_one <= numbps - 4 && passtype < 2 && (sty & STY_LAZY);
    if (raw)
      t1.mq.raw_init(buf.data());
    else
      t1.mq.init(buf.data());
    for (int p = 0; p < seg.passes && bpno_plus_one >= 1; ++p) {
      if (passtype == 0)
        t1.sigpass(bpno_plus_one, raw);
      else if (passtype == 1)
        t1.refpass(bpno_plus_one, raw);
      else
        t1.clnpass(bpno_plus_one, (sty & STY_SEGSYM) != 0);
      if ((sty & STY_RESET) && !raw) t1.mq.reset_states();
      if (++passtype == 3) {
        passtype = 0;
        --bpno_plus_one;
      }
    }
  }
  if (roishift) {
    if (roishift >= 31) {
      std::fill(t1.data.begin(), t1.data.end(), 0);
    } else {
      int32_t thresh = 1 << roishift;
      for (int32_t& v : t1.data) {
        int32_t mag = std::abs(v);
        if (mag >= thresh) {
          mag >>= roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
  }
}

// ---- wavelets --------------------------------------------------------------------------

// One line of the inverse 5/3, deinterleaved in `a` (sn low-pass samples,
// then dn high-pass), interleaved in place; `cas` is the parity of the
// line's first coordinate.
void idwt53_line(int32_t* a, int sn, int dn, int cas, std::vector<int32_t>& tmp) {
  int n = sn + dn;
  if (n == 1) {
    if (cas) a[0] /= 2;
    return;
  }
  tmp.resize(n);
  int32_t* x = tmp.data();
  for (int i = 0; i < sn; ++i) x[2 * i + cas] = a[i];
  for (int i = 0; i < dn; ++i) x[2 * i + 1 - cas] = a[sn + i];
  auto at = [&](int k) { return x[k < 0 ? -k : k >= n ? 2 * (n - 1) - k : k]; };
  for (int k = cas; k < n; k += 2) x[k] -= (at(k - 1) + at(k + 1) + 2) >> 2;
  for (int k = 1 - cas; k < n; k += 2) x[k] += (at(k - 1) + at(k + 1)) >> 1;
  std::memcpy(a, x, sizeof(int32_t) * n);
}

const float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f,
            kDelta = 0.443506852f, kK = 1.230174105f;
const float kTwoInvK = 1.625732422f;

// OpenJPEG's opj_v8dwt_decode_step2 on one lane: x[t] += (left + right) * c
// for the targets `first`, `first` + 2, ...; `m` targets have two
// neighbours, the one after them (if `m` < `count`) only its left twice.
void lift(float* x, int first, int count, int m, float c) {
  for (int i = 0; i < m; ++i) {
    int t = first + 2 * i;
    float l = x[t == 0 ? 1 : t - 1];
    x[t] = x[t] + ((l + x[t + 1]) * c);
  }
  if (m < count) {
    int t = first + 2 * m;
    x[t] = x[t] + (x[t - 1] * (c + c));
  }
}

void idwt97_line(float* a, int sn, int dn, int cas, std::vector<float>& tmp) {
  int n = sn + dn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  tmp.resize(n);
  float* x = tmp.data();
  int lo = cas, hi = 1 - cas;
  for (int i = 0; i < sn; ++i) x[2 * i + lo] = a[i];
  for (int i = 0; i < dn; ++i) x[2 * i + hi] = a[sn + i];
  for (int i = 0; i < sn; ++i) x[2 * i + lo] = x[2 * i + lo] * kK;
  for (int i = 0; i < dn; ++i) x[2 * i + hi] = x[2 * i + hi] * kTwoInvK;
  int ml = std::min(sn, dn - lo), mh = std::min(dn, sn - hi);
  lift(x, lo, sn, ml, -kDelta);
  lift(x, hi, dn, mh, -kGamma);
  lift(x, lo, sn, ml, -kBeta);
  lift(x, hi, dn, mh, -kAlpha);
  std::memcpy(a, x, sizeof(float) * n);
}

template <typename T, typename Line>
void idwt(T* buf, int64_t stride, const int32_t* res, int nres, Line line) {
  std::vector<T> col, tmp;
  for (int r = 1; r < nres; ++r) {
    const int32_t* lower = res + 4 * (r - 1);
    const int32_t* cur = res + 4 * r;
    int rw = cur[2] - cur[0], rh = cur[3] - cur[1];
    int sw = lower[2] - lower[0], sh = lower[3] - lower[1];
    int cas_h = cur[0] & 1, cas_v = cur[1] & 1;
    if (rw <= 0 || rh <= 0) continue;
    for (int j = 0; j < rh; ++j) line(buf + j * stride, sw, rw - sw, cas_h, tmp);
    col.resize(rh);
    for (int i = 0; i < rw; ++i) {
      for (int j = 0; j < rh; ++j) col[j] = buf[j * stride + i];
      line(col.data(), sh, rh - sh, cas_v, tmp);
      for (int j = 0; j < rh; ++j) buf[j * stride + i] = col[j];
    }
  }
}

// One code-block's descriptor (see w3d_j2k_t1) into `out`.
void decode_one(T1& t1, const uint8_t* data, int64_t size, const int32_t* cb, const int32_t* segs,
                float step, void* out, int64_t stride, int32_t reversible) {
  int x0 = cb[0], y0 = cb[1];
  t1.w = cb[2];
  t1.h = cb[3];
  t1.orient = cb[4];
  uint32_t sty = static_cast<uint32_t>(cb[5]);
  t1.vsc = (sty & STY_VSC) != 0;
  if (t1.w <= 0 || t1.h <= 0) return;
  if (t1.w > 1024 || t1.h > 1024 || t1.w * t1.h > 4096)
    throw J2kError{"a code-block over 4096 samples"};
  t1.data.assign(static_cast<size_t>(t1.w) * t1.h, 0);
  t1.flags.assign(static_cast<size_t>(t1.w + 2) * (t1.h + 2), 0);
  decode_cblk(t1, data, size, reinterpret_cast<const Segment*>(segs + 3 * cb[8]), cb[9], cb[6], sty,
              cb[7]);
  for (int y = 0; y < t1.h; ++y) {
    const int32_t* src = t1.data.data() + static_cast<size_t>(y) * t1.w;
    if (reversible) {
      int32_t* dst = static_cast<int32_t*>(out) + (y0 + y) * stride + x0;
      for (int x = 0; x < t1.w; ++x) dst[x] = src[x] / 2;
    } else {
      float* dst = static_cast<float*>(out) + (y0 + y) * stride + x0;
      for (int x = 0; x < t1.w; ++x) dst[x] = static_cast<float>(src[x]) * step;
    }
  }
}

void set_msg(char* msg, int32_t len, const std::string& s) {
  if (msg && len > 0) snprintf(msg, static_cast<size_t>(len), "%s", s.c_str());
}

}  // namespace

extern "C" {

int w3d_j2k_t1(const uint8_t* data, int64_t size, const int32_t* cblks, int32_t n,
               const int32_t* segs, const float* steps, void* out, int64_t stride,
               int32_t reversible, char* msg, int32_t msg_len) {
  // Code-blocks write disjoint samples: threads take them one at a time.
  std::atomic<int32_t> next{0};
  std::mutex lock;
  std::string error;
  auto work = [&]() {
    T1 t1;
    try {
      for (int32_t i = next++; i < n; i = next++) {
        decode_one(t1, data, size, cblks + 10 * i, segs, steps[i], out, stride, reversible);
      }
    } catch (const J2kError& e) {
      std::lock_guard<std::mutex> g(lock);
      if (error.empty()) error = e.msg;
      next = n;
    }
  };
  int threads = static_cast<int>(std::min<int64_t>(
      std::max(1u, std::thread::hardware_concurrency()), std::min<int64_t>(8, 1 + n / 16)));
  std::vector<std::thread> pool;
  try {
    for (int k = 1; k < threads; ++k) pool.emplace_back(work);
  } catch (const std::system_error&) {  // no threads to be had: this one does it all
  }
  work();
  for (auto& t : pool) t.join();
  if (!error.empty()) {
    set_msg(msg, msg_len, error);
    return -1;
  }
  return 0;
}

int w3d_j2k_idwt(void* buf, int64_t stride, const int32_t* res, int32_t nres, int32_t reversible) {
  if (reversible)
    idwt(static_cast<int32_t*>(buf), stride, res, nres, idwt53_line);
  else
    idwt(static_cast<float*>(buf), stride, res, nres, idwt97_line);
  return 0;
}

int w3d_j2k_mct(void* c0, void* c1, void* c2, int64_t n, int32_t reversible) {
  if (reversible) {
    int32_t *y = static_cast<int32_t*>(c0), *u = static_cast<int32_t*>(c1),
            *v = static_cast<int32_t*>(c2);
    for (int64_t i = 0; i < n; ++i) {
      int32_t g = y[i] - ((u[i] + v[i]) >> 2);
      int32_t r = v[i] + g, b = u[i] + g;
      y[i] = r;
      u[i] = g;
      v[i] = b;
    }
  } else {
    float *y = static_cast<float*>(c0), *u = static_cast<float*>(c1), *v = static_cast<float*>(c2);
    for (int64_t i = 0; i < n; ++i) {
      float r = y[i] + (v[i] * 1.402f);
      float g = (y[i] - (u[i] * 0.34413f)) - (v[i] * 0.71414f);
      float b = y[i] + (u[i] * 1.772f);
      y[i] = r;
      u[i] = g;
      v[i] = b;
    }
  }
  return 0;
}

int w3d_j2k_level(const void* buf, int64_t n, int32_t reversible, int32_t shift, int32_t lo,
                  int32_t hi, int32_t* out) {
  if (reversible) {
    const int32_t* in = static_cast<const int32_t*>(buf);
    for (int64_t i = 0; i < n; ++i) out[i] = std::clamp(in[i] + shift, lo, hi);
  } else {
    const float* in = static_cast<const float*>(buf);
    for (int64_t i = 0; i < n; ++i) {
      float f = in[i];
      if (f > static_cast<float>(INT_MAX)) {
        out[i] = hi;
      } else if (f < static_cast<float>(INT_MIN)) {
        out[i] = lo;
      } else {
        int64_t v = static_cast<int64_t>(std::lrintf(f)) + shift;
        out[i] = static_cast<int32_t>(std::clamp<int64_t>(v, lo, hi));
      }
    }
  }
  return 0;
}

}  // extern "C"
