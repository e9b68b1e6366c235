// Hand-written Hopper (sm_90a) kernels for the Ed25519 curve layer:
// windowed and ladder scalar multiplication, the window-sum MSM core, and
// the bucketed Pippenger accumulate and reduce.
//
// They replace the Pallas TPU kernels windowed_mul_pallas, ladder_pallas
// and window_sums_pallas (ark_mpc_tpu/ops/curve_kernels.py) and
// bucket_accumulate_pallas and bucket_reduce_pallas
// (ark_mpc_tpu/ops/msm_kernels.py).  Source notes per kernel are in the
// Python wrappers (ops/curve_kernels.py, ops/msm_kernels.py).
//
// Base field p = 2^255 - 19 on eight 32-bit words: a product is a 512-bit
// schoolbook, the high half folded down x38 (2^256 = 38 mod p), then
// brought to CANONICAL form, as are sums and differences (the quad core of
// windowed_mul and window_sums, the ladder and bucket_reduce keep values
// loose and canonicalize at their store; the ladder's and bucket_reduce's
// products run on PTX carry chains).  Canonical values are unique, so running the reference's formula
// sequence (twisted Edwards a = -1, extended coordinates) gives results
// bit-identical to the plain torch versions.
//
// Device-memory layout is the reference's: a coordinate is a (16, n) int32
// tensor of 16-bit limbs, repacked to 32-bit words in registers.  Only
// bucket_accumulate's inputs and partial sums are (rows, 4, 8) words, one
// 128-byte line a point, which its wrapper packs.
//
// Plain C interface (loaded with ctypes): every entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 8;        // 32-bit words per field element
constexpr int NLIMBS = 16;   // 16-bit limbs per field element in memory
constexpr int BUCKET_THREADS = 128;

struct Fe {
  uint32_t w[NW];
};
struct Pt {
  Fe x, y, z, t;
};
// 2d, d = -121665/121666 mod p
__device__ __forceinline__ Fe fe_d2() {
  return Fe{{0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au, 0xeef3d130u,
             0x198e80f2u, 0x56dffce7u, 0x2406d9dcu}};
}

__device__ __forceinline__ Fe fe_zero() { return Fe{{0, 0, 0, 0, 0, 0, 0, 0}}; }
__device__ __forceinline__ Fe fe_one() { return Fe{{1, 0, 0, 0, 0, 0, 0, 0}}; }

__device__ __forceinline__ Pt pt_identity() {
  return Pt{fe_zero(), fe_one(), fe_one(), fe_zero()};
}

// ---------------------------------------------------------------------------
// memory: (16, n) int32 limbs <-> words
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fe fe_load(const int32_t* __restrict__ p,
                                      int64_t stride, int64_t j) {
  Fe r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t lo = static_cast<uint32_t>(__ldg(p + (2 * k) * stride + j));
    const uint32_t hi = static_cast<uint32_t>(__ldg(p + (2 * k + 1) * stride + j));
    r.w[k] = lo | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* p, int64_t stride, int64_t j,
                                         const Fe& a) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    p[(2 * k) * stride + j] = static_cast<int32_t>(a.w[k] & 0xFFFFu);
    p[(2 * k + 1) * stride + j] = static_cast<int32_t>(a.w[k] >> 16);
  }
}

// Four coordinate arrays of one point batch.
struct Coords {
  const int32_t* c[4];
};
struct OutCoords {
  int32_t* c[4];
};

__device__ __forceinline__ Pt pt_load(const Coords& p, int64_t stride,
                                      int64_t j) {
  return Pt{fe_load(p.c[0], stride, j), fe_load(p.c[1], stride, j),
            fe_load(p.c[2], stride, j), fe_load(p.c[3], stride, j)};
}

__device__ __forceinline__ void pt_store(const OutCoords& o, int64_t offset,
                                         int64_t stride, int64_t j,
                                         const Pt& a) {
  fe_store(o.c[0] + offset, stride, j, a.x);
  fe_store(o.c[1] + offset, stride, j, a.y);
  fe_store(o.c[2] + offset, stride, j, a.z);
  fe_store(o.c[3] + offset, stride, j, a.t);
}

// ---------------------------------------------------------------------------
// base field p = 2^255 - 19, canonical in and out
// ---------------------------------------------------------------------------

// r += k (k < 2^32) with carry over the 8 words; returns the carry out.
__device__ __forceinline__ uint32_t fe_add_small(Fe& r, uint32_t k) {
  uint64_t c = k;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t s = static_cast<uint64_t>(r.w[i]) + c;
    r.w[i] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  return static_cast<uint32_t>(c);
}

// Any r < 2^256 -> r mod p.
__device__ __forceinline__ Fe fe_canon(Fe r) {
  const uint32_t top = r.w[7] >> 31;
  r.w[7] &= 0x7FFFFFFFu;
  fe_add_small(r, 19u * top);  // now r < 2^255 + 19
  Fe u = r;
  fe_add_small(u, 19u);  // r >= p  <=>  r + 19 >= 2^255
  const uint32_t ge = 0u - (u.w[7] >> 31);
  u.w[7] &= 0x7FFFFFFFu;
  Fe out;
#pragma unroll
  for (int i = 0; i < NW; ++i) out.w[i] = (u.w[i] & ge) | (r.w[i] & ~ge);
  return out;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t v = static_cast<uint64_t>(a.w[i]) + b.w[i] + c;
    s.w[i] = static_cast<uint32_t>(v);
    c = v >> 32;
  }
  return fe_canon(s);  // a + b < 2p < 2^256
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t v = static_cast<uint64_t>(a.w[i]) - b.w[i] - borrow;
    d.w[i] = static_cast<uint32_t>(v);
    borrow = (v >> 32) & 1u;
  }
  // add p back where a < b: p = 2^255 - 19 = (2^255 - 1) - 18
  const uint32_t m = 0u - static_cast<uint32_t>(borrow);
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t pw = (i == 0) ? 0xFFFFFFEDu : (i == 7 ? 0x7FFFFFFFu : 0xFFFFFFFFu);
    const uint64_t v = static_cast<uint64_t>(d.w[i]) + (pw & m) + c;
    d.w[i] = static_cast<uint32_t>(v);
    c = v >> 32;
  }
  return d;
}

// r + c * 2^256 (c <= 38) folded below 2^256: 2^256 = 38 mod p, and a
// carry out of the first fold leaves r < 38 * 38, so the second cannot.
__device__ __forceinline__ void fe_fold38(Fe& r, uint32_t c) {
  const uint32_t c2 = fe_add_small(r, c * 38u);
  r.w[0] += 38u * c2;
}

// A 512-bit t mod p below 2^256: lo + 38 hi < 39 * 2^256, then fold again.
__device__ __forceinline__ Fe fe_reduce_wide(const uint32_t t[2 * NW]) {
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint64_t s = static_cast<uint64_t>(t[k]) + 38ull * t[k + NW] + c;
    r.w[k] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  fe_fold38(r, static_cast<uint32_t>(c));  // c <= 38
  return r;
}

// a * b mod p below 2^256, for any a, b < 2^256 (not canonical).
__device__ __forceinline__ Fe fe_mul_loose(const Fe& a, const Fe& b) {
  uint32_t t[2 * NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t s = static_cast<uint64_t>(a.w[j]) * b.w[i] + t[i + j] + c;
      t[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    t[i + NW] = static_cast<uint32_t>(c);
  }
  return fe_reduce_wide(t);
}

__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  return fe_canon(fe_mul_loose(a, b));
}

// a^2 mod p below 2^256, for any a < 2^256: the 28 cross products once,
// doubled, plus the 8 squares (36 word products against 64).
__device__ __forceinline__ Fe fe_sqr_loose(const Fe& a) {
  uint32_t t[2 * NW];
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < NW; ++j) {
      const uint64_t s = static_cast<uint64_t>(a.w[j]) * a.w[i] + t[i + j] + c;
      t[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    t[i + NW] = static_cast<uint32_t>(c);
  }
  // double the cross products (their sum is below 2^511)
#pragma unroll
  for (int k = 2 * NW - 1; k > 0; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t s = static_cast<uint64_t>(a.w[i]) * a.w[i] + t[2 * i] + c;
    t[2 * i] = static_cast<uint32_t>(s);
    const uint64_t u = static_cast<uint64_t>(t[2 * i + 1]) + (s >> 32);
    t[2 * i + 1] = static_cast<uint32_t>(u);
    c = u >> 32;
  }
  return fe_reduce_wide(t);
}

// Loose sums and differences: any a, b < 2^256 in, a value below 2^256
// congruent mod p out.
__device__ __forceinline__ Fe fe_add_loose(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t v = static_cast<uint64_t>(a.w[i]) + b.w[i] + c;
    s.w[i] = static_cast<uint32_t>(v);
    c = v >> 32;
  }
  fe_fold38(s, static_cast<uint32_t>(c));
  return s;
}

__device__ __forceinline__ Fe fe_sub_loose(const Fe& a, const Fe& b) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t v = static_cast<uint64_t>(a.w[i]) - b.w[i] - borrow;
    d.w[i] = static_cast<uint32_t>(v);
    borrow = (v >> 32) & 1u;
  }
  // a borrow left d = a - b + 2^256 = a - b + 38 mod p: take 38 off; if that
  // wraps too (d < 38), d is now above 2^256 - 38 and takes 38 off again
  uint64_t b2 = 38u & (0u - static_cast<uint32_t>(borrow));
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t v = static_cast<uint64_t>(d.w[i]) - b2;
    d.w[i] = static_cast<uint32_t>(v);
    b2 = (v >> 32) & 1u;
  }
  d.w[0] -= 38u * static_cast<uint32_t>(b2);
  return d;
}

// ---------------------------------------------------------------------------
// Products on PTX carry chains (the ladder's): each primitive below is one
// PTX instruction; .cc sets the carry flag and madc/addc add it in, so the
// carries ride on the multiply-adds instead of 64-bit sums.  The asm
// statements are volatile, which keeps them in program order: the flag
// lives between them.
// ---------------------------------------------------------------------------

#define ARK_PTX3(name, op)                                                    \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c) { \
    uint32_t r;                                                               \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));   \
    return r;                                                                 \
  }
#define ARK_PTX2(name, op)                                                    \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {          \
    uint32_t r;                                                               \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));               \
    return r;                                                                 \
  }
ARK_PTX3(mad_lo_cc, "mad.lo.cc.u32")
ARK_PTX3(mad_hi_cc, "mad.hi.cc.u32")
ARK_PTX3(madc_lo_cc, "madc.lo.cc.u32")
ARK_PTX3(madc_hi_cc, "madc.hi.cc.u32")
ARK_PTX3(madc_hi, "madc.hi.u32")
ARK_PTX2(add_cc, "add.cc.u32")
ARK_PTX2(addc_cc, "addc.cc.u32")
ARK_PTX2(addc, "addc.u32")
#undef ARK_PTX3
#undef ARK_PTX2

// One chain of a schoolbook row: acc[j .. j + 1] += a[j] * b for j =
// first, first + 2, .. <= last (pairs that do not overlap).  If the top word
// acc[last + 1] held a value (`capture`), the chain's carry goes into
// acc[last + 2], zero before; otherwise the top word was zero and no carry
// leaves it (a high half is at most 2^32 - 2).
__device__ __forceinline__ void chain_cc(uint32_t* acc, const uint32_t* a, uint32_t b,
                                         int first, int last, bool capture) {
  acc[first] = mad_lo_cc(a[first], b, acc[first]);
#pragma unroll
  for (int j = first; j < last; j += 2) {
    acc[j + 1] = madc_hi_cc(a[j], b, acc[j + 1]);
    acc[j + 2] = madc_lo_cc(a[j + 2], b, acc[j + 2]);
  }
  if (capture) {
    acc[last + 1] = madc_hi_cc(a[last], b, acc[last + 1]);
    acc[last + 2] = addc(0u, 0u);
  } else {
    acc[last + 1] = madc_hi(a[last], b, acc[last + 1]);
  }
}

// Row i of a schoolbook into e and o by absolute word: the products a[j] b
// (j in first .. 7) whose low word i + j is even go to e, the others to o.
// So every (lo, hi) pair starts at an even word of e or an odd word of o in
// every row, and each product is one 64-bit multiply-add into an aligned
// register pair (the pairing shifting by a word a row cost ~600 register
// moves a ladder step).  Row i's e chain ends at word i + 7 if i is even,
// i + 8 if odd, its o chain the other way round: an even row's e chain and
// an odd row's o chain end where the row before ended the same array, and
// capture their carry one word up; the other chains end on a word no row
// reached.
__device__ __forceinline__ void row_cc(uint32_t* e, uint32_t* o, const uint32_t* a,
                                       uint32_t b, int i, int first) {
  const int odd = i & 1;
  const int fe = first + ((first ^ i) & 1), le = odd ? NW - 1 : NW - 2;  // j = i mod 2
  const int fo = first + ((first ^ i ^ 1) & 1), lo = odd ? NW - 2 : NW - 1;
  if (fe <= le) chain_cc(e + i, a, b, fe, le, !odd && i > 0);
  if (fo <= lo) chain_cc(o + i, a, b, fo, lo, odd);
}

// t = e + o over words 1 .. 15 (e[0] alone); the sum fits 512 bits.
__device__ __forceinline__ void merge_cc(uint32_t t[2 * NW], const uint32_t e[2 * NW],
                                         const uint32_t o[2 * NW]) {
  t[0] = e[0];
  t[1] = add_cc(e[1], o[1]);
#pragma unroll
  for (int k = 2; k < 2 * NW - 1; ++k) t[k] = addc_cc(e[k], o[k]);
  t[2 * NW - 1] = addc(e[2 * NW - 1], o[2 * NW - 1]);
}

// r = t_lo + 38 t_hi (< 39 * 2^256, = t mod p): the low halves of 38 t[8 + k]
// on one chain with t[k], the high halves one word up on a second, the top
// word (<= 38) then folded in again.
__device__ __forceinline__ Fe reduce_cc(const uint32_t t[2 * NW]) {
  Fe r;
  r.w[0] = mad_lo_cc(t[NW], 38u, t[0]);
#pragma unroll
  for (int k = 1; k < NW; ++k) r.w[k] = madc_lo_cc(t[NW + k], 38u, t[k]);
  uint32_t top = addc(0u, 0u);
  r.w[1] = mad_hi_cc(t[NW], 38u, r.w[1]);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) r.w[k + 1] = madc_hi_cc(t[NW + k], 38u, r.w[k + 1]);
  top = madc_hi(t[2 * NW - 1], 38u, top);
  fe_fold38(r, top);
  return r;
}

// a * b mod p below 2^256, for any a, b < 2^256 (not canonical): rows
// a[j] b[i] on two chains each (`row_cc`), then t = e + o and the fold.
__device__ __forceinline__ Fe fe_mul_cc(const Fe& a, const Fe& b) {
  uint32_t e[2 * NW], o[2 * NW], t[2 * NW];
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) e[k] = o[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) row_cc(e, o, a.w, b.w[i], i, 0);
  merge_cc(t, e, o);
  return reduce_cc(t);
}

// a^2 mod p below 2^256, for any a < 2^256: the cross products a[j] a[i],
// j > i, in fe_mul_cc's rows, merged and doubled, then the squares a[i]^2
// at words 2i, 2i + 1 on one chain.
__device__ __forceinline__ Fe fe_sqr_cc(const Fe& a) {
  uint32_t e[2 * NW], o[2 * NW], t[2 * NW];
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) e[k] = o[k] = 0;
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) row_cc(e, o, a.w, a.w[i], i, i + 1);
  merge_cc(t, e, o);  // the cross products: below 2^511
#pragma unroll
  for (int k = 2 * NW - 1; k > 0; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[0] <<= 1;
  t[0] = mad_lo_cc(a.w[0], a.w[0], t[0]);
  t[1] = madc_hi_cc(a.w[0], a.w[0], t[1]);
#pragma unroll
  for (int i = 1; i < NW - 1; ++i) {
    t[2 * i] = madc_lo_cc(a.w[i], a.w[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a.w[i], a.w[i], t[2 * i + 1]);
  }
  t[2 * NW - 2] = madc_lo_cc(a.w[NW - 1], a.w[NW - 1], t[2 * NW - 2]);
  t[2 * NW - 1] = madc_hi(a.w[NW - 1], a.w[NW - 1], t[2 * NW - 1]);
  return reduce_cc(t);
}

// The products a formula runs on: the C++ 64-bit sums or the carry chains.
struct CxxProducts {
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
    return fe_mul_loose(a, b);
  }
  static __device__ __forceinline__ Fe sqr(const Fe& a) { return fe_sqr_loose(a); }
};
struct CcProducts {
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) { return fe_mul_cc(a, b); }
  static __device__ __forceinline__ Fe sqr(const Fe& a) { return fe_sqr_cc(a); }
};

// ---------------------------------------------------------------------------
// Edwards formulas: the reference's _double, _double_no_t and _padd
// (ark_mpc_tpu/ops/curve_kernels.py:45-99)
// ---------------------------------------------------------------------------

struct DoubleParts {
  Fe e, f, g, h;
};

__device__ __forceinline__ DoubleParts double_parts(const Fe& x, const Fe& y,
                                                    const Fe& z) {
  const Fe a = fe_mul(x, x);
  const Fe b = fe_mul(y, y);
  const Fe zz = fe_mul(z, z);
  const Fe c = fe_add(zz, zz);
  const Fe h = fe_add(a, b);
  const Fe xy = fe_add(x, y);
  const Fe e = fe_sub(h, fe_mul(xy, xy));
  const Fe g = fe_sub(a, b);
  const Fe f = fe_add(c, g);
  return DoubleParts{e, f, g, h};
}

__device__ __forceinline__ Pt pt_double(const Pt& p) {
  const DoubleParts d = double_parts(p.x, p.y, p.z);
  return Pt{fe_mul(d.e, d.f), fe_mul(d.g, d.h), fe_mul(d.f, d.g),
            fe_mul(d.e, d.h)};
}

// Doubling without the T output; p.t is left as it was (unused).
__device__ __forceinline__ void pt_double_no_t(Pt& p) {
  const DoubleParts d = double_parts(p.x, p.y, p.z);
  p.x = fe_mul(d.e, d.f);
  p.y = fe_mul(d.g, d.h);
  p.z = fe_mul(d.f, d.g);
}

__device__ __forceinline__ Pt finish_add(const Fe& a, const Fe& b, const Fe& c,
                                         const Fe& zz) {
  const Fe dd = fe_add(zz, zz);
  const Fe e = fe_sub(b, a);
  const Fe f = fe_sub(dd, c);
  const Fe g = fe_add(dd, c);
  const Fe h = fe_add(b, a);
  return Pt{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

__device__ __forceinline__ Pt pt_add(const Pt& p, const Pt& q) {
  const Fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  const Fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  const Fe c = fe_mul(fe_mul(p.t, q.t), fe_d2());
  const Fe zz = fe_mul(p.z, q.z);
  return finish_add(a, b, c, zz);
}

// ---------------------------------------------------------------------------
// The quad field core: four lanes per point.  The Edwards formulas are
// 4-way parallel (Hisil-Wong-Carter-Dawson 2008): a double is 4 squares,
// then 4 products; a cached add is 4 products, then 4.  Lane k of a quad
// computes product k of each stage and the quad shares the four results
// through a per-warp exchange buffer in shared memory; every lane then runs
// the stage's sums and differences on the full point itself.  The lane
// index k is public: it picks operands by selects, never the data.  A
// double's first stage squares (36 word products).  The products are the
// C++ ones (`CxxProducts`) unless a caller names the carry chains
// (`CcProducts`: bucket_reduce's Horner).
//
// Values stay loose (below 2^256, congruent mod p: `fe_mul_loose`,
// `fe_add_loose`, `fe_sub_loose`) and are brought to canonical form once,
// at the store.  The canonical form is unique, so the outputs are
// bit-identical to the canonical formulas of the other kernels.
// ---------------------------------------------------------------------------

constexpr int QUAD = 4;
// Exchange buffer of one warp: [half][lane k][quad q] 16-byte chunks, rows
// padded to 40 words, so a quarter-warp's stores hit 8 different bank
// groups and the 8 quads' loads of one lane's result fill one wavefront.
constexpr int XCH_ROW = 40;
constexpr int XCH_WARP_WORDS = 2 * QUAD * XCH_ROW;

struct Quad {
  uint32_t* xch;  // this warp's exchange buffer
  int q;          // quad within the warp, 0..7
  int k;          // lane within the quad, 0..3
};

// Value k of four, by selects (k is the lane's index in its quad).
__device__ __forceinline__ Fe fe_pick(int k, const Fe& v0, const Fe& v1,
                                      const Fe& v2, const Fe& v3) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    r.w[i] = k == 0 ? v0.w[i] : k == 1 ? v1.w[i] : k == 2 ? v2.w[i] : v3.w[i];
  }
  return r;
}

// v / 2 mod p for canonical v: (v + (v odd ? p : 0)) >> 1 < p.
__device__ __forceinline__ Fe fe_half(const Fe& v) {
  const uint32_t m = 0u - (v.w[0] & 1u);
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t pw = (i == 0) ? 0xFFFFFFEDu : (i == 7 ? 0x7FFFFFFFu : 0xFFFFFFFFu);
    const uint64_t x = static_cast<uint64_t>(v.w[i]) + (pw & m) + c;
    s.w[i] = static_cast<uint32_t>(x);
    c = x >> 32;
  }
  Fe r;  // v + p < 2^256: no carry out
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) r.w[i] = (s.w[i] >> 1) | (s.w[i + 1] << 31);
  r.w[NW - 1] = s.w[NW - 1] >> 1;
  return r;
}

// Lane k's product r, then all four lanes' products: out[j] is lane j's.
__device__ __forceinline__ void quad_share(const Quad& Q, const Fe& r, Fe out[QUAD]) {
  __syncwarp();  // every lane has read the previous stage's results
  uint4* lo = reinterpret_cast<uint4*>(Q.xch + Q.k * XCH_ROW) + Q.q;
  uint4* hi = reinterpret_cast<uint4*>(Q.xch + (QUAD + Q.k) * XCH_ROW) + Q.q;
  *lo = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  *hi = make_uint4(r.w[4], r.w[5], r.w[6], r.w[7]);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < QUAD; ++j) {
    const uint4 a0 = reinterpret_cast<const uint4*>(Q.xch + j * XCH_ROW)[Q.q];
    const uint4 a1 = reinterpret_cast<const uint4*>(Q.xch + (QUAD + j) * XCH_ROW)[Q.q];
    out[j] = Fe{{a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w}};
  }
}

// The second stage of a double or an add: X = e f, Y = g h, Z = f g, T = e h.
template <class Prod = CxxProducts>
__device__ __forceinline__ void quad_finish(const Quad& Q, const Fe& e, const Fe& f,
                                            const Fe& g, const Fe& h, Pt& p) {
  Fe r[QUAD];
  quad_share(Q, Prod::mul(fe_pick(Q.k, e, g, f, e), fe_pick(Q.k, f, h, g, h)), r);
  p = Pt{r[0], r[1], r[2], r[3]};
}

// p = 2 p (`double_parts`, then `pt_double`); reads X, Y, Z.  The T-less
// double is the same with T unused: lane 3 would idle otherwise.
template <class Prod = CxxProducts>
__device__ __forceinline__ void quad_double(const Quad& Q, Pt& p) {
  const Fe xy = fe_add_loose(p.x, p.y);
  const Fe op = fe_pick(Q.k, p.x, p.y, p.z, xy);
  Fe sq[QUAD];  // a = X^2, b = Y^2, zz = Z^2, (X + Y)^2
  quad_share(Q, Prod::sqr(op), sq);
  const Fe c = fe_add_loose(sq[2], sq[2]);
  const Fe h = fe_add_loose(sq[0], sq[1]);
  const Fe g = fe_sub_loose(sq[0], sq[1]);
  quad_finish<Prod>(Q, fe_sub_loose(h, sq[3]), fe_add_loose(c, g), g, h, p);
}

// p += q (the plain `_padd_cached`), lane k holding coordinate k of the
// cached q (Y - X, Y + X, 2d T, Z).
template <class Prod = CxxProducts>
__device__ __forceinline__ void quad_add_cached(const Quad& Q, Pt& p, const Fe& mine) {
  const Fe op = fe_pick(Q.k, fe_sub_loose(p.y, p.x), fe_add_loose(p.y, p.x), p.t, p.z);
  Fe r[QUAD];  // a, b, c, zz
  quad_share(Q, Prod::mul(op, mine), r);
  const Fe dd = fe_add_loose(r[3], r[3]);
  quad_finish<Prod>(Q, fe_sub_loose(r[1], r[0]), fe_sub_loose(dd, r[2]),
                    fe_add_loose(dd, r[2]), fe_add_loose(r[1], r[0]), p);
}

// ---------------------------------------------------------------------------
// windowed_mul: out = (s mod 2^(4 windows)) * P, one quad per point.
//
// Lane k keeps coordinate k of the 16 cached multiples 0..15 of P in
// shared memory: [entry][half][thread] 16-byte chunks, thread fastest, so a
// warp's loads of one (entry, half) are conflict-free (512 B a lane, 64 KiB
// for 128 threads).  The cached add needs exactly lane k's coordinate of
// the entry, taken by a masked scan over all 16 entries: the loads, their
// addresses and the branches are the same for every digit (the scalar may
// be a MAC-key share).  The digit comes from the lane holding its scalar
// word by a shuffle whose source depends on the window index only.
// ---------------------------------------------------------------------------

constexpr int WM_THREADS = 128;     // 32 points a block
constexpr int WM_MIN_BLOCKS = 3;    // 12 resident warps per SM: <= 168 registers
constexpr int WM_POINTS = WM_THREADS / QUAD;
constexpr int WM_ENTRIES = 16;
constexpr size_t WM_TAB_BYTES = static_cast<size_t>(WM_ENTRIES) * 2 * WM_THREADS * 16;
constexpr size_t WM_SMEM =
    WM_TAB_BYTES + static_cast<size_t>(WM_THREADS / 32) * XCH_WARP_WORDS * 4;

// Tables in shared memory: [entry][half][slot] 16-byte chunks, slot
// fastest, SLOTS slots a row; slot 4p + k holds coordinate k of point p's
// entries (windowed_mul: slot = thread).
template <int SLOTS>
__device__ __forceinline__ void tab_store(uint4* tab, int e, int s, const Fe& v) {
  tab[(2 * e) * SLOTS + s] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  tab[(2 * e + 1) * SLOTS + s] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

template <int SLOTS>
__device__ __forceinline__ Fe tab_load(const uint4* tab, int e, int s) {
  const uint4 a = tab[(2 * e) * SLOTS + s];
  const uint4 b = tab[(2 * e + 1) * SLOTS + s];
  return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

// Entry `digit` of slot s's coordinate by a masked scan over all 16.
template <int SLOTS>
__device__ __forceinline__ Fe tab_select(const uint4* tab, int s, uint32_t digit) {
  Fe r = fe_zero();
#pragma unroll
  for (int e = 0; e < WM_ENTRIES; ++e) {
    const uint32_t m = 0u - static_cast<uint32_t>(digit == static_cast<uint32_t>(e));
    const Fe v = tab_load<SLOTS>(tab, e, s);
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] |= v.w[i] & m;
  }
  return r;
}

// Lane k's cached coordinate of p, with T in place of 2d T (scaled later).
__device__ __forceinline__ Fe cached_coord(int k, const Pt& p) {
  return fe_pick(k, fe_sub_loose(p.y, p.x), fe_add_loose(p.y, p.x), p.t, p.z);
}

// X, Y, Z of entry e from the quad's table (slots base .. base + 3):
// X = (cq - cp) / 2, Y = (cq + cp) / 2, exact on canonical values; Z = cz.
template <int SLOTS>
__device__ __forceinline__ Pt tab_point(const uint4* tab, int base, int e) {
  const Fe cp = tab_load<SLOTS>(tab, e, base);
  const Fe cq = tab_load<SLOTS>(tab, e, base + 1);
  return Pt{fe_half(fe_canon(fe_sub_loose(cq, cp))),
            fe_half(fe_canon(fe_add_loose(cq, cp))),
            tab_load<SLOTS>(tab, e, base + 3), fe_zero()};
}

// The 16 multiples 0..15 of P in cached form (Y - X, Y + X, 2d T, Z), four
// ways, into slots s - k .. s - k + 3, in the reference's order: evens by
// doubling the half entry (read back from the table), odds by adding P's
// cached entry 1.  Entries 2..15 hold T in lane 2's slot until
// one pass scales them by 2d.
template <int SLOTS>
__device__ __forceinline__ void quad_build_table(const Quad& Q, uint4* tab, int s,
                                                 const Pt& P) {
  const int base = s & ~(QUAD - 1);
  tab_store<SLOTS>(tab, 0, s, fe_pick(Q.k, fe_one(), fe_one(), fe_zero(), fe_one()));
  tab_store<SLOTS>(tab, 1, s, fe_pick(Q.k, fe_sub_loose(P.y, P.x), fe_add_loose(P.y, P.x),
                                      fe_mul_loose(P.t, fe_d2()), P.z));
  Pt prev = P;
  for (int e = 2; e < WM_ENTRIES; ++e) {
    if (e & 1) {
      quad_add_cached(Q, prev, tab_load<SLOTS>(tab, 1, s));
    } else {
      __syncwarp();  // entry e / 2 is written
      prev = tab_point<SLOTS>(tab, base, e >> 1);
      quad_double(Q, prev);
    }
    tab_store<SLOTS>(tab, e, s, cached_coord(Q.k, prev));
  }
  __syncwarp();
  // lane k scales entries 2 + k, 6 + k, 10 + k, 14 + k
  for (int e = 2 + Q.k; e < WM_ENTRIES; e += QUAD) {
    tab_store<SLOTS>(tab, e, base + 2, fe_mul_loose(tab_load<SLOTS>(tab, e, base + 2), fe_d2()));
  }
  __syncwarp();
}

// Quads past n run on point n - 1 and skip the store: every lane reaches
// every __syncwarp and shuffle.
__global__ void __launch_bounds__(WM_THREADS, WM_MIN_BLOCKS)
windowed_mul_kernel(const int32_t* __restrict__ canon, Coords p, OutCoords o,
                    int64_t n, int windows) {
  extern __shared__ __align__(16) unsigned char wm_smem[];
  uint4* tab = reinterpret_cast<uint4*>(wm_smem);
  const int t = threadIdx.x;
  const Quad Q{reinterpret_cast<uint32_t*>(wm_smem + WM_TAB_BYTES) +
                   (t >> 5) * XCH_WARP_WORDS,
               (t & 31) >> 2, t & (QUAD - 1)};
  const int64_t point = static_cast<int64_t>(blockIdx.x) * WM_POINTS + (t >> 2);
  const int64_t j = point < n ? point : n - 1;
  // lane k holds scalar words 2k, 2k + 1: digits 16k .. 16k + 15
  const uint32_t s0 = static_cast<uint32_t>(__ldg(canon + (4 * Q.k) * n + j)) |
                      (static_cast<uint32_t>(__ldg(canon + (4 * Q.k + 1) * n + j)) << 16);
  const uint32_t s1 = static_cast<uint32_t>(__ldg(canon + (4 * Q.k + 2) * n + j)) |
                      (static_cast<uint32_t>(__ldg(canon + (4 * Q.k + 3) * n + j)) << 16);
  quad_build_table<WM_THREADS>(Q, tab, t, pt_load(p, n, j));
  const int src = (t & 31) & ~(QUAD - 1);
  Pt acc = pt_identity();
  for (int i = windows - 1; i >= 0; --i) {
    quad_double(Q, acc);
    quad_double(Q, acc);
    quad_double(Q, acc);
    quad_double(Q, acc);
    const uint32_t word = ((i >> 3) & 1) ? s1 : s0;
    const uint32_t digit = __shfl_sync(0xFFFFFFFFu, (word >> (4 * (i & 7))) & 15u,
                                       src + (i >> 4));
    quad_add_cached(Q, acc, tab_select<WM_THREADS>(tab, t, digit));
  }
  if (point < n) {
    int32_t* dst = Q.k == 0 ? o.c[0] : Q.k == 1 ? o.c[1] : Q.k == 2 ? o.c[2] : o.c[3];
    fe_store(dst, n, j, fe_canon(fe_pick(Q.k, acc.x, acc.y, acc.z, acc.t)));
  }
}

// Every launch may need more than the default 48 KiB of dynamic shared
// memory; ask for it, and for the largest shared-memory carveout.
cudaError_t windowed_opt_in() {
  cudaError_t err = cudaFuncSetAttribute(
      windowed_mul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(WM_SMEM));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(windowed_mul_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// ---------------------------------------------------------------------------
// ladder: out = s * P by the 256-step MSB-first ladder acc = 2 acc, then
// acc = bit ? acc + P : acc, one thread per point.  The sum is always
// computed and taken by a masked word select: no branch or address depends
// on the scalar (it may be a MAC-key share).
//
// Values stay loose (below 2^256, congruent mod p) with the products on
// carry chains (fe_mul_cc, fe_sqr_cc), and are made canonical once, at the
// store.  P's cached form (Y - X, Y + X, 2d T, Z) is made once and kept in
// the thread's column of shared memory, so a step is the full double and
// an 8-product cached add, and the registers hold the accumulator and the
// step's temporaries only.
// ---------------------------------------------------------------------------

constexpr int LADDER_THREADS = 128;
// 4 resident blocks (16 warps) per SM: at most 128 registers a thread, and
// the 512 blocks of 2^16 points fit the 528 slots of one wave
constexpr int LADDER_MIN_BLOCKS = 4;
constexpr int LADDER_POINTS = LADDER_THREADS;  // points a block

__device__ __forceinline__ Fe fe_select(const Fe& a, const Fe& b, uint32_t m) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = (a.w[i] & m) | (b.w[i] & ~m);
  return r;
}

// A 16-byte load from a shared address; volatile (and a compiler memory
// barrier), so the ladder rereads P every step instead of keeping it in
// registers.
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// A point's 32 words in a column of shared memory: chunk c at col[c *
// LADDER_THREADS] (16-byte chunks, thread fastest: a warp's accesses of one
// chunk are conflict-free).
__device__ __forceinline__ void column_store(uint4* col, const Pt& q) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&q);
#pragma unroll
  for (int c = 0; c < NW; ++c)
    col[c * LADDER_THREADS] = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
}

__device__ __forceinline__ Pt column_load(uint32_t addr) {
  Pt q;
  uint32_t* w = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
  for (int c = 0; c < NW; ++c) {
    const uint4 v = lds128(addr + c * LADDER_THREADS * 16);
    w[4 * c] = v.x;
    w[4 * c + 1] = v.y;
    w[4 * c + 2] = v.z;
    w[4 * c + 3] = v.w;
  }
  return q;
}

// p = 2 p (`double_parts`, then `pt_double`), loose.
__device__ __forceinline__ void ladder_double(Pt& p) {
  const Fe a = fe_sqr_cc(p.x);
  const Fe b = fe_sqr_cc(p.y);
  const Fe zz = fe_sqr_cc(p.z);
  const Fe s = fe_sqr_cc(fe_add_loose(p.x, p.y));
  const Fe h = fe_add_loose(a, b);
  const Fe g = fe_sub_loose(a, b);
  const Fe e = fe_sub_loose(h, s);
  const Fe f = fe_add_loose(fe_add_loose(zz, zz), g);
  p = Pt{fe_mul_cc(e, f), fe_mul_cc(g, h), fe_mul_cc(f, g), fe_mul_cc(e, h)};
}

// p = m ? p + q : p (all ones or zero m), q cached (Y - X, Y + X, 2d T, Z)
// in its x, y, z, t: the plain `_padd_cached`, each coordinate of the sum
// taken by a masked word select as it is made.
__device__ __forceinline__ void ladder_add(Pt& p, const Pt& q, uint32_t m) {
  const Fe a = fe_mul_cc(fe_sub_loose(p.y, p.x), q.x);
  const Fe b = fe_mul_cc(fe_add_loose(p.y, p.x), q.y);
  const Fe c = fe_mul_cc(p.t, q.z);
  const Fe zz = fe_mul_cc(p.z, q.t);
  const Fe dd = fe_add_loose(zz, zz);
  const Fe e = fe_sub_loose(b, a);
  const Fe f = fe_sub_loose(dd, c);
  const Fe g = fe_add_loose(dd, c);
  const Fe h = fe_add_loose(b, a);
  p.x = fe_select(fe_mul_cc(e, f), p.x, m);
  p.y = fe_select(fe_mul_cc(g, h), p.y, m);
  p.z = fe_select(fe_mul_cc(f, g), p.z, m);
  p.t = fe_select(fe_mul_cc(e, h), p.t, m);
}

__global__ void __launch_bounds__(LADDER_THREADS, LADDER_MIN_BLOCKS)
ladder_kernel(const int32_t* __restrict__ canon, Coords p, OutCoords o,
              int64_t n) {
  __shared__ uint4 cache[NW * LADDER_THREADS];
  const int64_t j = static_cast<int64_t>(blockIdx.x) * LADDER_POINTS + threadIdx.x;
  if (j >= n) return;
  const Pt P = pt_load(p, n, j);
  column_store(cache + threadIdx.x, Pt{fe_sub_loose(P.y, P.x), fe_add_loose(P.y, P.x),
                                       fe_mul_cc(P.t, fe_d2()), P.z});
  const uint32_t col = static_cast<uint32_t>(__cvta_generic_to_shared(cache + threadIdx.x));
  Pt acc = pt_identity();
#pragma unroll 1
  for (int k = NW - 1; k >= 0; --k) {
    const uint32_t word = static_cast<uint32_t>(__ldg(canon + (2 * k) * n + j)) |
                          (static_cast<uint32_t>(__ldg(canon + (2 * k + 1) * n + j)) << 16);
#pragma unroll 1
    for (int b = 31; b >= 0; --b) {
      ladder_double(acc);
      ladder_add(acc, column_load(col), 0u - ((word >> b) & 1u));
    }
  }
  pt_store(o, 0, n, j, Pt{fe_canon(acc.x), fe_canon(acc.y), fe_canon(acc.z), fe_canon(acc.t)});
}

// ---------------------------------------------------------------------------
// window_sums: block j is lane j, the points lo = j * per .. min(lo + per,
// n) - 1 in order, and out[w][.][j] = their sum of digit_w(s_i) * P_i from
// the identity (out: (windows, 16, L) per coordinate).
//
// Quad q keeps the accumulators of windows q, q + WS_QUADS, ... in
// registers for the whole lane.  The block walks the lane in tiles of
// WS_TILE points: quad p builds point p's cached table in shared memory
// (slot 4p + k holds coordinate k of its 16 entries), the tile's scalars
// go to shared memory, and then every quad adds, point by point, its
// window's entry of that point's table.  Lane k of every quad reads the
// same chunk (a broadcast); the entry is a masked scan over all 16 and the
// digit a shared word picked by the window index, so no address or branch
// depends on the digit (the scalar may be a MAC-key share).  Windows at or
// past `windows` run along and skip the store.
// ---------------------------------------------------------------------------

constexpr int WS_THREADS = 256;   // 64 quads: one a window
constexpr int WS_MIN_BLOCKS = 1;
constexpr int WS_TILE = 64;       // points a tile
constexpr int WS_QUADS = WS_THREADS / QUAD;
constexpr int WS_WINDOWS = 64;
constexpr int WS_PER_QUAD = WS_WINDOWS / WS_QUADS;  // accumulators a thread
constexpr int WS_SLOTS = WS_TILE * QUAD;
constexpr size_t WS_TAB_BYTES = static_cast<size_t>(WM_ENTRIES) * 2 * WS_SLOTS * 16;
constexpr size_t WS_SCALAR_BYTES = static_cast<size_t>(WS_TILE) * NW * 4;
constexpr size_t WS_SMEM = WS_TAB_BYTES + WS_SCALAR_BYTES +
                           static_cast<size_t>(WS_THREADS / 32) * XCH_WARP_WORDS * 4;
static_assert(WS_QUADS * WS_PER_QUAD == WS_WINDOWS, "every window has one quad");
static_assert(WS_TILE % 8 == 0 && WS_TILE <= WS_QUADS, "whole warps build the tables");

__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS)
window_sums_kernel(const int32_t* __restrict__ canon, Coords p, OutCoords o,
                   int64_t n, int windows, int64_t per) {
  extern __shared__ __align__(16) unsigned char ws_smem[];
  uint4* tab = reinterpret_cast<uint4*>(ws_smem);
  uint32_t* scalars = reinterpret_cast<uint32_t*>(ws_smem + WS_TAB_BYTES);
  const int t = threadIdx.x;
  const int quad = t >> 2;
  const Quad Q{reinterpret_cast<uint32_t*>(ws_smem + WS_TAB_BYTES + WS_SCALAR_BYTES) +
                   (t >> 5) * XCH_WARP_WORDS,
               (t & 31) >> 2, t & (QUAD - 1)};
  const int64_t lanes = gridDim.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t hi = lo + per < n ? lo + per : n;
  Pt acc[WS_PER_QUAD];
#pragma unroll
  for (int r = 0; r < WS_PER_QUAD; ++r) acc[r] = pt_identity();
  for (int64_t first = lo; first < hi; first += WS_TILE) {
    const int m = hi - first < WS_TILE ? static_cast<int>(hi - first) : WS_TILE;
    __syncthreads();  // the previous tile is read
    // scalar word wd of tile point i at scalars[i * NW + wd]; points past
    // the tile's end repeat its last point, and their tables go unread
    for (int c = t; c < WS_TILE * NW; c += WS_THREADS) {
      const int i = c % WS_TILE, wd = c / WS_TILE;
      const int64_t j = first + (i < m ? i : m - 1);
      scalars[i * NW + wd] = static_cast<uint32_t>(__ldg(canon + (2 * wd) * n + j)) |
                             (static_cast<uint32_t>(__ldg(canon + (2 * wd + 1) * n + j)) << 16);
    }
    if (quad < WS_TILE) {
      quad_build_table<WS_SLOTS>(Q, tab, t, pt_load(p, n, first + (quad < m ? quad : m - 1)));
    }
    __syncthreads();  // the tile's tables and scalars are written
    for (int i = 0; i < m; ++i) {
#pragma unroll
      for (int r = 0; r < WS_PER_QUAD; ++r) {
        const int w = quad + r * WS_QUADS;
        const uint32_t digit = (scalars[i * NW + (w >> 3)] >> (4 * (w & 7))) & 15u;
        quad_add_cached(Q, acc[r], tab_select<WS_SLOTS>(tab, QUAD * i + Q.k, digit));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < WS_PER_QUAD; ++r) {
    const int w = quad + r * WS_QUADS;
    if (w < windows) {
      int32_t* dst = Q.k == 0 ? o.c[0] : Q.k == 1 ? o.c[1] : Q.k == 2 ? o.c[2] : o.c[3];
      fe_store(dst + static_cast<int64_t>(w) * NLIMBS * lanes, lanes, blockIdx.x,
               fe_canon(fe_pick(Q.k, acc[r].x, acc[r].y, acc[r].z, acc[r].t)));
    }
  }
}

// Every launch may need more than the default 48 KiB of dynamic shared
// memory; ask for it, and for the largest shared-memory carveout.
cudaError_t window_sums_opt_in() {
  cudaError_t err = cudaFuncSetAttribute(
      window_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(WS_SMEM));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(window_sums_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// ---------------------------------------------------------------------------
// bucket_accumulate: a segmented sum of points in passes of one kernel.
// Bucket b's entries are begin[b] .. begin[b] + count[b]; entry k is row
// idx[k] of src (the first pass: the sorted point indices) or row k (later
// passes: the previous pass's partials).
//   chunk pass (prefix given): thread t finds its bucket b by binary search
//     (prefix[b] <= t < prefix[b + 1]) and sums chunk j = t - prefix[b], the
//     entries begin[b] + j C .. min(+ C, end), from its first point into
//     row t of dst; threads at or past prefix[buckets] (or past dst's
//     `rows`) return.
//   last pass (prefix null): thread b sums all of bucket b's entries (at most
//     C, by the pass count) into the (16, buckets) limb outputs; an empty
//     bucket is the identity.
// src and dst: (rows, 4, 8) 32-bit words, one 128-byte line a point.
// ---------------------------------------------------------------------------

struct ChunkArgs {
  const uint32_t* src;
  const int32_t* idx;     // null after the first pass
  const int32_t* begin;   // (buckets,)
  const int32_t* count;   // (buckets,)
  const int32_t* prefix;  // (buckets + 1,), null on the last pass
  uint32_t* dst;          // (rows, 4, 8), null on the last pass
  OutCoords out;          // (16, buckets) each, the last pass only
};

__device__ __forceinline__ Pt pt_load_words(const uint32_t* __restrict__ src,
                                            int64_t row) {
  const uint4* p = reinterpret_cast<const uint4*>(src + row * (4 * NW));
  Pt a;
  uint32_t* aw = reinterpret_cast<uint32_t*>(&a);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint4 v = __ldg(p + i);
    aw[4 * i] = v.x;
    aw[4 * i + 1] = v.y;
    aw[4 * i + 2] = v.z;
    aw[4 * i + 3] = v.w;
  }
  return a;
}

__device__ __forceinline__ void pt_store_words(uint32_t* dst, int64_t row,
                                               const Pt& a) {
  uint4* p = reinterpret_cast<uint4*>(dst + row * (4 * NW));
  const uint32_t* aw = reinterpret_cast<const uint32_t*>(&a);
#pragma unroll
  for (int i = 0; i < NW; ++i)
    p[i] = make_uint4(aw[4 * i], aw[4 * i + 1], aw[4 * i + 2], aw[4 * i + 3]);
}

// At least 4 blocks (16 warps) an SM: ptxas then keeps every value in
// registers (126, no spills), where left alone it spills to fit 6 blocks.
__global__ void __launch_bounds__(BUCKET_THREADS, 4)
bucket_chunk_kernel(ChunkArgs a, int64_t rows, int buckets, int chunk) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int b;
  int64_t first, end;
  if (a.prefix != nullptr) {
    if (t >= rows || t >= __ldg(a.prefix + buckets)) return;
    int lo = 0, hi = buckets;  // prefix[lo] <= t < prefix[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(a.prefix + mid) <= t) lo = mid; else hi = mid;
    }
    b = lo;
    const int64_t seg_end = static_cast<int64_t>(__ldg(a.begin + b)) + __ldg(a.count + b);
    first = __ldg(a.begin + b) + (t - __ldg(a.prefix + b)) * chunk;
    end = first + chunk < seg_end ? first + chunk : seg_end;
  } else {
    if (t >= buckets) return;
    b = static_cast<int>(t);
    first = __ldg(a.begin + b);
    end = first + __ldg(a.count + b);
  }
  Pt acc = pt_identity();
  if (first < end) {
    acc = pt_load_words(a.src, a.idx ? __ldg(a.idx + first) : first);
    for (int64_t k = first + 1; k < end; ++k)
      acc = pt_add(acc, pt_load_words(a.src, a.idx ? __ldg(a.idx + k) : k));
  }
  if (a.prefix != nullptr) pt_store_words(a.dst, t, acc);
  else pt_store(a.out, 0, buckets, b, acc);
}

// ---------------------------------------------------------------------------
// bucket_reduce: sum_w 2^(c w) S_w, S_w = sum_{d >= 1} d B[w, d], in two
// kernels on one stream.
//   bucket_window_kernel: block w (nb threads, one per bucket) computes S_w
//     by the lane suffix scan and the lane tree in shared memory, in the
//     reference's order, and thread 0 writes S_w's cached form (Y - X,
//     Y + X, 2d T, Z) to row w of the scratch; block W - 1 also writes
//     S_{W-1} itself to row W, where the Horner starts.
//   bucket_horner_kernel: one warp runs acc = 2^c acc + S_w for w = W - 2
//     down to 0 (c - 1 T-less doubles, a double and a cached add) on the
//     quad core with carry-chain products, two product stages a point
//     operation; its 8 quads run the same chain (every lane reaches every
//     __syncwarp) and quad 0 stores.  The cached S_w wait in shared memory.
// Values stay loose and are made canonical at the store; every sum runs
// the plain version's formulas, so the output is bit-identical to it.
// scratch: (W + 1, 4, 8) words.
// ---------------------------------------------------------------------------

constexpr int MAX_REDUCE_BUCKETS = 256;  // threads of a window block
constexpr int HORNER_THREADS = 32;

__device__ __forceinline__ void pt_to_smem(uint32_t* s, const Pt& a) {
  const uint32_t* aw = reinterpret_cast<const uint32_t*>(&a);
#pragma unroll
  for (int i = 0; i < 4 * NW; ++i) s[i] = aw[i];
}

__device__ __forceinline__ Pt pt_from_smem(const uint32_t* s) {
  Pt a;
  uint32_t* aw = reinterpret_cast<uint32_t*>(&a);
#pragma unroll
  for (int i = 0; i < 4 * NW; ++i) aw[i] = s[i];
  return a;
}

// p + q (`pt_add`) on loose values, the products on carry chains.
__device__ __forceinline__ Pt pt_add_cc(const Pt& p, const Pt& q) {
  const Fe a = fe_mul_cc(fe_sub_loose(p.y, p.x), fe_sub_loose(q.y, q.x));
  const Fe b = fe_mul_cc(fe_add_loose(p.y, p.x), fe_add_loose(q.y, q.x));
  const Fe c = fe_mul_cc(fe_mul_cc(p.t, q.t), fe_d2());
  const Fe zz = fe_mul_cc(p.z, q.z);
  const Fe dd = fe_add_loose(zz, zz);
  const Fe e = fe_sub_loose(b, a);
  const Fe f = fe_sub_loose(dd, c);
  const Fe g = fe_add_loose(dd, c);
  const Fe h = fe_add_loose(b, a);
  return Pt{fe_mul_cc(e, f), fe_mul_cc(g, h), fe_mul_cc(f, g), fe_mul_cc(e, h)};
}

__global__ void __launch_bounds__(MAX_REDUCE_BUCKETS)
bucket_window_kernel(Coords in, uint32_t* scratch, int windows, int nb) {
  extern __shared__ uint32_t smem[];  // nb points of 32 words
  const int w = blockIdx.x;
  const int d = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(windows) * nb;
  // bucket 0 has weight 0: drop it
  Pt v = (d == 0) ? pt_identity()
                  : pt_load(in, stride, static_cast<int64_t>(w) * nb + d);
  // suffix scan: lane d <- sum_{e >= d} B_e (identity shifted in)
  for (int k = 1; k < nb; k *= 2) {
    pt_to_smem(smem + 32 * d, v);
    __syncthreads();
    const Pt u = (d + k < nb) ? pt_from_smem(smem + 32 * (d + k)) : pt_identity();
    __syncthreads();
    v = pt_add_cc(v, u);
  }
  if (d == 0) v = pt_identity();
  // tree: lane 0 <- sum_{d >= 1} suffix_d = sum_d d * B_d
  for (int k = nb / 2; k >= 1; k /= 2) {
    pt_to_smem(smem + 32 * d, v);
    __syncthreads();
    if (d < k) v = pt_add_cc(v, pt_from_smem(smem + 32 * (d + k)));
    __syncthreads();
  }
  if (d != 0) return;
  pt_store_words(scratch, w, Pt{fe_sub_loose(v.y, v.x), fe_add_loose(v.y, v.x),
                                fe_mul_cc(v.t, fe_d2()), v.z});
  if (w == windows - 1) pt_store_words(scratch, windows, v);
}

// Shared memory of the Horner: the warp's exchange buffer, then the cached
// S_0 .. S_{W-2} (128 bytes each).
inline size_t horner_smem(int windows) {
  return static_cast<size_t>(XCH_WARP_WORDS) * 4 + static_cast<size_t>(windows - 1) * 4 * NW * 4;
}

__global__ void __launch_bounds__(HORNER_THREADS)
bucket_horner_kernel(const uint32_t* __restrict__ scratch, OutCoords out, int windows,
                     int c_bits) {
  extern __shared__ __align__(16) uint32_t hs[];
  uint4* rows = reinterpret_cast<uint4*>(hs + XCH_WARP_WORDS);
  const int t = threadIdx.x;
  const Quad Q{hs, t >> 2, t & (QUAD - 1)};
  const uint4* src = reinterpret_cast<const uint4*>(scratch);
  for (int i = t; i < (windows - 1) * 2 * QUAD; i += HORNER_THREADS) rows[i] = __ldg(src + i);
  Pt acc = pt_load_words(scratch, windows);
  __syncwarp();
  for (int w = windows - 2; w >= 0; --w) {
    for (int b = 0; b < c_bits; ++b) quad_double<CcProducts>(Q, acc);
    // lane k's coordinate of the cached S_w: chunks 2k, 2k + 1 of row w
    const uint4 lo = rows[(w * QUAD + Q.k) * 2];
    const uint4 hi = rows[(w * QUAD + Q.k) * 2 + 1];
    quad_add_cached<CcProducts>(Q, acc, Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}});
  }
  if (t < QUAD) {
    int32_t* dst = Q.k == 0 ? out.c[0] : Q.k == 1 ? out.c[1] : Q.k == 2 ? out.c[2] : out.c[3];
    fe_store(dst, 1, 0, fe_canon(fe_pick(Q.k, acc.x, acc.y, acc.z, acc.t)));
  }
}

inline unsigned int blocks_for(int64_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

Coords coords_of(void* const* ptrs) {
  return Coords{{static_cast<const int32_t*>(ptrs[0]),
                 static_cast<const int32_t*>(ptrs[1]),
                 static_cast<const int32_t*>(ptrs[2]),
                 static_cast<const int32_t*>(ptrs[3])}};
}

OutCoords out_coords_of(void* const* ptrs) {
  return OutCoords{{static_cast<int32_t*>(ptrs[0]), static_cast<int32_t*>(ptrs[1]),
                    static_cast<int32_t*>(ptrs[2]), static_cast<int32_t*>(ptrs[3])}};
}

}  // namespace

extern "C" {

// Resident blocks per SM of windowed_mul and its dynamic shared memory per
// block.
int ark_windowed_mul_config(int* blocks_per_sm, long long* smem_bytes) {
  *smem_bytes = static_cast<long long>(WM_SMEM);
  cudaError_t err = windowed_opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, windowed_mul_kernel, WM_THREADS, WM_SMEM));
}

// ptrs: canon x y z t ox oy oz ot (all (16, n)); n >= 1
int ark_windowed_mul(void* const* ptrs, long long n, int windows, void* stream) {
  cudaError_t err = windowed_opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  windowed_mul_kernel<<<blocks_for(n, WM_POINTS), WM_THREADS, WM_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ptrs[0]), coords_of(ptrs + 1),
      out_coords_of(ptrs + 5), n, windows);
  return static_cast<int>(cudaGetLastError());
}

// ladder's threads and points a block, and its resident blocks per SM.
int ark_ladder_config(int* threads, int* points_per_block, int* blocks_per_sm) {
  *threads = LADDER_THREADS;
  *points_per_block = LADDER_POINTS;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ladder_kernel, LADDER_THREADS, 0));
}

// ptrs: canon x y z t ox oy oz ot (all (16, n)); n >= 1
int ark_ladder(void* const* ptrs, long long n, void* stream) {
  ladder_kernel<<<blocks_for(n, LADDER_POINTS), LADDER_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ptrs[0]), coords_of(ptrs + 1),
      out_coords_of(ptrs + 5), n);
  return static_cast<int>(cudaGetLastError());
}

// window_sums' threads and tile, resident blocks per SM and dynamic shared
// memory per block.
int ark_window_sums_config(int* threads, int* tile, int* blocks_per_sm,
                           long long* smem_bytes) {
  *threads = WS_THREADS;
  *tile = WS_TILE;
  *smem_bytes = static_cast<long long>(WS_SMEM);
  cudaError_t err = window_sums_opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, window_sums_kernel, WS_THREADS, WS_SMEM));
}

// One block a lane of `per` points (the last lane takes the rest); n >= 1.
// ptrs: canon x y z t (16, n); ox oy oz ot (windows, 16, lanes)
int ark_window_sums(void* const* ptrs, long long n, int windows, long long lanes,
                    long long per, void* stream) {
  cudaError_t err = window_sums_opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_sums_kernel<<<static_cast<unsigned int>(lanes), WS_THREADS, WS_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ptrs[0]), coords_of(ptrs + 1),
      out_coords_of(ptrs + 5), n, windows, per);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of bucket_chunk_kernel (BUCKET_THREADS a block).
int ark_bucket_accumulate_config(int* blocks_per_sm, int* threads) {
  *threads = BUCKET_THREADS;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bucket_chunk_kernel, BUCKET_THREADS, 0));
}

// One pass of bucket_accumulate over `threads` threads: on a chunk pass a
// bound on the chunks and dst's rows (the kernel reads the chunk count from
// prefix[buckets]), on the last pass the bucket count.
// ptrs: src (rows, 4, 8) words; idx or null; begin, count (buckets,);
//       prefix (buckets + 1,) or null; dst (threads, 4, 8) or null;
//       ox oy oz ot (16, buckets) (read on the last pass only)
int ark_bucket_chunk(void* const* ptrs, long long threads, int buckets, int chunk,
                     void* stream) {
  const ChunkArgs a{static_cast<const uint32_t*>(ptrs[0]),
                    static_cast<const int32_t*>(ptrs[1]),
                    static_cast<const int32_t*>(ptrs[2]),
                    static_cast<const int32_t*>(ptrs[3]),
                    static_cast<const int32_t*>(ptrs[4]),
                    static_cast<uint32_t*>(ptrs[5]), out_coords_of(ptrs + 6)};
  bucket_chunk_kernel<<<blocks_for(threads, BUCKET_THREADS), BUCKET_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, threads, buckets,
                                                             chunk);
  return static_cast<int>(cudaGetLastError());
}

// The launches of bucket_reduce over W windows of nb buckets: {window
// kernel grid, threads, dynamic shared bytes; Horner grid, threads, dynamic
// shared bytes}.
int ark_bucket_reduce_config(int windows, int nb, long long* launch) {
  const long long v[6] = {windows, nb, static_cast<long long>(nb) * 4 * NW * 4,
                          1, HORNER_THREADS, static_cast<long long>(horner_smem(windows))};
  for (int i = 0; i < 6; ++i) launch[i] = v[i];
  return 0;
}

// ptrs: bx by bz bt (16, W, nb); scratch (W + 1, 4, 8) words; ox oy oz ot
// (16,).  part: 0 both kernels, 1 the windows only, 2 the Horner only (over
// the scratch the windows wrote).  1 <= nb <= 256, a power of two.
int ark_bucket_reduce(void* const* ptrs, int windows, int nb, int c_bits, int part,
                      void* stream) {
  uint32_t* scratch = static_cast<uint32_t*>(ptrs[4]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (part != 2) {
    bucket_window_kernel<<<windows, nb, static_cast<size_t>(nb) * 4 * NW * 4, s>>>(
        coords_of(ptrs), scratch, windows, nb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || part == 1) return static_cast<int>(err);
  }
  bucket_horner_kernel<<<1, HORNER_THREADS, horner_smem(windows), s>>>(
      scratch, out_coords_of(ptrs + 5), windows, c_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
