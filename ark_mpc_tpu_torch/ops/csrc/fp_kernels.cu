// Hand-written Hopper (sm_90a) kernels for the authenticated Beaver
// multiplication path: Montgomery product, one party's Beaver combine, and
// the K-round two-party chain with its MAC-check fold.
//
// They replace the Pallas TPU kernels in ark_mpc_tpu/ops/fp_kernels.py
// (mont_mul_pallas, beaver_round_pallas, beaver_chain_pallas).  The TPU
// kernels work on 16-bit limbs because the TPU has no 32x32->64 multiply;
// here each element is repacked into eight 32-bit words in registers and
// multiplied with 32x32->64 products (SOS schoolbook + Montgomery REDC with
// n0' = -m^-1 mod 2^32).  R = 2^256 for both limb widths and every result
// leaves through a final conditional subtraction, so outputs are the
// canonical values in [0, m): bit-identical to the reference.
//
// Layout in device memory is the reference's: (16, n) int32 tensors whose
// entries are 16-bit limbs; thread j reads limb i of element j at i*n + j,
// so each limb row loads coalesced.  One thread owns one element.
//
// Plain C interface (loaded with ctypes): every entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 8;            // 32-bit words per field element
constexpr int FOLD_WORDS = 16;   // 512-bit fold products
constexpr int THREADS = 256;

struct Field {
  uint32_t m[NW];  // modulus, little-endian 32-bit words
  uint32_t n0;     // -m^-1 mod 2^32
};

Field make_field(const uint32_t* words) {
  Field f;
  for (int k = 0; k < NW; ++k) f.m[k] = words[k];
  f.n0 = words[NW];
  return f;
}

__device__ __forceinline__ void load(const int32_t* __restrict__ p, int64_t n,
                                     int64_t j, uint32_t w[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t lo = static_cast<uint32_t>(__ldg(p + (2 * k) * n + j));
    const uint32_t hi = static_cast<uint32_t>(__ldg(p + (2 * k + 1) * n + j));
    w[k] = lo | (hi << 16);
  }
}

// A (16,) limb vector broadcast to every element (the MAC-key share).
__device__ __forceinline__ void load_vec(const int32_t* __restrict__ p,
                                         uint32_t w[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    w[k] = static_cast<uint32_t>(__ldg(p + 2 * k)) |
           (static_cast<uint32_t>(__ldg(p + 2 * k + 1)) << 16);
  }
}

__device__ __forceinline__ void store(int32_t* __restrict__ p, int64_t n,
                                      int64_t j, const uint32_t w[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    p[(2 * k) * n + j] = static_cast<int32_t>(w[k] & 0xFFFFu);
    p[(2 * k + 1) * n + j] = static_cast<int32_t>(w[k] >> 16);
  }
}

__device__ __forceinline__ void copy(const uint32_t a[NW], uint32_t r[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) r[k] = a[k];
}

// t = a * b as 16 carried words.
__device__ __forceinline__ void mul_wide(const uint32_t a[NW],
                                         const uint32_t b[NW],
                                         uint32_t t[2 * NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t s = static_cast<uint64_t>(a[j]) * b[i] + t[i + j] + c;
      t[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    t[i + NW] = static_cast<uint32_t>(c);
  }
}

// t += u over 16 words (callers keep the sum below 2^512).
__device__ __forceinline__ void add_wide(uint32_t t[2 * NW],
                                         const uint32_t u[2 * NW]) {
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) {
    const uint64_t s = static_cast<uint64_t>(t[k]) + u[k] + c;
    t[k] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
}

// r = x + top*2^256 reduced once by m (x + top*2^256 < 2m).
__device__ __forceinline__ void cond_sub(const Field& f, const uint32_t x[NW],
                                         uint32_t top, uint32_t r[NW]) {
  uint32_t d[NW];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint64_t s = static_cast<uint64_t>(x[k]) - f.m[k] - borrow;
    d[k] = static_cast<uint32_t>(s);
    borrow = (s >> 32) & 1u;
  }
  const bool ge = (top != 0) || (borrow == 0);
#pragma unroll
  for (int k = 0; k < NW; ++k) r[k] = ge ? d[k] : x[k];
}

// Montgomery reduction: r = T * 2^-256 mod m for T < m * 2^256 (16 words,
// clobbered).  The intermediate (T + q*m) stays below 2^512.
__device__ __forceinline__ void redc(const Field& f, uint32_t t[2 * NW],
                                     uint32_t r[NW]) {
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t q = t[i] * f.n0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t s = static_cast<uint64_t>(q) * f.m[j] + t[i + j] + c;
      t[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
#pragma unroll
    for (int k = i + NW; k < 2 * NW; ++k) {
      const uint64_t s = static_cast<uint64_t>(t[k]) + c;
      t[k] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    top += static_cast<uint32_t>(c);
  }
  cond_sub(f, t + NW, top, r);
}

__device__ __forceinline__ void mont_mul(const Field& f, const uint32_t a[NW],
                                         const uint32_t b[NW], uint32_t r[NW]) {
  uint32_t t[2 * NW];
  mul_wide(a, b, t);
  redc(f, t, r);
}

// r = (a*b + c*d) * 2^-256 mod m: one reduction for two products
// (2m^2 < m * 2^256 because m < 2^255).
__device__ __forceinline__ void mont_mul2(const Field& f, const uint32_t a[NW],
                                          const uint32_t b[NW],
                                          const uint32_t c[NW],
                                          const uint32_t d[NW],
                                          uint32_t r[NW]) {
  uint32_t t[2 * NW], u[2 * NW];
  mul_wide(a, b, t);
  mul_wide(c, d, u);
  add_wide(t, u);
  redc(f, t, r);
}

__device__ __forceinline__ void add_mod(const Field& f, const uint32_t a[NW],
                                        const uint32_t b[NW], uint32_t r[NW]) {
  uint32_t s[NW];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint64_t v = static_cast<uint64_t>(a[k]) + b[k] + c;
    s[k] = static_cast<uint32_t>(v);
    c = v >> 32;
  }
  cond_sub(f, s, static_cast<uint32_t>(c), r);
}

__device__ __forceinline__ void sub_mod(const Field& f, const uint32_t a[NW],
                                        const uint32_t b[NW], uint32_t r[NW]) {
  uint32_t d[NW];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint64_t v = static_cast<uint64_t>(a[k]) - b[k] - borrow;
    d[k] = static_cast<uint32_t>(v);
    borrow = (v >> 32) & 1u;
  }
  const uint32_t mask = 0u - static_cast<uint32_t>(borrow);
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint64_t v = static_cast<uint64_t>(d[k]) + (f.m[k] & mask) + c;
    r[k] = static_cast<uint32_t>(v);
    c = v >> 32;
  }
}

// r += (a + b) loaded from memory at element j, mod m.
__device__ __forceinline__ void add2_mem(const Field& f, uint32_t r[NW],
                                         const int32_t* __restrict__ a,
                                         const int32_t* __restrict__ b,
                                         int64_t n, int64_t j) {
  uint32_t u[NW];
  load(a, n, j, u);
  add_mod(f, r, u, r);
  load(b, n, j, u);
  add_mod(f, r, u, r);
}

// ---------------------------------------------------------------------------
// mont_mul: out = x * y * 2^-256 mod m, element-wise over (16, n).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                int32_t* __restrict__ out, int64_t n, Field f) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint32_t a[NW], b[NW], r[NW];
  load(x, n, j, a);
  load(y, n, j, b);
  mont_mul(f, a, b, r);
  store(out, n, j, r);
}

// ---------------------------------------------------------------------------
// beaver_round: one party's post-open combine
//   share = d*e*[party==0] + d*b_s + e*a_s + c_s
//   mac   = key*(d*e) + d*b_m + e*a_m + c_m
// ---------------------------------------------------------------------------

struct RoundArgs {
  const int32_t* a_s;
  const int32_t* a_m;
  const int32_t* b_s;
  const int32_t* b_m;
  const int32_t* c_s;
  const int32_t* c_m;
  const int32_t* d;
  const int32_t* e;
  const int32_t* key;  // (16,)
  int32_t* out_s;
  int32_t* out_m;
};

__global__ void __launch_bounds__(THREADS)
beaver_round_kernel(RoundArgs p, int64_t n, int party, Field f) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint32_t d[NW], e[NW], de[NW], u[NW], v[NW], acc[NW];
  load(p.d, n, j, d);
  load(p.e, n, j, e);
  mont_mul(f, d, e, de);

  load(p.b_s, n, j, u);
  load(p.a_s, n, j, v);
  mont_mul2(f, d, u, e, v, acc);
  load(p.c_s, n, j, u);
  add_mod(f, acc, u, acc);
  if (party == 0) add_mod(f, acc, de, acc);
  store(p.out_s, n, j, acc);

  load(p.b_m, n, j, u);
  load(p.a_m, n, j, v);
  mont_mul2(f, d, u, e, v, acc);
  load_vec(p.key, u);
  mont_mul(f, u, de, v);
  add_mod(f, acc, v, acc);
  load(p.c_m, n, j, u);
  add_mod(f, acc, u, acc);
  store(p.out_m, n, j, acc);
}

// ---------------------------------------------------------------------------
// beaver_chain: K dependent two-party rounds x_{r+1} = x_r * y, both
// parties' shares resident in registers, e / e*a_p / e*a_mac_p hoisted by
// the caller, plus each round's MAC-check inner products <cf,v>, <cf,mac0>,
// <cf,mac1> as un-reduced 512-bit sums.
//
// Fold: each thread forms the 512-bit product cf*t (16 carried words); a
// warp sums every word's 16-bit halves with redux.sync (32 halves < 2^21,
// no overflow), and one lane per word adds lo + hi*2^16 into a per-block
// 64-bit shared accumulator [round][3][16].  A block's sums stay below
// (elements per block) * 2^32, far inside 64 bits.  The block writes its
// accumulators to fold[block][round][3][16]; torch sums the blocks and
// reduces once.
// ---------------------------------------------------------------------------

// Input slots of ChainArgs::in.
enum ChainInput {
  IN_X0, IN_X1, IN_E, IN_A0, IN_A1, IN_B0, IN_B1, IN_BM0, IN_BM1,
  IN_C0, IN_C1, IN_CM0, IN_CM1, IN_EA0, IN_EA1, IN_EAM0, IN_EAM1,
  IN_K0, IN_K1, IN_CF, N_CHAIN_IN
};

struct ChainArgs {
  const int32_t* in[N_CHAIN_IN];  // (16, n) limbs; K0/K1 are (16,)
  int32_t* out0;
  int32_t* out1;
  unsigned long long* fold;  // (gridDim.x, rounds, 3, 16)
};

__device__ __forceinline__ void fold_add(unsigned long long* acc,
                                         const uint32_t cf[NW],
                                         const uint32_t t[NW], bool valid,
                                         int lane) {
  uint32_t p[FOLD_WORDS];
  mul_wide(cf, t, p);
#pragma unroll
  for (int k = 0; k < FOLD_WORDS; ++k) {
    const uint32_t w = valid ? p[k] : 0u;
    const uint32_t lo = __reduce_add_sync(0xffffffffu, w & 0xFFFFu);
    const uint32_t hi = __reduce_add_sync(0xffffffffu, w >> 16);
    if (lane == k) {
      atomicAdd(acc + k, static_cast<unsigned long long>(lo) +
                             (static_cast<unsigned long long>(hi) << 16));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
beaver_chain_kernel(ChainArgs p, int64_t n, int rounds, Field f) {
  extern __shared__ unsigned long long acc[];  // rounds * 3 * 16
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n_acc = rounds * 3 * FOLD_WORDS;
  for (int i = tid; i < n_acc; i += blockDim.x) acc[i] = 0;
  __syncthreads();

  uint32_t k0[NW], k1[NW];
  load_vec(p.in[IN_K0], k0);
  load_vec(p.in[IN_K1], k1);

  // The loop bound is uniform over the block, so whole warps take every
  // redux.sync; lanes past n compute on element 0 and contribute zero.
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const int64_t j0 = base + tid;
    const bool valid = j0 < n;
    const int64_t j = valid ? j0 : 0;
    uint32_t x0[NW], x1[NW];
    load(p.in[IN_X0], n, j, x0);
    load(p.in[IN_X1], n, j, x1);
    for (int r = 0; r < rounds; ++r) {
      uint32_t d[NW], de[NW], u[NW], v[NW], s0[NW], s1[NW], m0[NW], m1[NW];
      // d = (x0 - a0) + (x1 - a1): the opened mask
      load(p.in[IN_A0], n, j, u);
      sub_mod(f, x0, u, d);
      load(p.in[IN_A1], n, j, u);
      sub_mod(f, x1, u, v);
      add_mod(f, d, v, d);
      load(p.in[IN_E], n, j, u);
      mont_mul(f, d, u, de);
      // s_p = d*b_p + e*a_p + c_p (+ d*e for party 0)
      load(p.in[IN_B0], n, j, u);
      mont_mul(f, d, u, s0);
      add2_mem(f, s0, p.in[IN_EA0], p.in[IN_C0], n, j);
      add_mod(f, s0, de, s0);
      load(p.in[IN_B1], n, j, u);
      mont_mul(f, d, u, s1);
      add2_mem(f, s1, p.in[IN_EA1], p.in[IN_C1], n, j);
      // mac_p = d*bmac_p + k_p*(d*e) + e*amac_p + cmac_p
      load(p.in[IN_BM0], n, j, u);
      mont_mul2(f, d, u, k0, de, m0);
      add2_mem(f, m0, p.in[IN_EAM0], p.in[IN_CM0], n, j);
      load(p.in[IN_BM1], n, j, u);
      mont_mul2(f, d, u, k1, de, m1);
      add2_mem(f, m1, p.in[IN_EAM1], p.in[IN_CM1], n, j);
      // fold inner products
      add_mod(f, s0, s1, v);
      load(p.in[IN_CF], n, j, u);
      unsigned long long* a = acc + r * 3 * FOLD_WORDS;
      fold_add(a, u, v, valid, lane);
      fold_add(a + FOLD_WORDS, u, m0, valid, lane);
      fold_add(a + 2 * FOLD_WORDS, u, m1, valid, lane);
      copy(s0, x0);
      copy(s1, x1);
    }
    if (valid) {
      store(p.out0, n, j, x0);
      store(p.out1, n, j, x1);
    }
  }
  __syncthreads();
  unsigned long long* dst = p.fold + static_cast<int64_t>(blockIdx.x) * n_acc;
  for (int i = tid; i < n_acc; i += blockDim.x) dst[i] = acc[i];
}

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

int ark_mont_mul(const void* x, const void* y, void* out, long long n,
                 const uint32_t* field, void* stream) {
  mont_mul_kernel<<<blocks_for(n), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<int32_t*>(out), n, make_field(field));
  return static_cast<int>(cudaGetLastError());
}

// ptrs: a_s, a_m, b_s, b_m, c_s, c_m, d, e, key, out_s, out_m
int ark_beaver_round(void* const* ptrs, long long n, int party,
                     const uint32_t* field, void* stream) {
  RoundArgs p;
  p.a_s = static_cast<const int32_t*>(ptrs[0]);
  p.a_m = static_cast<const int32_t*>(ptrs[1]);
  p.b_s = static_cast<const int32_t*>(ptrs[2]);
  p.b_m = static_cast<const int32_t*>(ptrs[3]);
  p.c_s = static_cast<const int32_t*>(ptrs[4]);
  p.c_m = static_cast<const int32_t*>(ptrs[5]);
  p.d = static_cast<const int32_t*>(ptrs[6]);
  p.e = static_cast<const int32_t*>(ptrs[7]);
  p.key = static_cast<const int32_t*>(ptrs[8]);
  p.out_s = static_cast<int32_t*>(ptrs[9]);
  p.out_m = static_cast<int32_t*>(ptrs[10]);
  beaver_round_kernel<<<blocks_for(n), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      p, n, party, make_field(field));
  return static_cast<int>(cudaGetLastError());
}

// ptrs: x0 x1 e a0 a1 b0 b1 bm0 bm1 c0 c1 cm0 cm1 ea0 ea1 eam0 eam1 k0 k1 cf
//       out0 out1 fold
int ark_beaver_chain(void* const* ptrs, long long n, int rounds, int grid,
                     const uint32_t* field, void* stream) {
  ChainArgs p;
  for (int i = 0; i < N_CHAIN_IN; ++i) {
    p.in[i] = static_cast<const int32_t*>(ptrs[i]);
  }
  p.out0 = static_cast<int32_t*>(ptrs[20]);
  p.out1 = static_cast<int32_t*>(ptrs[21]);
  p.fold = static_cast<unsigned long long*>(ptrs[22]);
  const size_t smem =
      static_cast<size_t>(rounds) * 3 * FOLD_WORDS * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        beaver_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  beaver_chain_kernel<<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      p, n, rounds, make_field(field));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
