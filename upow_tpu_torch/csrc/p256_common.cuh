// P-256 device code shared by the two verify kernels (p256_verify.cu, the
// Jacobian ladder; p256_complete.cu, the RCB16 complete-formula ladder):
// 8 x 32-bit limb Montgomery arithmetic mod p and mod n (R = 2^256, values
// always fully reduced below the modulus), the constant table, and the
// scalar prep both kernels start from.
//
// The scalar prep reads one lane of the fused (42, N) int32 array of
// crypto/p256.py::_pack_device_inputs (z, r, s, qx, qy as 8 little-endian
// 32-bit words each, lane-minor, then range_ok and rn_ok) and computes what
// the JAX package's _scalar_prep does: s^-1 mod n by Fermat (fixed 4-bit
// window over n - 2, whatever the ladder's window), u1 = z s^-1 and u2 = r s^-1 (plain, for the window
// digits), the Montgomery forms of qx, qy, r and r + n mod p, and the
// range and on-curve checks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

#define NW 8  // 32-bit limbs per field element

// __constant__ table layout in 32-bit words, filled by p256_set_constants
// from crypto/p256.py::kernel_constants (R = 2^256 Montgomery forms).
#define C_P 0      // p
#define C_N 8      // n
#define C_R2P 16   // R^2 mod p
#define C_R2N 24   // R^2 mod n
#define C_ONEP 32  // R mod p
#define C_ONEN 40  // R mod n
#define C_BP 48    // b * R mod p
#define C_NP 56    // n * R mod p
#define C_NM2 64   // n - 2, plain
#define C_G 72     // [k]G, k = 1..31: x*R mod p (8 words), y*R mod p (8);
                   // the w = 4 ladders read the first 15, w = 5 all 31
#define C_PINV 568 // -p^-1 mod 2^32
#define C_NINV 569 // -n^-1 mod 2^32
#define C_WORDS 570

__constant__ u32 c_k[C_WORDS];

struct Fe {
  u32 v[NW];
};

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ void fe_const(Fe& r, int off) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = c_k[off + j];
}

__device__ __forceinline__ void fe_zero(Fe& r) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = 0;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  u32 acc = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) acc |= a.v[j];
  return acc == 0;
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
  u32 acc = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) acc |= a.v[j] ^ b.v[j];
  return acc == 0;
}

// r = t - m if (hi or t >= m) else t, for t < 2m held as (hi, t[0..7]).
template <int M>
__device__ __forceinline__ void cond_sub(Fe& r, const u32* t, u32 hi) {
  u32 d[NW];
  u32 borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    u64 s = (u64)t[j] - c_k[M + j] - borrow;
    d[j] = (u32)s;
    borrow = (u32)(s >> 32) & 1u;
  }
  const bool take = hi != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = take ? d[j] : t[j];
}

// Montgomery product a * b * 2^-256 mod m (CIOS).  Needs a < 2^256 and
// b < m; returns a value below m.
template <int M, int MINV>
__device__ __forceinline__ void mont_mul(Fe& r, const Fe& a, const Fe& b) {
  u32 t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      u64 s = (u64)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 s = (u64)t[NW] + c;
    t[NW] = (u32)s;
    t[NW + 1] = (u32)(s >> 32);
    const u32 q = t[0] * c_k[MINV];
    s = (u64)q * c_k[M] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (u64)q * c_k[M + j] + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = (u64)t[NW] + c;
    t[NW - 1] = (u32)s;
    t[NW] = t[NW + 1] + (u32)(s >> 32);
  }
  cond_sub<M>(r, t, t[NW]);
}

// a + b mod m, for a, b < m.
template <int M>
__device__ __forceinline__ void mod_add(Fe& r, const Fe& a, const Fe& b) {
  u32 t[NW];
  u32 c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    u64 s = (u64)a.v[j] + b.v[j] + c;
    t[j] = (u32)s;
    c = (u32)(s >> 32);
  }
  cond_sub<M>(r, t, c);
}

// a - b mod m, for a, b < m.
template <int M>
__device__ __forceinline__ void mod_sub(Fe& r, const Fe& a, const Fe& b) {
  u32 t[NW];
  u32 borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    u64 s = (u64)a.v[j] - b.v[j] - borrow;
    t[j] = (u32)s;
    borrow = (u32)(s >> 32) & 1u;
  }
  // add m back when the difference went negative
  const u32 mask = 0u - borrow;
  u32 c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    u64 s = (u64)t[j] + (c_k[M + j] & mask) + c;
    r.v[j] = (u32)s;
    c = (u32)(s >> 32);
  }
}

// the field mod p, where the curve lives
__device__ __forceinline__ void fmul(Fe& r, const Fe& a, const Fe& b) {
  mont_mul<C_P, C_PINV>(r, a, b);
}
__device__ __forceinline__ void fsqr(Fe& r, const Fe& a) {
  mont_mul<C_P, C_PINV>(r, a, a);
}
__device__ __forceinline__ void fadd(Fe& r, const Fe& a, const Fe& b) {
  mod_add<C_P>(r, a, b);
}
__device__ __forceinline__ void fsub(Fe& r, const Fe& a, const Fe& b) {
  mod_sub<C_P>(r, a, b);
}

// the scalar field mod n (only products are needed there)
__device__ __forceinline__ void nmul(Fe& r, const Fe& a, const Fe& b) {
  mont_mul<C_N, C_NINV>(r, a, b);
}

// What the ladders need from one lane: u1, u2 plain (window digits), Q and
// r, r + n in Montgomery form mod p, and the lane's flags.
struct Prep {
  Fe u1, u2, qx_m, qy_m, r_m, rn_m;
  bool valid, rn_ok;
};

__device__ __forceinline__ void scalar_prep(const u32* __restrict__ packed,
                                            int n, int lane, Prep& o) {
  Fe z, r, s, qx, qy;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    z.v[j] = packed[(0 + j) * (size_t)n + lane];
    r.v[j] = packed[(8 + j) * (size_t)n + lane];
    s.v[j] = packed[(16 + j) * (size_t)n + lane];
    qx.v[j] = packed[(24 + j) * (size_t)n + lane];
    qy.v[j] = packed[(32 + j) * (size_t)n + lane];
  }
  const bool range_ok = packed[40 * (size_t)n + lane] != 0;
  o.rn_ok = packed[41 * (size_t)n + lane] != 0;

  // ---- mod n: w = s^-1 (Fermat), u1 = z w, u2 = r w ---------------------
  Fe r2n, one_plain, s_m, w, t;
  fe_const(r2n, C_R2N);
  nmul(s_m, s, r2n);
  Fe spow[16];
  fe_const(spow[0], C_ONEN);
  spow[1] = s_m;
  for (int k = 2; k < 16; ++k) nmul(spow[k], spow[k - 1], s_m);
  fe_const(w, C_ONEN);
  for (int k = 0; k < 64; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) nmul(w, w, w);
    const int bit = 4 * (63 - k);
    const u32 d = (c_k[C_NM2 + (bit >> 5)] >> (bit & 31)) & 0xFu;
    nmul(w, w, spow[d]);
  }
  fe_zero(one_plain);
  one_plain.v[0] = 1;
  nmul(t, z, r2n);
  nmul(t, t, w);
  nmul(o.u1, t, one_plain);               // out of Montgomery form
  nmul(t, r, r2n);
  nmul(t, t, w);
  nmul(o.u2, t, one_plain);

  // ---- mod p: Montgomery forms, on-curve check -------------------------
  Fe r2p, y2, x3;
  fe_const(r2p, C_R2P);
  fmul(o.qx_m, qx, r2p);
  fmul(o.qy_m, qy, r2p);
  fmul(o.r_m, r, r2p);
  fe_const(t, C_NP);
  fadd(o.rn_m, o.r_m, t);                 // (r + n) R mod p
  fsqr(y2, o.qy_m);
  fsqr(x3, o.qx_m);
  fmul(x3, x3, o.qx_m);
  fsub(x3, x3, o.qx_m);
  fsub(x3, x3, o.qx_m);
  fsub(x3, x3, o.qx_m);
  fe_const(t, C_BP);
  fadd(x3, x3, t);                        // x^3 - 3x + b
  o.valid = range_ok && fe_eq(y2, x3);
}

extern "C" int p256_set_constants(const u32* host, int words) {
  if (words != C_WORDS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyToSymbol(c_k, host, sizeof(u32) * C_WORDS);
  return (int)err;
}
