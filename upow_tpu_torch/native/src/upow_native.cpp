// Native CPU backends of the PyTorch/CUDA port: the sha256 PoW search and
// the batched P-256 ECDSA verify on the host.  A copy of the JAX package's
// upow_tpu/native/src/upow_native.cpp, kept as the port's own: host code,
// not a TPU kernel, so it is copied as it is, with its SHA-NI pick at run
// time and its OpenMP batch.
//
// These play the roles the reference delegates to native dependencies:
// hashlib/OpenSSL's C sha256 in the miner hot loop (miner.py:83-98) and
// fastecdsa's C/GMP extension for signature verification
// (upow/upow_transactions/transaction_input.py:100-109).  Python binds via
// ctypes (upow_tpu_torch/native/__init__.py).
//
// The P-256 implementation uses Montgomery field arithmetic and the
// Jacobian formula set of the card's verify kernel (dbl-2001-b,
// add/madd-2007-bl) in a 4-bit-window Strauss walk, but handles formula
// degeneracies with explicit branches: verify-only code with nothing
// secret to leak.  It serves the node's host signature path and the
// degrade's fallback (verify/txverify.py).

#include <cstdint>
#include <cstring>
#include <cstddef>
#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>  // SHA-NI intrinsics (guarded per-function below)
#include <cpuid.h>      // runtime SHA/SSE4.1 detection (shani_available)
#endif

// ---------------------------------------------------------------- sha256 --

namespace sha256 {

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static const uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                               0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};

static inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static void compress(uint32_t state[8], const uint8_t block[64]) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = (uint32_t(block[4 * i]) << 24) | (uint32_t(block[4 * i + 1]) << 16) |
           (uint32_t(block[4 * i + 2]) << 8) | uint32_t(block[4 * i + 3]);
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int i = 0; i < 64; i++) {
    uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + s1 + ch + K[i] + w[i];
    uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = s0 + maj;
    h = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

#if defined(__x86_64__) && defined(__GNUC__)
// SHA-NI compression (x86 SHA extensions): ~10x the portable loop on one
// core.  Compiled with a per-function target attribute so the rest of the
// library needs no -m flags; selected at runtime via cpuid.
static bool shani_available() {
  // raw cpuid, not __builtin_cpu_supports("sha"): gcc only learned the
  // "sha" feature name in 11.x, and the distro toolchain here is older
  unsigned eax, ebx, ecx, edx;
  if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx) ||
      !(ebx & (1u << 29)))  // CPUID.7.0:EBX.SHA
    return false;
  if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx) ||
      !(ecx & (1u << 19)))  // CPUID.1:ECX.SSE4.1
    return false;
  return true;
}

// LANES independent single-block compressions interleaved: sha256rnds2
// has multi-cycle latency but ~1/cycle throughput, so a single hash
// chain leaves the unit mostly idle.  Interleaving fills the pipeline —
// the nonce search has unlimited independent work.  LANES = 4 measured
// fastest here (measured 21.0 vs 20.4 at 2 and 20.2 at 8 lanes; ~1.3x one
// stream on this virtualized core — bare-metal SHA-NI has more
// pipeline headroom).
template <int LANES>
__attribute__((target("sha,sse4.1")))
static void compress_shani_multi(uint32_t state[][8],
                                 const uint8_t* const blocks[]) {
  const __m128i MASK = _mm_set_epi64x(0x0c0d0e0f08090a0bULL,
                                      0x0405060700010203ULL);
  __m128i S0[LANES], S1[LANES], S0v[LANES], S1v[LANES], M[LANES][4];
  for (int l = 0; l < LANES; l++) {
    __m128i TMP = _mm_loadu_si128((const __m128i*)&state[l][0]);
    __m128i ST1 = _mm_loadu_si128((const __m128i*)&state[l][4]);
    TMP = _mm_shuffle_epi32(TMP, 0xB1);
    ST1 = _mm_shuffle_epi32(ST1, 0x1B);
    S0[l] = _mm_alignr_epi8(TMP, ST1, 8);
    S1[l] = _mm_blend_epi16(ST1, TMP, 0xF0);
    S0v[l] = S0[l]; S1v[l] = S1[l];
    for (int i = 0; i < 4; i++)
      M[l][i] = _mm_shuffle_epi8(
          _mm_loadu_si128((const __m128i*)(blocks[l] + 16 * i)), MASK);
  }
  for (int i = 0; i < 16; i++) {
    const __m128i k = _mm_loadu_si128((const __m128i*)&K[4 * i]);
    for (int l = 0; l < LANES; l++) {
      __m128i wk = _mm_add_epi32(M[l][i & 3], k);
      S1[l] = _mm_sha256rnds2_epu32(S1[l], S0[l], wk);
      wk = _mm_shuffle_epi32(wk, 0x0E);
      S0[l] = _mm_sha256rnds2_epu32(S0[l], S1[l], wk);
      if (i < 12) {
        __m128i tmp = _mm_alignr_epi8(M[l][(i + 3) & 3], M[l][(i + 2) & 3], 4);
        M[l][i & 3] = _mm_sha256msg2_epu32(
            _mm_add_epi32(_mm_sha256msg1_epu32(M[l][i & 3], M[l][(i + 1) & 3]),
                          tmp),
            M[l][(i + 3) & 3]);
      }
    }
  }
  for (int l = 0; l < LANES; l++) {
    S0[l] = _mm_add_epi32(S0[l], S0v[l]);
    S1[l] = _mm_add_epi32(S1[l], S1v[l]);
    __m128i TMP = _mm_shuffle_epi32(S0[l], 0x1B);
    S1[l] = _mm_shuffle_epi32(S1[l], 0xB1);
    S0[l] = _mm_blend_epi16(TMP, S1[l], 0xF0);
    S1[l] = _mm_alignr_epi8(S1[l], TMP, 8);
    _mm_storeu_si128((__m128i*)&state[l][0], S0[l]);
    _mm_storeu_si128((__m128i*)&state[l][4], S1[l]);
  }
}

// single-stream form (digest(), sequential callers): the 1-lane
// instantiation of the same transcription — one copy to keep correct
__attribute__((target("sha,sse4.1")))
static void compress_shani(uint32_t state[8], const uint8_t block[64]) {
  compress_shani_multi<1>((uint32_t(*)[8])state, &block);
}
#else
template <int LANES>
static void compress_shani_multi(uint32_t state[][8],
                                 const uint8_t* const blocks[]) {
  for (int l = 0; l < LANES; l++) compress(state[l], blocks[l]);
}
#endif
#if !(defined(__x86_64__) && defined(__GNUC__))
static void compress_shani(uint32_t state[8], const uint8_t block[64]) {
  compress(state, block);
}
static bool shani_available() { return false; }
#endif

typedef void (*compress_fn)(uint32_t[8], const uint8_t[64]);

static compress_fn pick_compress() {
  // cpuid runs once; per-message callers (upow_sha256 on short inputs)
  // would otherwise pay serializing cpuid leaves per call
  static const compress_fn picked =
      shani_available() ? compress_shani : compress;
  return picked;
}

static void digest(const uint8_t* msg, size_t len, uint8_t out[32]) {
  const compress_fn compress = pick_compress();
  uint32_t state[8];
  memcpy(state, H0, sizeof(H0));
  size_t off = 0;
  for (; off + 64 <= len; off += 64) compress(state, msg + off);
  uint8_t tail[128] = {0};
  size_t rem = len - off;
  memcpy(tail, msg + off, rem);
  tail[rem] = 0x80;
  size_t tlen = (rem + 9 <= 64) ? 64 : 128;
  uint64_t bits = uint64_t(len) * 8;
  for (int i = 0; i < 8; i++) tail[tlen - 1 - i] = uint8_t(bits >> (8 * i));
  compress(state, tail);
  if (tlen == 128) compress(state, tail + 64);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 4; j++) out[4 * i + j] = uint8_t(state[i] >> (24 - 8 * j));
}

}  // namespace sha256

extern "C" void upow_sha256(const uint8_t* msg, size_t len, uint8_t out[32]) {
  sha256::digest(msg, len, out);
}

// PoW nonce search over [start, start+count): header = prefix || nonce_le4.
// target_nibbles: required leading hex chars of the digest; charset < 16
// additionally bounds the next nibble (manager.py:130-151).  Returns the
// first satisfying nonce, or 0xFFFFFFFF.  Midstate-split like the TPU
// kernel: full prefix blocks folded once, one-or-two compressions per nonce.
extern "C" uint32_t upow_pow_search(const uint8_t* prefix, size_t prefix_len,
                                    const uint8_t* target_nibbles,
                                    size_t n_target, uint32_t charset,
                                    uint32_t start, uint32_t count) {
  const sha256::compress_fn compress = sha256::pick_compress();
  uint32_t mid[8];
  memcpy(mid, sha256::H0, sizeof(mid));
  size_t n_full = prefix_len / 64;
  for (size_t i = 0; i < n_full; i++) compress(mid, prefix + 64 * i);
  size_t rem = prefix_len - 64 * n_full;
  size_t total = prefix_len + 4;
  // same bound as make_template: rem + nonce(4) + 0x80 must fit before the
  // 8-byte length field (rem + 4 <= 55), else the tail spans two blocks
  if (rem + 4 > 55) return 0xFFFFFFFFu;

  uint8_t tail[64] = {0};
  memcpy(tail, prefix + 64 * n_full, rem);
  tail[rem + 4] = 0x80;
  uint64_t bits = uint64_t(total) * 8;
  for (int i = 0; i < 8; i++) tail[63 - i] = uint8_t(bits >> (8 * i));

  auto hit = [&](const uint32_t state[8]) -> bool {
    bool ok = true;
    for (size_t i = 0; i < n_target && ok; i++) {
      uint32_t nib = (state[i / 8] >> (28 - 4 * (i % 8))) & 0xF;
      ok = nib == target_nibbles[i];
    }
    if (ok && charset < 16) {
      uint32_t nib = (state[n_target / 8] >> (28 - 4 * (n_target % 8))) & 0xF;
      ok = nib < charset;
    }
    return ok;
  };

  const uint64_t end = uint64_t(start) + count;
  uint64_t n = start;

  if (sha256::shani_available()) {
    // 4-way interleaved SHA-NI: ~1.3x one stream here (pipeline-bound, not
    // throughput-bound).  Returns the LOWEST hit in the quad — same
    // first-hit semantics as the scalar loop.
    constexpr int LANES = 4;
    uint8_t blks[LANES][64];
    uint32_t states[LANES][8];
    const uint8_t* blk_ptrs[LANES];
    for (int l = 0; l < LANES; l++) {
      memcpy(blks[l], tail, 64);
      blk_ptrs[l] = blks[l];
    }
    for (; n + LANES <= end; n += LANES) {
      for (int l = 0; l < LANES; l++) {
        uint64_t nl = n + l;
        memcpy(states[l], mid, sizeof(mid));
        blks[l][rem] = uint8_t(nl);
        blks[l][rem + 1] = uint8_t(nl >> 8);
        blks[l][rem + 2] = uint8_t(nl >> 16);
        blks[l][rem + 3] = uint8_t(nl >> 24);
      }
      sha256::compress_shani_multi<LANES>(states, blk_ptrs);
      for (int l = 0; l < LANES; l++)
        if (hit(states[l])) return uint32_t(n + l);
    }
  }

  uint8_t blk[64];
  memcpy(blk, tail, 64);  // only the 4 nonce bytes change per iteration
  for (; n < end; n++) {
    uint32_t state[8];
    memcpy(state, mid, sizeof(mid));
    blk[rem] = uint8_t(n);
    blk[rem + 1] = uint8_t(n >> 8);
    blk[rem + 2] = uint8_t(n >> 16);
    blk[rem + 3] = uint8_t(n >> 24);
    compress(state, blk);
    if (hit(state)) return uint32_t(n);
  }
  return 0xFFFFFFFFu;
}

// ----------------------------------------------------------------- P-256 --

namespace p256 {

typedef unsigned __int128 u128;

// little-endian 4x64 limbs
struct Fe { uint64_t v[4]; };

static const Fe P = {{0xffffffffffffffffULL, 0x00000000ffffffffULL,
                      0x0000000000000000ULL, 0xffffffff00000001ULL}};
static const Fe N = {{0xf3b9cac2fc632551ULL, 0xbce6faada7179e84ULL,
                      0xffffffffffffffffULL, 0xffffffff00000000ULL}};
// -p^-1 mod 2^64 and -n^-1 mod 2^64
static const uint64_t P_INV = 0x0000000000000001ULL;
static const uint64_t N_INV = 0xccd1c8aaee00bc4fULL;
// R^2 mod p / mod n  (R = 2^256)
static const Fe P_R2 = {{0x0000000000000003ULL, 0xfffffffbffffffffULL,
                         0xfffffffffffffffeULL, 0x00000004fffffffdULL}};
static const Fe N_R2 = {{0x83244c95be79eea2ULL, 0x4699799c49bd6fa6ULL,
                         0x2845b2392b6bec59ULL, 0x66e12d94f3d95620ULL}};
// curve b, Montgomery form (b*R mod p)
static const Fe B_M = {{0xd89cdf6229c4bddfULL, 0xacf005cd78843090ULL,
                        0xe5a220abf7212ed6ULL, 0xdc30061d04874834ULL}};
// generator, Montgomery form
static const Fe GX_M = {{0x79e730d418a9143cULL, 0x75ba95fc5fedb601ULL,
                         0x79fb732b77622510ULL, 0x18905f76a53755c6ULL}};
static const Fe GY_M = {{0xddf25357ce95560aULL, 0x8b4ab8e4ba19e45cULL,
                         0xd2e88688dd21f325ULL, 0x8571ff1825885d85ULL}};
// 1 in Montgomery form mod p (R mod p)
static const Fe ONE_M = {{0x0000000000000001ULL, 0xffffffff00000000ULL,
                          0xffffffffffffffffULL, 0x00000000fffffffeULL}};

static inline bool geq(const Fe& a, const Fe& b) {
  for (int i = 3; i >= 0; i--) {
    if (a.v[i] > b.v[i]) return true;
    if (a.v[i] < b.v[i]) return false;
  }
  return true;  // equal
}

static inline void sub_raw(Fe& r, const Fe& a, const Fe& b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = u128(a.v[i]) - b.v[i] - uint64_t(borrow);
    r.v[i] = uint64_t(d);
    borrow = (d >> 64) ? 1 : 0;
  }
}

static inline void add_mod(Fe& r, const Fe& a, const Fe& b, const Fe& mod) {
  u128 carry = 0;
  uint64_t t[4];
  for (int i = 0; i < 4; i++) {
    u128 s = u128(a.v[i]) + b.v[i] + uint64_t(carry);
    t[i] = uint64_t(s);
    carry = s >> 64;
  }
  Fe tt = {{t[0], t[1], t[2], t[3]}};
  if (carry || geq(tt, mod)) sub_raw(tt, tt, mod);
  r = tt;
}

static inline void sub_mod(Fe& r, const Fe& a, const Fe& b, const Fe& mod) {
  Fe d;
  if (geq(a, b)) { sub_raw(d, a, b); }
  else { Fe t; sub_raw(t, b, a); sub_raw(d, mod, t); }
  r = d;
}

// Montgomery CIOS multiplication, 64-bit limbs, u128 accumulators.
static void mont_mul(Fe& r, const Fe& a, const Fe& b, const Fe& mod,
                     uint64_t inv) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 s = u128(a.v[i]) * b.v[j] + t[j] + uint64_t(carry);
      t[j] = uint64_t(s);
      carry = s >> 64;
    }
    u128 s = u128(t[4]) + uint64_t(carry);
    t[4] = uint64_t(s);
    t[5] = uint64_t(s >> 64);

    uint64_t m = t[0] * inv;
    carry = 0;
    u128 s0 = u128(m) * mod.v[0] + t[0];
    carry = s0 >> 64;
    for (int j = 1; j < 4; j++) {
      u128 sj = u128(m) * mod.v[j] + t[j] + uint64_t(carry);
      t[j - 1] = uint64_t(sj);
      carry = sj >> 64;
    }
    u128 s4 = u128(t[4]) + uint64_t(carry);
    t[3] = uint64_t(s4);
    t[4] = t[5] + uint64_t(s4 >> 64);
    t[5] = 0;
  }
  Fe out = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || geq(out, mod)) sub_raw(out, out, mod);
  r = out;
}

static inline bool is_zero(const Fe& a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline bool eq(const Fe& a, const Fe& b) {
  return ((a.v[0] ^ b.v[0]) | (a.v[1] ^ b.v[1]) | (a.v[2] ^ b.v[2]) |
          (a.v[3] ^ b.v[3])) == 0;
}

static void from_be32(Fe& r, const uint8_t* be) {
  for (int i = 0; i < 4; i++) {
    uint64_t w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | be[8 * (3 - i) + j];
    r.v[i] = w;
  }
}

// modular inverse via Fermat (mod is prime): a^(mod-2) in Montgomery domain
static void mont_pow(Fe& r, const Fe& a_m, const Fe& e, const Fe& mod,
                     uint64_t inv, const Fe& one_m) {
  Fe acc = one_m;
  for (int i = 255; i >= 0; i--) {
    mont_mul(acc, acc, acc, mod, inv);
    if ((e.v[i / 64] >> (i % 64)) & 1) mont_mul(acc, acc, a_m, mod, inv);
  }
  r = acc;
}

// ---- Jacobian arithmetic (verify-only: data-dependent branches are
// fine, there is no secret to leak).  Same formula choices as the TPU
// kernel (dbl-2001-b a=-3, add-2007-bl, madd-2007-bl) but with the
// exceptional cases handled by explicit branches instead of lane flags.

struct Jac { Fe X, Y, Z; };  // Z == 0 encodes infinity

#define PMUL(r, a, b) mont_mul(r, a, b, P, P_INV)
#define PADD(r, a, b) add_mod(r, a, b, P)
#define PSUB(r, a, b) sub_mod(r, a, b, P)

static void jac_dbl(Jac& R, const Jac& Pp) {
  // dbl-2001-b (a = -3): 3M + 5S
  if (is_zero(Pp.Z)) { R = Pp; return; }
  Fe delta, gamma, beta, alpha, t0, t1, t2;
  PMUL(delta, Pp.Z, Pp.Z);
  PMUL(gamma, Pp.Y, Pp.Y);
  PMUL(beta, Pp.X, gamma);
  PSUB(t0, Pp.X, delta); PADD(t1, Pp.X, delta);
  PMUL(alpha, t0, t1);
  PADD(t0, alpha, alpha); PADD(alpha, t0, alpha);  // alpha *= 3
  Fe X3, Y3, Z3;
  PMUL(X3, alpha, alpha);
  PADD(t0, beta, beta); PADD(t0, t0, t0); PADD(t0, t0, t0);  // 8*beta
  PSUB(X3, X3, t0);
  PADD(Z3, Pp.Y, Pp.Z); PMUL(Z3, Z3, Z3);
  PSUB(Z3, Z3, gamma); PSUB(Z3, Z3, delta);
  PADD(t0, beta, beta); PADD(t0, t0, t0);  // 4*beta
  PSUB(t0, t0, X3); PMUL(Y3, alpha, t0);
  PMUL(t1, gamma, gamma);
  PADD(t2, t1, t1); PADD(t2, t2, t2); PADD(t2, t2, t2);  // 8*gamma^2
  PSUB(Y3, Y3, t2);
  R.X = X3; R.Y = Y3; R.Z = Z3;
}

static void jac_add(Jac& R, const Jac& Pp, const Jac& Q) {
  // add-2007-bl: 11M + 5S, with branch handling for the degeneracies
  if (is_zero(Pp.Z)) { R = Q; return; }
  if (is_zero(Q.Z)) { R = Pp; return; }
  Fe Z1Z1, Z2Z2, U1, U2, S1, S2, t;
  PMUL(Z1Z1, Pp.Z, Pp.Z); PMUL(Z2Z2, Q.Z, Q.Z);
  PMUL(U1, Pp.X, Z2Z2); PMUL(U2, Q.X, Z1Z1);
  PMUL(t, Q.Z, Z2Z2); PMUL(S1, Pp.Y, t);
  PMUL(t, Pp.Z, Z1Z1); PMUL(S2, Q.Y, t);
  Fe H, Rr;
  PSUB(H, U2, U1); PSUB(Rr, S2, S1);
  if (is_zero(H)) {
    if (is_zero(Rr)) { jac_dbl(R, Pp); return; }  // P == Q
    R.X = ONE_M; R.Y = ONE_M;                     // P == -Q: infinity
    R.Z = Fe{{0, 0, 0, 0}};
    return;
  }
  PADD(Rr, Rr, Rr);  // r = 2*(S2-S1)
  Fe I, J, V;
  PADD(t, H, H); PMUL(I, t, t);       // I = (2H)^2
  PMUL(J, H, I);                       // J = H*I
  PMUL(V, U1, I);                      // V = U1*I
  Fe X3, Y3, Z3;
  PMUL(X3, Rr, Rr); PSUB(X3, X3, J);
  PSUB(X3, X3, V); PSUB(X3, X3, V);
  PSUB(t, V, X3); PMUL(Y3, Rr, t);
  PMUL(t, S1, J); PADD(t, t, t);
  PSUB(Y3, Y3, t);
  PADD(Z3, Pp.Z, Q.Z); PMUL(Z3, Z3, Z3);
  PSUB(Z3, Z3, Z1Z1); PSUB(Z3, Z3, Z2Z2); PMUL(Z3, Z3, H);
  R.X = X3; R.Y = Y3; R.Z = Z3;
}

static void jac_madd(Jac& R, const Jac& Pp, const Fe& qx_m, const Fe& qy_m) {
  // madd-2007-bl (Q affine, Z2 = 1): 7M + 4S
  if (is_zero(Pp.Z)) { R.X = qx_m; R.Y = qy_m; R.Z = ONE_M; return; }
  Fe Z1Z1, U2, S2, t;
  PMUL(Z1Z1, Pp.Z, Pp.Z);
  PMUL(U2, qx_m, Z1Z1);
  PMUL(t, Pp.Z, Z1Z1); PMUL(S2, qy_m, t);
  Fe H, Rr;
  PSUB(H, U2, Pp.X); PSUB(Rr, S2, Pp.Y);
  if (is_zero(H)) {
    if (is_zero(Rr)) { jac_dbl(R, Pp); return; }
    R.X = ONE_M; R.Y = ONE_M; R.Z = Fe{{0, 0, 0, 0}};
    return;
  }
  Fe HH, I, J, V;
  PMUL(HH, H, H);
  PADD(I, HH, HH); PADD(I, I, I);  // I = 4*HH
  PMUL(J, H, I);
  PMUL(V, Pp.X, I);
  PADD(Rr, Rr, Rr);  // r = 2*(S2-Y1)
  Fe X3, Y3, Z3;
  PMUL(X3, Rr, Rr); PSUB(X3, X3, J);
  PSUB(X3, X3, V); PSUB(X3, X3, V);
  PSUB(t, V, X3); PMUL(Y3, Rr, t);
  PMUL(t, Pp.Y, J); PADD(t, t, t);
  PSUB(Y3, Y3, t);
  PADD(Z3, Pp.Z, H); PMUL(Z3, Z3, Z3);
  PSUB(Z3, Z3, Z1Z1); PSUB(Z3, Z3, HH);
  R.X = X3; R.Y = Y3; R.Z = Z3;
}

// Fixed 4-bit-window affine G table (Montgomery domain), built once per
// process: GT[k] = (k+1)*G for k = 0..14.  Batch-normalized to affine
// with ONE Fermat inversion (Montgomery's trick).
static Fe GT_X[15], GT_Y[15];

static void build_g_table() {
  Jac pts[15];
  pts[0] = {GX_M, GY_M, ONE_M};
  for (int k = 1; k < 15; k++) jac_madd(pts[k], pts[k - 1], GX_M, GY_M);
  // batch-invert the Z's
  Fe prefix[15], acc = ONE_M;
  for (int k = 0; k < 15; k++) { prefix[k] = acc; PMUL(acc, acc, pts[k].Z); }
  Fe inv_acc, pm2, two = {{2, 0, 0, 0}};
  sub_raw(pm2, P, two);
  mont_pow(inv_acc, acc, pm2, P, P_INV, ONE_M);
  for (int k = 14; k >= 0; k--) {
    Fe zinv, z2, z3;
    PMUL(zinv, inv_acc, prefix[k]);
    PMUL(inv_acc, inv_acc, pts[k].Z);
    PMUL(z2, zinv, zinv); PMUL(z3, z2, zinv);
    PMUL(GT_X[k], pts[k].X, z2);
    PMUL(GT_Y[k], pts[k].Y, z3);
  }
}

#undef PMUL
#undef PADD
#undef PSUB

}  // namespace p256

// Verify one ECDSA signature over a precomputed sha256 digest.
// All inputs big-endian 32-byte: digest z, r, s, pubkey (qx, qy).
// Returns 1 accept / 0 reject.  Matches fastecdsa.ecdsa.verify semantics.
extern "C" int upow_p256_verify(const uint8_t* z_be, const uint8_t* r_be,
                                const uint8_t* s_be, const uint8_t* qx_be,
                                const uint8_t* qy_be) {
  using namespace p256;
  Fe z, r, s, qx, qy;
  from_be32(z, z_be); from_be32(r, r_be); from_be32(s, s_be);
  from_be32(qx, qx_be); from_be32(qy, qy_be);

  // range checks: 0 < r,s < n
  if (is_zero(r) || is_zero(s) || geq(r, N) || geq(s, N)) return 0;
  // on-curve check: qy^2 == qx^3 - 3*qx + b (Montgomery domain)
  Fe qx_m, qy_m, lhs, rhs, t;
  mont_mul(qx_m, qx, P_R2, P, P_INV);
  mont_mul(qy_m, qy, P_R2, P, P_INV);
  mont_mul(lhs, qy_m, qy_m, P, P_INV);
  mont_mul(rhs, qx_m, qx_m, P, P_INV);
  mont_mul(rhs, rhs, qx_m, P, P_INV);
  sub_mod(rhs, rhs, qx_m, P); sub_mod(rhs, rhs, qx_m, P);
  sub_mod(rhs, rhs, qx_m, P);
  add_mod(rhs, rhs, B_M, P);
  if (!eq(lhs, rhs)) return 0;
  if (is_zero(qx) && is_zero(qy)) return 0;

  // scalars mod n (Montgomery domain mod n)
  static const Fe N_ONE_M = {{0x0c46353d039cdaafULL, 0x4319055258e8617bULL,
                              0x0000000000000000ULL, 0x00000000ffffffffULL}};
  Fe s_m, w_m, z_m, r_m, u1, u2, nm2;
  mont_mul(s_m, s, N_R2, N, N_INV);
  // n - 2 for Fermat inverse
  Fe two = {{2, 0, 0, 0}};
  sub_raw(nm2, N, two);
  mont_pow(w_m, s_m, nm2, N, N_INV, N_ONE_M);
  // z reduced mod n implicitly by mont ops? No: reduce first if z >= n.
  Fe z_red = z;
  if (geq(z_red, N)) sub_raw(z_red, z_red, N);
  mont_mul(z_m, z_red, N_R2, N, N_INV);
  mont_mul(r_m, r, N_R2, N, N_INV);
  mont_mul(u1, z_m, w_m, N, N_INV);   // still Montgomery
  mont_mul(u2, r_m, w_m, N, N_INV);
  // strip Montgomery: multiply by 1
  Fe one = {{1, 0, 0, 0}};
  mont_mul(u1, u1, one, N, N_INV);
  mont_mul(u2, u2, one, N, N_INV);

  // Strauss double-scalar walk R = u1*G + u2*Q, 4-bit windows, MSB
  // first: 252 doublings + at most 2 table adds per window (skipped on
  // zero digits).  G adds are mixed (static affine table); the Q table
  // is built per call.  ~3x fewer Montgomery muls than the earlier
  // 256-step always-add complete ladder — verify-only code, so the
  // data-dependent branches are fine.
  {
    static const bool g_ready = []() { build_g_table(); return true; }();
    (void)g_ready;
  }
  Jac QT[15];
  QT[0] = {qx_m, qy_m, ONE_M};
  for (int k = 1; k < 15; k++) jac_madd(QT[k], QT[k - 1], qx_m, qy_m);

  Jac R = {ONE_M, ONE_M, {{0, 0, 0, 0}}};  // infinity
  for (int wi = 63; wi >= 0; wi--) {
    if (wi != 63) {
      jac_dbl(R, R); jac_dbl(R, R); jac_dbl(R, R); jac_dbl(R, R);
    }
    unsigned d1 = unsigned(u1.v[wi / 16] >> (4 * (wi % 16))) & 15u;
    if (d1) jac_madd(R, R, GT_X[d1 - 1], GT_Y[d1 - 1]);
    unsigned d2 = unsigned(u2.v[wi / 16] >> (4 * (wi % 16))) & 15u;
    if (d2) jac_add(R, R, QT[d2 - 1]);
  }
  if (is_zero(R.Z)) return 0;

  // accept iff X == r*Z^2 or X == (r+n)*Z^2 in the field (x mod n == r)
  Fe z2, r_pm, rz;
  mont_mul(z2, R.Z, R.Z, P, P_INV);
  mont_mul(r_pm, r, P_R2, P, P_INV);
  mont_mul(rz, r_pm, z2, P, P_INV);
  if (eq(R.X, rz)) return 1;
  // r + n < p case
  Fe rn;
  u128 carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 sum = u128(r.v[i]) + N.v[i] + uint64_t(carry);
    rn.v[i] = uint64_t(sum);
    carry = sum >> 64;
  }
  if (!carry && geq(P, rn) && !eq(P, rn)) {
    Fe rn_m;
    mont_mul(rn_m, rn, P_R2, P, P_INV);
    mont_mul(rz, rn_m, z2, P, P_INV);
    if (eq(R.X, rz)) return 1;
  }
  return 0;
}

// Batch wrapper: arrays of 32-byte big-endian fields; out[i] in {0,1}.
extern "C" void upow_p256_verify_batch(const uint8_t* z, const uint8_t* r,
                                       const uint8_t* s, const uint8_t* qx,
                                       const uint8_t* qy, size_t n,
                                       uint8_t* out) {
  // embarrassingly parallel — one core per signature when OpenMP is
  // available (the build adds -fopenmp when g++ supports it)
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (size_t i = 0; i < n; i++)
    out[i] = uint8_t(upow_p256_verify(z + 32 * i, r + 32 * i, s + 32 * i,
                                      qx + 32 * i, qy + 32 * i));
}
