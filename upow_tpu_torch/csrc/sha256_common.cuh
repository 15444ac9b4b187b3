// SHA-256 compression as a device function, shared by the port's kernels.
//
// One call runs the 64 rounds over 16 message words from a given state:
// the nonce search (sha256_search.cu) starts it from a template's midstate,
// and the batched digests (sha256_blocks.cu) chain it from the initial
// state over each message's blocks.  Fully unrolled, so the 16-word schedule window and the 8 working
// words live in registers, every rotate is one funnel shift (SHF) and the
// round constants are constant-bank operands of the adds.

#pragma once

#include <cstdint>

namespace sha256 {

typedef uint32_t u32;

__constant__ const u32 kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

__device__ __forceinline__ u32 rotr(u32 x, u32 n) {
  return __funnelshift_r(x, x, n);
}

// st: the 8-word state, updated in place (st += compress(st, w)).
// w: the 16 message words; clobbered (it ends as the last schedule window).
__device__ __forceinline__ void compress(u32 st[8], u32 w[16]) {
  u32 a = st[0], b = st[1], c = st[2], d = st[3];
  u32 e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      // w[i] = w[i-16] + s0(w[i-15]) + w[i-7] + s1(w[i-2]), in a ring of 16
      const u32 w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const u32 s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const u32 s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[i & 15] += s0 + w[(i - 7) & 15] + s1;
    }
    const u32 S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const u32 ch = (e & f) ^ (~e & g);
    const u32 t1 = h + S1 + ch + kK[i] + w[i & 15];
    const u32 S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const u32 maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

}  // namespace sha256
