// Batched P-256 ECDSA verify: scalar prep + Jacobian Strauss ladder in ONE
// launch, four threads to a signature.
//
// Replaces upow_tpu/crypto/p256.py::_ladder_kernel_jac (the Pallas kernel)
// together with the XLA program _scalar_prep that fed it, at the windows
// whose tables fit a block's shared memory (PALLAS_JAC_WINDOW,
// UPOW_JAC_WINDOW or device.verify_window): p256_verify_kernel at w = 4
// (the default), p256_verify_w5_kernel at w = 5, p256_verify_w2_kernel and
// p256_verify_w3_kernel at w = 2 and 3, one body templated on W (the group
// steps in p256_jac.cuh; windows 6-13 are p256_verify_wide.cu's, whose Q
// tables live in device memory).  Input: the fused
// (42, N) int32 array of crypto/p256.py::_pack_device_inputs, lane-minor
// (z, r, s, qx, qy as 8 little-endian 32-bit words each, then range_ok and
// rn_ok).  Output: one int32 per lane, bit 0 the verdict, bit 1 the
// exception flag (H == 0 with both operands real; the host oracle decides
// those lanes).  The plain PyTorch version of the same function is
// crypto/p256.py::verify_plain.
//
// Per signature: the shared scalar prep (p256_common.cuh); a 2^W - 1 entry
// Q table [1]Q, [2]Q = dbl, [k]Q = [k-1]Q + Q by madd; ceil(256 / W) rounds
// of W doublings (dbl-2001-b), a mixed add of the affine G pick
// (madd-2007-bl) and a general add of the Q pick (add-2007-bl), MSB-first
// W-bit digits (at w = 5, 52 rounds whose top digit reads zero bits past
// 256, as the JAX package's _digits_from_limbs); a
// zero digit keeps the accumulator, a not-yet-started accumulator takes the
// pick, H == 0 with both operands real flags the lane; then accept <=>
// X == r Z^2 or (r + n < p and X == (r + n) Z^2), with the result finite.
//
// What bounds it: not the card's multiply rate but the latency of one
// signature's dependent chain.  A round is 4 x 8 + 11 + 16 = 59 field
// products (crypto/p256.py::mults_per_lane counts them; mul_ops_needed
// gives the bound), each a CIOS Montgomery product whose carry chain is
// serial.  With one thread to a signature a lane was 4,277 product
// latencies in a row, and 1 lane took 93 % of the time of 8,192.
//
// What the design does about it:
// - A group of four consecutive threads of one warp works on a signature
//   (8 signatures a warp, 32 a 128-thread block).  Rank k of the group
//   computes the k-th product of a step, operands picked by selects so
//   that one instruction stream serves the group; the modular adds
//   between steps are computed by every rank from the products,
//   redundantly.  Each rank writes its product to the signature's slot
//   in shared memory and the group syncs with __syncwarp on its own four
//   lanes.  Two slot sets alternate: a rank reads a step's products
//   before it reaches the next step's sync, so a slot is rewritten only
//   after a sync that every reader of it has passed.
// - The three formulas stay as they are (the exception bits depend on
//   them); only their products are grouped by dependency level, and
//   delta = Z^2, which each formula's first level needs, is computed in
//   the level of the operation before that produces Z (the select of the
//   post-add digits is known before the add, so the selected Z is too).
//   The Q table keeps Z^2 and Z^3 of each entry beside X, Y, Z.  So:
//     dbl  (8 products, 3 steps of 3, 3, 2):
//       1: gamma = Y^2, (Y + Z)^2, (X - delta)(X + delta)
//       2: beta = X gamma, gamma^2, alpha^2
//       3: alpha (4 beta - X3), Z3^2
//     madd (11 products, 4 steps of 2, 3, 4, 2):
//       1: U2 = x2 Z1Z1, Z1 Z1Z1
//       2: S2 = y2 Z1^3, HH = H^2, (Z1 + H)^2
//       3: J = H I, V = X1 I, rr^2, Zsel^2
//       4: Y1 J, rr (V - X3)
//     add  (14 products, 4 steps of 4, 3, 4, 3; Z2Z2, Z2^3 from the table):
//       1: U1 = X1 Z2Z2, U2 = X2 Z1Z1, Z1 Z1Z1, S1 = Y1 Z2^3
//       2: S2 = Y2 Z1^3, I = (2H)^2, (Z1 + Z2)^2
//       3: J = H I, V = U1 I, rr^2, Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
//       4: S1 J, rr (V - X3), Zsel^2
//   A round is 4 x 3 + 4 + 4 = 20 product latencies instead of 59.  With
//   the serial prep (341 mod-n products), the Q table (one dbl, 13 madds
//   and one Z^3: 56 steps) and the final test (1 step), a lane's chain is
//   about 1,678 latencies instead of 4,277.
// - Idle ranks: a step of fewer than four products has its idle ranks
//   compute a copy of one of them (a select, no branch), so it costs issue
//   slots, not latency: 57 of a round's 80 rank-products are needed (71 %;
//   dbl 8 of 12, madd 11 of 16, add 14 of 16).  A group of four still fits
//   best: three threads would need 4 steps for the add and 5 for the
//   madd, and eight would leave most ranks idle in every step, while
//   four reuses the group sync and the g++ group shim of p256_complete.cu.
// - The field code is p256_common.cuh's, unchanged: Montgomery form with
//   R = 2^256, values always fully reduced, so a sum's canonical value
//   does not depend on the order of its terms and the grouped formulas
//   equal the sequential ones bit for bit (exception bits included).
// - Tables in shared memory: the Q table one copy a signature (2^W - 1
//   entries of 160 B: X, Y, Z, Z^2, Z^3), the affine [k]G table (2^W - 1
//   entries of 64 B) once a block.  No local-memory table and no divergent
//   __constant__ reads in the ladder.  A block needs 28,352 B at w = 2,
//   49,088 B at w = 3, 90,560 B at w = 4 and 173,504 B at w = 5
//   (Ladder<W>::SMEM_BYTES), mostly above the 48 KB static
//   limit, so it is dynamic shared memory raised by cudaFuncSetAttribute in
//   the launch function; two 128-thread blocks fit an SM at w = 4, one at
//   w = 5 (32 signatures an SM either way at w = 5: 16 signatures a block
//   would fit two blocks of half the size, the same count).
// - w = 3's and w = 5's digits straddle the 32-bit words of u1 and u2
//   (bit W k + W - 1 may lie in the next word); window_digit joins the two
//   words, and the top digit (bits 255..257 at w = 3, 255..259 at w = 5)
//   reads only word 7.  The scalar prep's inversion
//   keeps its own fixed 4-bit window whatever W, as in the JAX package.
// - The scalar prep (341 serial mod-n products) runs on rank 0 and hands
//   u1, u2, Q, r and r + n to the group through shared memory.  Rank 0
//   makes the final test and writes the verdict.
// - The ragged edge is masked by whole groups: a group past n exits after
//   the block's one __syncthreads, and every later sync names only the
//   group's own four lanes, so no thread waits on one that left.

#include "p256_jac.cuh"

// The ladder of window W and its shared memory, in 32-bit words: the
// block's [k]G table, then one area a signature.
template <int W>
struct Ladder {
  static constexpr int ROUNDS = (256 + W - 1) / W;  // 64 at w = 4, 52 at 5
  static constexpr int TABLE = (1 << W) - 1;        // [1]P .. [TABLE]P
  static constexpr int G_WORDS = TABLE * G_ENTRY;
  static constexpr int S_SLOT = TABLE * Q_ENTRY;    // two sets of GROUP
                                                    // product slots
  static constexpr int S_U1 = S_SLOT + 2 * GROUP * NW;  // u1, plain (digits)
  static constexpr int S_U2 = S_U1 + NW;            // u2, plain
  static constexpr int S_RM = S_U2 + NW;            // r R mod p
  static constexpr int S_RNM = S_RM + NW;           // (r + n) R mod p
  static constexpr int S_FLAGS = S_RNM + NW;        // bit 0 valid, bit 1
                                                    // r + n < p
  static constexpr int SIG_WORDS = S_FLAGS + 4;     // padded to 16 bytes
  static constexpr int SMEM_BYTES = 4 * (G_WORDS + SIGS * SIG_WORDS);
};

// The k-th W-bit digit of the plain 256-bit value u (8 little-endian
// words), from the most significant end.  A digit may straddle two words
// (never at w = 4); the top digit of an uneven split reads zero bits past
// 256.
template <int W>
__device__ __forceinline__ u32 window_digit(const u32* u, int k) {
  const int bit = W * (Ladder<W>::ROUNDS - 1 - k);
  const int word = bit >> 5, off = bit & 31;
  u32 v = u[word] >> off;
  if (off + W > 32 && word + 1 < NW) v |= u[word + 1] << (32 - off);
  return v & ((1u << W) - 1);
}

// One signature's verify on its group of four, at window W; smem is the
// block's dynamic shared memory (Ladder<W>::SMEM_BYTES).
template <int W>
__device__ __forceinline__ void verify_body(const u32* __restrict__ packed,
                                            int32_t* __restrict__ out, int n,
                                            u32* smem) {
  typedef Ladder<W> L;
  const int rank = threadIdx.x & (GROUP - 1);
  const int local = threadIdx.x / GROUP;
  const int sig = blockIdx.x * SIGS + local;
  u32* gtab = smem;                                 // the block's [k]G
  u32* area = smem + L::G_WORDS + local * L::SIG_WORDS;  // this signature's
  u32* qtab = area;

  // ---- the affine [k]G table, once a block ----------------------------
  for (int i = threadIdx.x; i < L::G_WORDS; i += THREADS)
    gtab[i] = c_k[C_G + i];
  __syncthreads();
  if (sig >= n) return;  // the whole group: all four ranks share sig
  Group g;
  g.slots = area + L::S_SLOT;
  g.rank = rank;
  g.mask = 0xFu << (threadIdx.x & 31 & ~(GROUP - 1));
  g.set = 0;

  Fe one_m;
  fe_const(one_m, C_ONEP);

  // ---- scalar prep on rank 0, handed to the group ---------------------
  if (rank == 0) {
    Prep pr;
    scalar_prep(packed, n, sig, pr);
    st(area + L::S_U1, pr.u1);
    st(area + L::S_U2, pr.u2);
    st(area + L::S_RM, pr.r_m);
    st(area + L::S_RNM, pr.rn_m);
    area[L::S_FLAGS] = (pr.valid ? 1u : 0u) | (pr.rn_ok ? 2u : 0u);
    st(qtab, pr.qx_m);                   // [1]Q = (qx, qy, 1), Z^2 = Z^3 = 1
    st(qtab + NW, pr.qy_m);
    st(qtab + 2 * NW, one_m);
    st(qtab + 3 * NW, one_m);
    st(qtab + 4 * NW, one_m);
  }
  __syncwarp(g.mask);

  // ---- Q table: [2]Q = dbl, [k]Q = [k-1]Q + Q (madd chain) ------------
  Fe qx, qy, H, zc;
  ld(qx, qtab);
  ld(qy, qtab + NW);
  Pt acc, res;
  acc.x = qx;
  acc.y = qy;
  acc.z = one_m;
  Fe d = one_m;                          // 1^2
  dbl_group(acc, d, g);
#pragma unroll 1
  for (int k = 2; k <= L::TABLE; ++k) {
    u32* e = qtab + (k - 1) * Q_ENTRY;   // [k]Q: ranks store X, Y, Z, Z^2
    Fe f;
    pick(f, rank, acc.x, acc.y, acc.z, d);
    st(e + rank * NW, f);
    if (k == L::TABLE) break;
    madd_group(res, H, zc, acc, d, qx, qy, one_m, 2, g);
    if (rank == 0) st(e + 4 * NW, zc);   // Z^3 of [k]Q
    acc = res;
  }
  {
    const u32* s = step(g, acc.z, d);    // Z^3 of [TABLE]Q
    if (rank == 0) {
      Fe f;
      ld(f, s);
      st(qtab + (L::TABLE - 1) * Q_ENTRY + 4 * NW, f);
    }
  }                                      // the ladder's first sync orders
                                         // these stores before any read

  // ---- ladder: ROUNDS rounds of W dbl + G madd + Q add ----------------
  acc.x = one_m;
  acc.y = one_m;
  fe_zero(acc.z);
  fe_zero(d);                            // 0^2
  bool started = false, exc = false;
#pragma unroll 1
  for (int k = 0; k < L::ROUNDS; ++k) {
    const u32 d1 = window_digit<W>(area + L::S_U1, k);
    const u32 d2 = window_digit<W>(area + L::S_U2, k);
#pragma unroll 1
    for (int q = 0; q < W; ++q) dbl_group(acc, d, g);

    Fe gx, gy;
    const u32* ge = gtab + (d1 ? d1 - 1 : 0) * G_ENTRY;
    ld(gx, ge);
    ld(gy, ge + NW);
    int sel = d1 == 0 ? 0 : started ? 2 : 1;
    madd_group(res, H, zc, acc, d, gx, gy, one_m, sel, g);
    apply_add(acc, res, H, gx, gy, one_m, sel, exc);
    started = started || d1 != 0;

    const u32* qe = qtab + (d2 ? d2 - 1 : 0) * Q_ENTRY;
    sel = d2 == 0 ? 0 : started ? 2 : 1;
    add_group(res, H, acc, d, qe, sel, g);
    Fe px, py, pz;
    ld(px, qe);
    ld(py, qe + NW);
    ld(pz, qe + 2 * NW);
    apply_add(acc, res, H, px, py, pz, sel, exc);
    started = started || d2 != 0;
  }

  // ---- accept <=> X == r Z^2 or (rn_ok and X == (r+n) Z^2), R finite ---
  Fe r_m, rn_m, a;
  ld(r_m, area + L::S_RM);
  ld(rn_m, area + L::S_RNM);
  pick(a, rank, r_m, rn_m, rn_m, rn_m);
  const u32* s = step(g, a, d);          // d = Z^2
  if (rank == 0) {
    Fe rz, rnz;
    ld(rz, s);
    ld(rnz, s + NW);
    const u32 flags = area[L::S_FLAGS];
    const bool at_inf = fe_is_zero(acc.z) || !started;
    const bool ok = fe_eq(acc.x, rz) || ((flags & 2u) && fe_eq(acc.x, rnz));
    const bool verdict = ok && !at_inf && (flags & 1u);
    out[sig] = (verdict ? 1 : 0) | (exc ? 2 : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
p256_verify_kernel(const u32* __restrict__ packed, int32_t* __restrict__ out,
                   int n) {
  extern __shared__ u32 smem[];
  verify_body<4>(packed, out, n, smem);
}

__global__ void __launch_bounds__(THREADS)
p256_verify_w5_kernel(const u32* __restrict__ packed,
                      int32_t* __restrict__ out, int n) {
  extern __shared__ u32 smem[];
  verify_body<5>(packed, out, n, smem);
}

__global__ void __launch_bounds__(THREADS)
p256_verify_w2_kernel(const u32* __restrict__ packed,
                      int32_t* __restrict__ out, int n) {
  extern __shared__ u32 smem[];
  verify_body<2>(packed, out, n, smem);
}

__global__ void __launch_bounds__(THREADS)
p256_verify_w3_kernel(const u32* __restrict__ packed,
                      int32_t* __restrict__ out, int n) {
  extern __shared__ u32 smem[];
  verify_body<3>(packed, out, n, smem);
}

extern "C" int p256_verify_launch(const void* packed, void* out, int n,
                                  void* stream) {
  if (n <= 0) return 0;
  const int smem = Ladder<4>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      p256_verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  p256_verify_kernel<<<(n + SIGS - 1) / SIGS, THREADS, smem,
                       (cudaStream_t)stream>>>((const u32*)packed,
                                               (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// The same ladder at another window W: kernel B7 at w = 5, and w = 2 and
// 3 (the top digit of w = 3's 86 rounds reads two zero bits past 256).
template <int W>
static int launch_window(void (*kernel)(const u32*, int32_t*, int),
                         const void* packed, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int smem = Ladder<W>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + SIGS - 1) / SIGS, THREADS, smem, (cudaStream_t)stream>>>(
      (const u32*)packed, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int p256_verify_w5_launch(const void* packed, void* out, int n,
                                     void* stream) {
  return launch_window<5>(p256_verify_w5_kernel, packed, out, n, stream);
}

extern "C" int p256_verify_w2_launch(const void* packed, void* out, int n,
                                     void* stream) {
  return launch_window<2>(p256_verify_w2_kernel, packed, out, n, stream);
}

extern "C" int p256_verify_w3_launch(const void* packed, void* out, int n,
                                     void* stream) {
  return launch_window<3>(p256_verify_w3_kernel, packed, out, n, stream);
}

// The launch's shape and a kernel's resources: threads a signature,
// threads a block, shared bytes a block, registers a thread, local
// (stack) bytes a thread.
static int attributes(const void* kernel, int smem, int* out5) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  out5[0] = GROUP;
  out5[1] = THREADS;
  out5[2] = smem;
  out5[3] = fa.numRegs;
  out5[4] = (int)fa.localSizeBytes;
  return 0;
}

extern "C" int p256_verify_attributes(int* out5) {
  return attributes((const void*)p256_verify_kernel, Ladder<4>::SMEM_BYTES,
                    out5);
}

extern "C" int p256_verify_w5_attributes(int* out5) {
  return attributes((const void*)p256_verify_w5_kernel,
                    Ladder<5>::SMEM_BYTES, out5);
}

extern "C" int p256_verify_w2_attributes(int* out5) {
  return attributes((const void*)p256_verify_w2_kernel,
                    Ladder<2>::SMEM_BYTES, out5);
}

extern "C" int p256_verify_w3_attributes(int* out5) {
  return attributes((const void*)p256_verify_w3_kernel,
                    Ladder<3>::SMEM_BYTES, out5);
}
