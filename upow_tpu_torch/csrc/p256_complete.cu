// Batched P-256 ECDSA verify over COMPLETE point formulas: scalar prep +
// an RCB16 Strauss ladder in ONE launch, four threads to a signature.
//
// Replaces the two Pallas kernels of the JAX package's complete-formula
// path, upow_tpu/crypto/p256.py::_ladder_kernel_list (the limb-list
// layout, launched by _verify_device_pallas) and ::_ladder_kernel (the
// stacked (L, N) layout with the G table as an input, launched by
// _verify_device_pallas_stacked).  Both compute one function; their two
// layouts were TPU VMEM choices and have no counterpart here.  Input: the
// same fused (42, N) int32 array as p256_verify.cu.  Output: one int32 per
// lane, bit 0 the verdict; bit 1 is always 0, since complete formulas have
// no exceptional inputs (crafted collision lanes get their true verdict
// here, where the Jacobian kernel flags them for the host oracle).  The
// plain PyTorch version of the same function is
// crypto/p256.py::verify_complete_plain.
//
// Per signature: the shared scalar prep (p256_common.cuh); a 16-entry Q
// table [k]Q, k = 0..15, in homogeneous projective coordinates (entry 0
// the identity (0 : 1 : 0), entries 2..15 by complete add); 64 rounds of 4
// doublings, a complete add of the G pick and a complete add of the Q
// pick, a zero digit adding the identity; then accept <=> X == r Z or
// (r + n < p and X == (r + n) Z), with Z != 0.
//
// What bounds it: not the card's multiply rate but the latency of one
// signature's dependent chain.  A complete add is 12 products + 2 by b (a
// doubling the same with 6 of them squares), 84 field products a round
// (crypto/p256.py::mults_per_lane(kernel="complete") counts them;
// mul_ops_needed gives the bound), each a CIOS Montgomery product whose
// carry chain is serial, and 27-29 modular adds between them.  With one
// thread to a signature, a round was 84 product latencies in a row, and
// 8,192 signatures filled 64 SMs with one warp a scheduler: nothing hid a
// stall, and 1 signature took 93 % of 8,192's time.
//
// What the design does about it:
// - A group of four consecutive threads of one warp works on a signature
//   (8 signatures a warp, 32 a 128-thread block).  8,192 signatures are
//   32,768 threads, about two warps a scheduler on every SM.
// - RCB16's 14 products depend on each other in four levels, so each add
//   or doubling runs in four product steps (rank k of the group computes
//   the k-th product of a step), operand order as the JAX package's
//   _point_add_rcb16, the doubling being the same add with P == Q (a
//   product of a value with itself is the squaring, bit for bit):
//     1: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, m3 = (X1 + Y1)(X2 + Y2)
//     2: m4 = (Y1 + Z1)(Y2 + Z2), m5 = (X1 + Z1)(X2 + Z2), b t2, t3 t0'
//        with t3 = m3 - t0 - t1, t0' = 3 t0 - 3 t2
//     3: b Ry, Rx Rz, t3 Rx, t4 Rz with Ry = m5 - t0 - t2,
//        W = 3 (Ry - b t2), Rx = t1 + W, Rz = t1 - W, t4 = m4 - t1 - t2
//     4: t4 Ry', t0' Ry' with Ry' = 3 (b Ry - 3 t2 - t0)
//   then X3 = t3 Rx - t4 Ry', Y3 = Rx Rz + t0' Ry', Z3 = t4 Rz + t3 t0'.
//   A round is 24 product latencies instead of 84.
// - Each rank writes its product to the signature's slot in shared memory
//   (one slot set a step, so a slot is rewritten only after a later group
//   sync) and the group syncs with __syncwarp on its own four lanes.  The
//   modular adds and subtractions between steps are computed by every rank
//   from the slots, redundantly: that saves an exchange per step and costs
//   instructions (adds, selects and logic are over half of a ladder
//   round's).  A rank picks its operands by selects, so the four ranks run
//   one instruction stream and one product.
// - The field code is p256_common.cuh's, unchanged: Montgomery form with
//   R = 2^256, values always fully reduced (so the canonical result of a
//   sum does not depend on the order of its terms).
// - Tables in shared memory: the Q table one copy a signature (16 x 96 B,
//   built on the 4-step add), the affine [k]G table (with the identity as
//   entry 0 and Z = 1) once a block.  No local-memory table and no
//   divergent __constant__ reads in the ladder.  A block needs 69,632 B,
//   above the 48 KB static limit, so it is dynamic shared memory raised by
//   cudaFuncSetAttribute in the launch function; 128-thread blocks keep 32
//   signatures a block and fit 3 blocks an SM.
// - The scalar prep (341 serial mod-n products) runs on rank 0 and hands
//   u1, u2, Q, r and r + n to the group through shared memory.  With the
//   ladder 3.5x shorter it is 341 of the chain's 1,935 product latencies
//   (prep, 14 table adds x 4, 384 ladder operations x 4, the final 2),
//   close to a fifth.  Rank 0 makes the final test and writes the verdict.
// - The ragged edge is masked by whole groups: a group past n exits after
//   the block's one __syncthreads, and every later sync names only the
//   group's own four lanes, so no thread waits on one that left.

#include "p256_common.cuh"

#define GROUP 4                     // threads a signature
#define THREADS 128                 // threads a block
#define SIGS (THREADS / GROUP)      // signatures a block
#define PT_WORDS (3 * NW)           // one projective point
#define TAB_WORDS (16 * PT_WORDS)   // a 16-entry point table

// one signature's shared area, in 32-bit words
#define S_SLOT TAB_WORDS            // 14 product slots: steps at 0, 4, 8, 12
#define S_U1 (S_SLOT + 14 * NW)     // u1, plain (window digits)
#define S_U2 (S_U1 + NW)            // u2, plain
#define S_RM (S_U2 + NW)            // r R mod p
#define S_RNM (S_RM + NW)           // (r + n) R mod p
#define S_FLAGS (S_RNM + NW)        // bit 0 valid, bit 1 r + n < p
#define SIG_WORDS (S_FLAGS + 4)     // padded to 16 bytes
#define SMEM_BYTES (4 * (TAB_WORDS + SIGS * SIG_WORDS))

__device__ __forceinline__ void ld(Fe& r, const u32* s) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = s[j];
}

__device__ __forceinline__ void st(u32* s, const Fe& a) {
#pragma unroll
  for (int j = 0; j < NW; ++j) s[j] = a.v[j];
}

__device__ __forceinline__ void ld_pt(Pt& p, const u32* s) {
  ld(p.x, s);
  ld(p.y, s + NW);
  ld(p.z, s + 2 * NW);
}

// r = a[rank] by selects, so that every rank runs the same instructions
__device__ __forceinline__ void pick(Fe& r, int rank, const Fe& a0,
                                     const Fe& a1, const Fe& a2,
                                     const Fe& a3) {
#pragma unroll
  for (int j = 0; j < NW; ++j)
    r.v[j] = rank == 0 ? a0.v[j]
           : rank == 1 ? a1.v[j]
           : rank == 2 ? a2.v[j] : a3.v[j];
}

__device__ __forceinline__ void triple(Fe& r, const Fe& a) {
  Fe t;
  fadd(t, a, a);
  fadd(r, t, a);
}

// One group step: rank's product a * c into slot[rank], then the group's
// sync; afterwards slot[0..3] hold the step's four products.
__device__ __forceinline__ void step(u32* slot, int rank, unsigned gmask,
                                     const Fe& a, const Fe& c) {
  Fe p;
  fmul(p, a, c);
  st(slot + rank * NW, p);
  __syncwarp(gmask);
}

// R = P + Q by RCB16 Algorithm 4 (complete, a = -3) on the group's four
// threads in four product steps (see the header); every rank returns R.
__device__ __forceinline__ void add_group(Pt& R, const Pt& P, const Pt& Q,
                                          const Fe& b, u32* slot, int rank,
                                          unsigned gmask) {
  Fe a, c, s, t0, t1, t2, m3, t3, t0p, t2x3, m4, m5, bt2, t3t0p;
  Fe ry, w, rx, rz, t4, bry, ryp, rxrz, t3rx, t4rz;
  Fe pxy, qxy, pyz, qyz, pxz, qxz;

  // step 1: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, m3 = (X1 + Y1)(X2 + Y2)
  fadd(pxy, P.x, P.y);
  fadd(qxy, Q.x, Q.y);
  pick(a, rank, P.x, P.y, P.z, pxy);
  pick(c, rank, Q.x, Q.y, Q.z, qxy);
  step(slot, rank, gmask, a, c);
  ld(t0, slot);
  ld(t1, slot + NW);
  ld(t2, slot + 2 * NW);
  ld(m3, slot + 3 * NW);
  fadd(s, t0, t1);
  fsub(t3, m3, s);                       // t3 = m3 - t0 - t1
  triple(t2x3, t2);
  triple(s, t0);
  fsub(t0p, s, t2x3);                    // t0' = 3 t0 - 3 t2

  // step 2: m4 = (Y1 + Z1)(Y2 + Z2), m5 = (X1 + Z1)(X2 + Z2), b t2, t3 t0'
  fadd(pyz, P.y, P.z);
  fadd(qyz, Q.y, Q.z);
  fadd(pxz, P.x, P.z);
  fadd(qxz, Q.x, Q.z);
  pick(a, rank, pyz, pxz, b, t3);
  pick(c, rank, qyz, qxz, t2, t0p);
  step(slot + 4 * NW, rank, gmask, a, c);
  ld(m4, slot + 4 * NW);
  ld(m5, slot + 5 * NW);
  ld(bt2, slot + 6 * NW);
  ld(t3t0p, slot + 7 * NW);
  fadd(s, t0, t2);
  fsub(ry, m5, s);                       // Ry = m5 - t0 - t2
  fsub(s, ry, bt2);
  triple(w, s);                          // W = 3 (Ry - b t2)
  fadd(rx, t1, w);
  fsub(rz, t1, w);
  fadd(s, t1, t2);
  fsub(t4, m4, s);                       // t4 = m4 - t1 - t2

  // step 3: b Ry, Rx Rz, t3 Rx, t4 Rz
  pick(a, rank, b, rx, t3, t4);
  pick(c, rank, ry, rz, rx, rz);
  step(slot + 8 * NW, rank, gmask, a, c);
  ld(bry, slot + 8 * NW);
  ld(rxrz, slot + 9 * NW);
  ld(t3rx, slot + 10 * NW);
  ld(t4rz, slot + 11 * NW);
  fsub(s, bry, t2x3);
  fsub(s, s, t0);
  triple(ryp, s);                        // Ry' = 3 (b Ry - 3 t2 - t0)

  // step 4: t4 Ry', t0' Ry' (ranks 2 and 3 repeat them and store nothing)
  pick(a, rank, t4, t0p, t4, t0p);
  fmul(s, a, ryp);
  if (rank < 2) st(slot + (12 + rank) * NW, s);
  __syncwarp(gmask);
  ld(a, slot + 12 * NW);                 // t4 Ry'
  ld(c, slot + 13 * NW);                 // t0' Ry'
  fsub(R.x, t3rx, a);
  fadd(R.y, rxrz, c);
  fadd(R.z, t4rz, t3t0p);
}

__global__ void __launch_bounds__(THREADS)
p256_complete_kernel(const u32* __restrict__ packed,
                     int32_t* __restrict__ out, int n) {
  extern __shared__ u32 smem[];
  const int rank = threadIdx.x & (GROUP - 1);
  const int local = threadIdx.x / GROUP;
  const int sig = blockIdx.x * SIGS + local;
  u32* gtab = smem;                                    // the block's [k]G
  u32* area = smem + TAB_WORDS + local * SIG_WORDS;    // this signature's
  u32* qtab = area;
  u32* slot = area + S_SLOT;

  // ---- the affine [k]G table, once a block: entry 0 the identity ------
  for (int i = threadIdx.x; i < TAB_WORDS; i += THREADS) {
    const int e = i / PT_WORDS, c = (i % PT_WORDS) / NW, j = i % NW;
    u32 v;
    if (e == 0) v = c == 1 ? c_k[C_ONEP + j] : 0u;    // (0 : 1 : 0)
    else if (c == 2) v = c_k[C_ONEP + j];             // Z = 1
    else v = c_k[C_G + 16 * (e - 1) + NW * c + j];    // x R, y R mod p
    gtab[i] = v;
  }
  __syncthreads();
  if (sig >= n) return;  // the whole group: all four ranks share sig
  const unsigned gmask = 0xFu << (threadIdx.x & 31 & ~(GROUP - 1));

  Fe b, one_m;
  fe_const(b, C_BP);
  fe_const(one_m, C_ONEP);

  // ---- scalar prep on rank 0, handed to the group ---------------------
  if (rank == 0) {
    Prep pr;
    scalar_prep(packed, n, sig, pr);
    st(area + S_U1, pr.u1);
    st(area + S_U2, pr.u2);
    st(area + S_RM, pr.r_m);
    st(area + S_RNM, pr.rn_m);
    area[S_FLAGS] = (pr.valid ? 1u : 0u) | (pr.rn_ok ? 2u : 0u);
    st(qtab + PT_WORDS, pr.qx_m);        // [1]Q = (qx : qy : 1)
    st(qtab + PT_WORDS + NW, pr.qy_m);
    st(qtab + PT_WORDS + 2 * NW, one_m);
  }
  __syncwarp(gmask);

  // ---- Q table: [0]Q = identity, [1]Q = Q, [k]Q = [k-1]Q + Q ----------
  Pt q, acc;
  ld_pt(q, qtab + PT_WORDS);
  acc = q;
  for (int i = rank; i < PT_WORDS; i += GROUP)
    qtab[i] = gtab[i];                   // the identity, as in the G table
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    add_group(acc, acc, q, b, slot, rank, gmask);
    Fe f;                                // ranks 0, 1, 2 store X, Y, Z
    pick(f, rank, acc.x, acc.y, acc.z, acc.z);
    if (rank < 3) st(qtab + k * PT_WORDS + rank * NW, f);
  }
  __syncwarp(gmask);

  // ---- ladder: 64 rounds of 4 dbl + G add + Q add ----------------------
  ld_pt(acc, gtab);                      // the identity
#pragma unroll 1
  for (int k = 0; k < 64; ++k) {
    const int bit = 4 * (63 - k);
    const u32 d1 = (area[S_U1 + (bit >> 5)] >> (bit & 31)) & 0xFu;
    const u32 d2 = (area[S_U2 + (bit >> 5)] >> (bit & 31)) & 0xFu;
#pragma unroll 1
    for (int op = 0; op < 6; ++op) {
      Pt other = acc;
      if (op == 4) ld_pt(other, gtab + d1 * PT_WORDS);
      if (op == 5) ld_pt(other, qtab + d2 * PT_WORDS);
      add_group(acc, acc, other, b, slot, rank, gmask);
    }
  }

  // ---- accept <=> X == r Z or (rn_ok and X == (r+n) Z), Z != 0 ---------
  if (rank == 0) {
    Fe r_m, rn_m, rz, rnz;
    ld(r_m, area + S_RM);
    ld(rn_m, area + S_RNM);
    const u32 flags = area[S_FLAGS];
    fmul(rz, r_m, acc.z);
    fmul(rnz, rn_m, acc.z);
    const bool ok = fe_eq(acc.x, rz) || ((flags & 2u) && fe_eq(acc.x, rnz));
    out[sig] = (ok && !fe_is_zero(acc.z) && (flags & 1u)) ? 1 : 0;
  }
}

extern "C" int p256_complete_launch(const void* packed, void* out, int n,
                                    void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      p256_complete_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + SIGS - 1) / SIGS;
  p256_complete_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const u32*)packed, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// The launch's shape and the kernel's resources: threads a signature,
// threads a block, shared bytes a block, registers a thread, local
// (stack) bytes a thread.
extern "C" int p256_complete_attributes(int* out5) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, p256_complete_kernel);
  if (err != cudaSuccess) return (int)err;
  out5[0] = GROUP;
  out5[1] = THREADS;
  out5[2] = SMEM_BYTES;
  out5[3] = fa.numRegs;
  out5[4] = (int)fa.localSizeBytes;
  return 0;
}
