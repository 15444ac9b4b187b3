// Batched P-256 ECDSA verify over COMPLETE point formulas: scalar prep +
// an RCB16 Strauss ladder in ONE launch, one thread per signature.
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
// Per lane: the shared scalar prep (p256_common.cuh); a 16-entry Q table
// [k]Q, k = 0..15, in homogeneous projective coordinates (entry 0 the
// identity (0 : 1 : 0), entries 2..15 by complete add); 64 rounds of 4
// doublings (the RCB16 sequence with the same-operand products squared,
// as _ladder_kernel_list doubles), a complete add of the G pick and a
// complete add of the Q pick, a zero digit adding the identity; then
// accept <=> X == r Z or (r + n < p and X == (r + n) Z), with Z != 0.
//
// What bounds it: 32x32-bit integer multiplies, as in p256_verify.cu.  A
// complete add is 12 products + 2 by b, a doubling 6 squarings + 8
// products, so a round is 84 field products against the Jacobian ladder's
// 59 (crypto/p256.py::mults_per_lane(kernel="complete") counts them;
// mul_ops_needed gives the bound).  Bytes are 172 a lane.
//
// What the design does about it: the same one-lane-per-thread layout as
// p256_verify.cu (independent IMAD.WIDE chains, constants broadcast from
// __constant__ memory, values fully reduced so no lazy bound is tracked),
// the 16-entry Q table (1,536 bytes a lane) in local memory, the G pick read
// from the affine [k]G table with Z = 1, 128-thread blocks and a masked
// ragged edge.  A simple kernel first; no batching across lanes.

#include "p256_common.cuh"

// RCB16 Algorithm 4 (complete addition, a = -3), operand order as the JAX
// package's _point_add_rcb16: 12 products + 2 by b.
__device__ __forceinline__ Pt add_complete(const Pt& P, const Pt& Q,
                                           const Fe& b) {
  Fe t0, t1, t2, t3, t4;
  Pt R;
  fmul(t0, P.x, Q.x);
  fmul(t1, P.y, Q.y);
  fmul(t2, P.z, Q.z);
  fadd(t3, P.x, P.y);
  fadd(t4, Q.x, Q.y);
  fmul(t3, t3, t4);
  fadd(t4, t0, t1);
  fsub(t3, t3, t4);
  fadd(t4, P.y, P.z);
  fadd(R.x, Q.y, Q.z);
  fmul(t4, t4, R.x);
  fadd(R.x, t1, t2);
  fsub(t4, t4, R.x);
  fadd(R.x, P.x, P.z);
  fadd(R.y, Q.x, Q.z);
  fmul(R.x, R.x, R.y);
  fadd(R.y, t0, t2);
  fsub(R.y, R.x, R.y);
  fmul(R.z, b, t2);
  fsub(R.x, R.y, R.z);
  fadd(R.z, R.x, R.x);
  fadd(R.x, R.x, R.z);
  fsub(R.z, t1, R.x);
  fadd(R.x, t1, R.x);
  fmul(R.y, b, R.y);
  fadd(t1, t2, t2);
  fadd(t2, t1, t2);
  fsub(R.y, R.y, t2);
  fsub(R.y, R.y, t0);
  fadd(t1, R.y, R.y);
  fadd(R.y, t1, R.y);
  fadd(t1, t0, t0);
  fadd(t0, t1, t0);
  fsub(t0, t0, t2);
  fmul(t1, t4, R.y);
  fmul(t2, t0, R.y);
  fmul(R.y, R.x, R.z);
  fadd(R.y, R.y, t2);
  fmul(t2, t3, R.x);
  fsub(R.x, t2, t1);
  fmul(t2, t4, R.z);
  fmul(t1, t3, t0);
  fadd(R.z, t2, t1);
  return R;
}

// The same sequence with P == Q, the same-operand products squared (the
// JAX package's _point_dbl_rcb16): 6 squarings + 8 products.
__device__ __forceinline__ Pt dbl_complete(const Pt& P, const Fe& b) {
  Fe t0, t1, t2, t3, t4;
  Pt R;
  fsqr(t0, P.x);
  fsqr(t1, P.y);
  fsqr(t2, P.z);
  fadd(t3, P.x, P.y);
  fsqr(t3, t3);
  fadd(t4, t0, t1);
  fsub(t3, t3, t4);
  fadd(t4, P.y, P.z);
  fsqr(t4, t4);
  fadd(R.x, t1, t2);
  fsub(t4, t4, R.x);
  fadd(R.x, P.x, P.z);
  fsqr(R.x, R.x);
  fadd(R.y, t0, t2);
  fsub(R.y, R.x, R.y);
  fmul(R.z, b, t2);
  fsub(R.x, R.y, R.z);
  fadd(R.z, R.x, R.x);
  fadd(R.x, R.x, R.z);
  fsub(R.z, t1, R.x);
  fadd(R.x, t1, R.x);
  fmul(R.y, b, R.y);
  fadd(t1, t2, t2);
  fadd(t2, t1, t2);
  fsub(R.y, R.y, t2);
  fsub(R.y, R.y, t0);
  fadd(t1, R.y, R.y);
  fadd(R.y, t1, R.y);
  fadd(t1, t0, t0);
  fadd(t0, t1, t0);
  fsub(t0, t0, t2);
  fmul(t1, t4, R.y);
  fmul(t2, t0, R.y);
  fmul(R.y, R.x, R.z);
  fadd(R.y, R.y, t2);
  fmul(t2, t3, R.x);
  fsub(R.x, t2, t1);
  fmul(t2, t4, R.z);
  fmul(t1, t3, t0);
  fadd(R.z, t2, t1);
  return R;
}

__global__ void __launch_bounds__(128)
p256_complete_kernel(const u32* __restrict__ packed,
                     int32_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  Prep pr;
  scalar_prep(packed, n, lane, pr);

  Fe b, one_m;
  fe_const(b, C_BP);
  fe_const(one_m, C_ONEP);
  Pt identity;
  fe_zero(identity.x);
  identity.y = one_m;
  fe_zero(identity.z);

  // ---- Q table: [0]Q = identity, [1]Q = Q, [k]Q = [k-1]Q + Q ----------
  Pt qtab[16];
  qtab[0] = identity;
  qtab[1].x = pr.qx_m;
  qtab[1].y = pr.qy_m;
  qtab[1].z = one_m;
  for (int k = 2; k < 16; ++k) qtab[k] = add_complete(qtab[k - 1], qtab[1], b);

  // ---- ladder: 64 rounds of 4 dbl + G add + Q add ----------------------
  Pt acc = identity;
  for (int k = 0; k < 64; ++k) {
#pragma unroll 1
    for (int q = 0; q < 4; ++q) acc = dbl_complete(acc, b);

    const u32 d1 = digit_of(pr.u1, k);
    Pt pick = identity;
    if (d1) {
      const int g = C_G + 16 * (d1 - 1);
      fe_const(pick.x, g);
      fe_const(pick.y, g + NW);
      pick.z = one_m;
    }
    acc = add_complete(acc, pick, b);
    acc = add_complete(acc, qtab[digit_of(pr.u2, k)], b);
  }

  // ---- accept <=> X == r Z or (rn_ok and X == (r+n) Z), Z != 0 ---------
  Fe rz, rnz;
  fmul(rz, pr.r_m, acc.z);
  fmul(rnz, pr.rn_m, acc.z);
  const bool ok = fe_eq(acc.x, rz) || (pr.rn_ok && fe_eq(acc.x, rnz));
  out[lane] = (ok && !fe_is_zero(acc.z) && pr.valid) ? 1 : 0;
}

extern "C" int p256_complete_launch(const void* packed, void* out, int n,
                                    void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  p256_complete_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const u32*)packed, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
