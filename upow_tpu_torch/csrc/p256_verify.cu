// Batched P-256 ECDSA verify: scalar prep + Jacobian Strauss ladder in ONE
// launch, one thread per signature.
//
// Replaces upow_tpu/crypto/p256.py::_ladder_kernel_jac (the Pallas kernel)
// together with the XLA program _scalar_prep that fed it.  Input: the fused
// (42, N) int32 array of crypto/p256.py::_pack_device_inputs, lane-minor
// (z, r, s, qx, qy as 8 little-endian 32-bit words each, then range_ok and
// rn_ok).  Output: one int32 per lane, bit 0 the verdict, bit 1 the
// exception flag (H == 0 with both operands real; the host oracle decides
// those lanes).  The plain PyTorch version of the same function is
// crypto/p256.py::verify_plain.
//
// What bounds it: 32x32-bit integer multiplies.  Each lane does 4,277
// Montgomery products (crypto/p256.py::mults_per_lane counts them from this
// code, by kind: 341 mod n for s^-1, u1 and u2; 6 mod p for the forms and
// the on-curve check; 151 for the Q table; 64 x (4 x 8 + 11 + 16) = 3,776
// for the ladder; 3 for the final test), and each product here is a
// generic CIOS multiply over 8 x 32-bit limbs: 128 32x32->64 multiplies
// and 8 low-half ones.  The function needs fewer: a squaring needs 36 wide
// products, not 64, and p's Solinas form makes reduction mod p free of
// multiplies (crypto/p256.py::MUL_OPS, mul_ops_needed).  Bytes are
// negligible: 172 per lane.
//
// What the design does about it: one thread owns one lane, so every limb
// product is an independent IMAD.WIDE with no cross-thread traffic, and
// the modulus and Montgomery constants sit in __constant__ memory, read
// at uniform addresses (a broadcast).  Values are kept fully reduced below
// the modulus (one conditional subtraction per product), so no lazy bound
// has to be tracked.  This first version keeps the 15-entry Q table
// (1,440 bytes a lane) and the 16-entry inversion table in local memory
// and spends the G-table reads on divergent __constant__ addresses; blocks
// are 128 threads with a masked ragged edge and no padding of N.  The field
// arithmetic and the scalar prep are in p256_common.cuh, shared with the
// complete-formula kernel (p256_complete.cu).

#include "p256_common.cuh"

// dbl-2001-b (a = -3): 3M + 5S.
__device__ __forceinline__ Pt jac_dbl(const Pt& P) {
  Fe delta, gamma, beta, alpha, t1, t2, beta4, beta8, g8;
  Pt R;
  fsqr(delta, P.z);
  fsqr(gamma, P.y);
  fmul(beta, P.x, gamma);
  fsub(t1, P.x, delta);
  fadd(t2, P.x, delta);
  fmul(alpha, t1, t2);
  fadd(t1, alpha, alpha);
  fadd(alpha, t1, alpha);                 // 3 (X - delta)(X + delta)
  fadd(beta4, beta, beta);
  fadd(beta4, beta4, beta4);              // 4 beta
  fadd(beta8, beta4, beta4);              // 8 beta
  fsqr(t1, alpha);
  fsub(R.x, t1, beta8);                   // X3 = alpha^2 - 8 beta
  fsqr(g8, gamma);
  fadd(g8, g8, g8);
  fadd(g8, g8, g8);
  fadd(g8, g8, g8);                       // 8 gamma^2
  fsub(t1, beta4, R.x);
  fmul(t2, alpha, t1);
  fsub(R.y, t2, g8);                      // Y3 = alpha (4 beta - X3) - 8 gamma^2
  fadd(t1, P.y, P.z);
  fsqr(t2, t1);
  fsub(t2, t2, gamma);
  fsub(R.z, t2, delta);                   // Z3 = (Y + Z)^2 - gamma - delta
  return R;
}

// madd-2007-bl (second operand affine): 7M + 4S.  Writes H.
__device__ __forceinline__ Pt jac_madd(const Pt& P, const Fe& x2, const Fe& y2,
                                       Fe& H) {
  Fe z1z1, u2, s2, hh, i4, j, rr, v, t1, t2;
  Pt R;
  fsqr(z1z1, P.z);
  fmul(u2, x2, z1z1);
  fmul(t1, P.z, z1z1);
  fmul(s2, y2, t1);
  fsub(H, u2, P.x);
  fsqr(hh, H);
  fadd(i4, hh, hh);
  fadd(i4, i4, i4);
  fmul(j, H, i4);
  fsub(rr, s2, P.y);
  fadd(rr, rr, rr);
  fmul(v, P.x, i4);
  fsqr(t1, rr);
  fsub(t1, t1, j);
  fadd(t2, v, v);
  fsub(R.x, t1, t2);                      // X3 = rr^2 - J - 2V
  fmul(t1, P.y, j);
  fadd(t1, t1, t1);
  fsub(t2, v, R.x);
  fmul(t2, rr, t2);
  fsub(R.y, t2, t1);                      // Y3 = rr (V - X3) - 2 Y1 J
  fadd(t1, P.z, H);
  fsqr(t1, t1);
  fsub(t1, t1, z1z1);
  fsub(R.z, t1, hh);                      // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  return R;
}

// add-2007-bl (both Jacobian): 11M + 5S.  Writes H.
__device__ __forceinline__ Pt jac_add(const Pt& P, const Pt& Q, Fe& H) {
  Fe z1z1, z2z2, u1, u2, s1, s2, i, j, rr, v, t1, t2;
  Pt R;
  fsqr(z1z1, P.z);
  fsqr(z2z2, Q.z);
  fmul(u1, P.x, z2z2);
  fmul(u2, Q.x, z1z1);
  fmul(t1, Q.z, z2z2);
  fmul(s1, P.y, t1);
  fmul(t1, P.z, z1z1);
  fmul(s2, Q.y, t1);
  fsub(H, u2, u1);
  fadd(t1, H, H);
  fsqr(i, t1);
  fmul(j, H, i);
  fsub(rr, s2, s1);
  fadd(rr, rr, rr);
  fmul(v, u1, i);
  fsqr(t1, rr);
  fsub(t1, t1, j);
  fadd(t2, v, v);
  fsub(R.x, t1, t2);                      // X3 = rr^2 - J - 2V
  fmul(t1, s1, j);
  fadd(t1, t1, t1);
  fsub(t2, v, R.x);
  fmul(t2, rr, t2);
  fsub(R.y, t2, t1);                      // Y3 = rr (V - X3) - 2 S1 J
  fadd(t1, P.z, Q.z);
  fsqr(t1, t1);
  fsub(t1, t1, z1z1);
  fsub(t1, t1, z2z2);
  fmul(R.z, t1, H);                       // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H
  return R;
}

// The post-add selects of both add sites (the JAX package's
// _jac_apply_add): a zero digit keeps the accumulator, a not-yet-started
// accumulator takes the picked point, H == 0 with both operands real flags
// the lane, otherwise the formula result.
__device__ __forceinline__ void apply_add(Pt& acc, const Pt& res, const Fe& H,
                                          const Pt& pick, u32 digit,
                                          bool& started, bool& exc) {
  if (digit == 0) return;
  if (!started) {
    acc = pick;
  } else {
    exc = exc || fe_is_zero(H);
    acc = res;
  }
  started = true;
}

__global__ void __launch_bounds__(128)
p256_verify_kernel(const u32* __restrict__ packed, int32_t* __restrict__ out,
                   int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  Prep pr;
  scalar_prep(packed, n, lane, pr);
  const Fe &u1 = pr.u1, &u2 = pr.u2, &qx_m = pr.qx_m, &qy_m = pr.qy_m;
  const Fe &r_m = pr.r_m, &rn_m = pr.rn_m;
  const bool valid = pr.valid, rn_ok = pr.rn_ok;

  // ---- Q table: [1]Q, [2]Q = dbl, [k]Q = [k-1]Q + Q (madd chain) -------
  Fe one_m, H;
  fe_const(one_m, C_ONEP);
  Pt qtab[15];
  qtab[0].x = qx_m;
  qtab[0].y = qy_m;
  qtab[0].z = one_m;
  qtab[1] = jac_dbl(qtab[0]);
  for (int k = 2; k < 15; ++k) qtab[k] = jac_madd(qtab[k - 1], qx_m, qy_m, H);

  // ---- ladder: 64 rounds of 4 dbl + G madd + Q add ---------------------
  Pt acc;
  acc.x = one_m;
  acc.y = one_m;
  fe_zero(acc.z);
  bool started = false, exc = false;
  for (int k = 0; k < 64; ++k) {
#pragma unroll 1
    for (int q = 0; q < 4; ++q) acc = jac_dbl(acc);

    const u32 d1 = digit_of(u1, k);
    Pt pick;
    const int g = C_G + 16 * (d1 ? d1 - 1 : 0);
    fe_const(pick.x, g);
    fe_const(pick.y, g + NW);
    pick.z = one_m;
    Pt res = jac_madd(acc, pick.x, pick.y, H);
    apply_add(acc, res, H, pick, d1, started, exc);

    const u32 d2 = digit_of(u2, k);
    pick = qtab[d2 ? d2 - 1 : 0];
    res = jac_add(acc, pick, H);
    apply_add(acc, res, H, pick, d2, started, exc);
  }

  // ---- accept <=> X == r Z^2 or (rn_ok and X == (r+n) Z^2), R finite ---
  Fe z2, rz, rnz;
  fsqr(z2, acc.z);
  fmul(rz, r_m, z2);
  fmul(rnz, rn_m, z2);
  const bool at_inf = fe_is_zero(acc.z) || !started;
  const bool ok = fe_eq(acc.x, rz) || (rn_ok && fe_eq(acc.x, rnz));
  const bool verdict = ok && !at_inf && valid;
  out[lane] = (verdict ? 1 : 0) | (exc ? 2 : 0);
}

extern "C" int p256_verify_launch(const void* packed, void* out, int n,
                                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  p256_verify_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const u32*)packed, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
