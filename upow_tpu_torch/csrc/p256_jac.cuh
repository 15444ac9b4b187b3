// The Jacobian ladder's group steps, shared by the two kernels that port
// upow_tpu/crypto/p256.py::_ladder_kernel_jac: p256_verify.cu (the tables
// in shared memory, w = 2-5) and p256_verify_wide.cu (the Q tables in
// device memory, w = 6-13).  Four consecutive threads of a warp work on
// one signature; each formula is grouped into steps of up to four field
// products, one a rank, that meet in the signature's two alternating
// slot sets (p256_verify.cu's header says why and how).  The formulas
// are the JAX package's: dbl-2001-b, madd-2007-bl and add-2007-bl.
#pragma once

#include "p256_common.cuh"

#define GROUP 4                     // threads a signature
#define THREADS 128                 // threads a block
#define SIGS (THREADS / GROUP)      // signatures a block
#define G_ENTRY (2 * NW)            // affine x, y
#define Q_ENTRY (5 * NW)            // X, Y, Z, Z^2, Z^3

__device__ __forceinline__ void ld(Fe& r, const u32* s) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = s[j];
}

__device__ __forceinline__ void st(u32* s, const Fe& a) {
#pragma unroll
  for (int j = 0; j < NW; ++j) s[j] = a.v[j];
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

// r = (a, b, c)[sel] by selects: the accumulator (0), the pick (1) or
// the formula's result (2)
__device__ __forceinline__ void sel3(Fe& r, int sel, const Fe& a,
                                     const Fe& b, const Fe& c) {
#pragma unroll
  for (int j = 0; j < NW; ++j)
    r.v[j] = sel == 0 ? a.v[j] : sel == 1 ? b.v[j] : c.v[j];
}

// The group of a signature: its two slot sets, the thread's rank, the
// group's lane mask, and the set the next step writes.
struct Group {
  u32* slots;
  int rank;
  unsigned mask;
  int set;
};

// One group step: the rank's product a * c into its slot of the current
// set, then the group's sync.  Returns the set; its GROUP products must be
// read before the caller's next step.
__device__ __forceinline__ const u32* step(Group& g, const Fe& a,
                                           const Fe& c) {
  Fe p;
  fmul(p, a, c);
  u32* s = g.slots + g.set * (GROUP * NW);
  st(s + g.rank * NW, p);
  __syncwarp(g.mask);
  g.set ^= 1;
  return s;
}

// dbl-2001-b (a = -3) in three steps.  On entry d = delta = Z^2; on
// return P is the double and d its Z^2 (the next operation's delta).
__device__ __forceinline__ void dbl_group(Pt& P, Fe& d, Group& g) {
  Fe a, c, t, gamma, alpha, beta4, g8, x3, z3;
  const u32* s;

  // step 1: gamma = Y^2, (Y + Z)^2, (X - delta)(X + delta)
  Fe yz, xm, xp;
  fadd(yz, P.y, P.z);
  fsub(xm, P.x, d);
  fadd(xp, P.x, d);
  pick(a, g.rank, P.y, yz, xm, xm);
  pick(c, g.rank, P.y, yz, xp, xp);
  s = step(g, a, c);
  ld(gamma, s);
  ld(t, s + NW);
  fsub(t, t, gamma);
  fsub(z3, t, d);                         // Z3 = (Y + Z)^2 - gamma - delta
  ld(t, s + 2 * NW);
  fadd(alpha, t, t);
  fadd(alpha, alpha, t);                  // 3 (X - delta)(X + delta)

  // step 2: beta = X gamma, gamma^2, alpha^2
  pick(a, g.rank, P.x, gamma, alpha, alpha);
  pick(c, g.rank, gamma, gamma, alpha, alpha);
  s = step(g, a, c);
  ld(t, s);
  fadd(beta4, t, t);
  fadd(beta4, beta4, beta4);              // 4 beta
  ld(g8, s + NW);
  fadd(g8, g8, g8);
  fadd(g8, g8, g8);
  fadd(g8, g8, g8);                       // 8 gamma^2
  ld(t, s + 2 * NW);
  fadd(c, beta4, beta4);
  fsub(x3, t, c);                         // X3 = alpha^2 - 8 beta

  // step 3: alpha (4 beta - X3), Z3^2
  fsub(t, beta4, x3);
  pick(a, g.rank, alpha, z3, z3, z3);
  pick(c, g.rank, t, z3, z3, z3);
  s = step(g, a, c);
  ld(t, s);
  fsub(P.y, t, g8);                       // Y3 = alpha (4 beta - X3) - 8 gamma^2
  P.x = x3;
  P.z = z3;
  ld(d, s + NW);
}

// madd-2007-bl (second operand affine (x2, y2)) in four steps: R = P +
// (x2, y2), and H.  d = Z1Z1 on entry; on return d is the square of the Z
// that the caller's select keeps: P's (sel 0), pz's (sel 1) or R's (sel
// 2).  z1c returns Z1^3.
__device__ __forceinline__ void madd_group(Pt& R, Fe& H, Fe& z1c,
                                           const Pt& P, Fe& d, const Fe& x2,
                                           const Fe& y2, const Fe& pz,
                                           int sel, Group& g) {
  Fe a, c, t, t2, hh, i4, j, rr, v, zs;
  const u32* s;

  // step 1: U2 = x2 Z1Z1, Z1 Z1Z1
  pick(a, g.rank, x2, P.z, P.z, P.z);
  s = step(g, a, d);
  ld(t, s);
  fsub(H, t, P.x);                        // H = U2 - X1
  ld(z1c, s + NW);

  // step 2: S2 = y2 Z1^3, HH = H^2, (Z1 + H)^2
  fadd(t, P.z, H);
  pick(a, g.rank, y2, H, t, t);
  pick(c, g.rank, z1c, H, t, t);
  s = step(g, a, c);
  ld(hh, s + NW);
  ld(t, s + 2 * NW);
  fsub(t, t, d);
  fsub(R.z, t, hh);                       // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  fadd(i4, hh, hh);
  fadd(i4, i4, i4);                       // I = 4 HH
  ld(t, s);
  fsub(rr, t, P.y);
  fadd(rr, rr, rr);                       // rr = 2 (S2 - Y1)

  // step 3: J = H I, V = X1 I, rr^2, Zsel^2
  sel3(zs, sel, P.z, pz, R.z);
  pick(a, g.rank, H, P.x, rr, zs);
  pick(c, g.rank, i4, i4, rr, zs);
  s = step(g, a, c);
  ld(j, s);
  ld(v, s + NW);
  ld(t, s + 2 * NW);
  ld(d, s + 3 * NW);
  fsub(t, t, j);
  fadd(t2, v, v);
  fsub(R.x, t, t2);                       // X3 = rr^2 - J - 2V

  // step 4: Y1 J, rr (V - X3)
  fsub(t2, v, R.x);
  pick(a, g.rank, P.y, rr, rr, rr);
  pick(c, g.rank, j, t2, t2, t2);
  s = step(g, a, c);
  ld(t, s);
  fadd(t, t, t);
  ld(t2, s + NW);
  fsub(R.y, t2, t);                       // Y3 = rr (V - X3) - 2 Y1 J
}

// add-2007-bl (both Jacobian; q a Q-table entry: X, Y, Z, Z^2, Z^3) in
// four steps: R = P + Q, and H.  d as in madd_group, the pick's Z being
// the entry's.
__device__ __forceinline__ void add_group(Pt& R, Fe& H, const Pt& P, Fe& d,
                                          const u32* q, int sel, Group& g) {
  Fe a, c, t, t2, u1, s1, z1c, i, j, rr, v, qz, zs;
  const u32* s;

  // step 1: U1 = X1 Z2Z2, U2 = X2 Z1Z1, Z1 Z1Z1, S1 = Y1 Z2^3
  ld(v, q);                               // X2
  ld(t, q + 3 * NW);                      // Z2Z2
  ld(t2, q + 4 * NW);                     // Z2^3
  pick(a, g.rank, P.x, v, P.z, P.y);
  pick(c, g.rank, t, d, d, t2);
  s = step(g, a, c);
  ld(u1, s);
  ld(t, s + NW);
  fsub(H, t, u1);                         // H = U2 - U1
  ld(z1c, s + 2 * NW);
  ld(s1, s + 3 * NW);

  // step 2: S2 = Y2 Z1^3, I = (2H)^2, (Z1 + Z2)^2
  ld(qz, q + 2 * NW);
  ld(t, q + NW);                          // Y2
  fadd(t2, H, H);
  fadd(v, P.z, qz);
  pick(a, g.rank, t, t2, v, v);
  pick(c, g.rank, z1c, t2, v, v);
  s = step(g, a, c);
  ld(i, s + NW);
  ld(t, s + 2 * NW);
  fsub(t, t, d);
  ld(t2, q + 3 * NW);
  fsub(t2, t, t2);                        // (Z1 + Z2)^2 - Z1Z1 - Z2Z2
  ld(t, s);
  fsub(rr, t, s1);
  fadd(rr, rr, rr);                       // rr = 2 (S2 - S1)

  // step 3: J = H I, V = U1 I, rr^2, Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  pick(a, g.rank, H, u1, rr, t2);
  pick(c, g.rank, i, i, rr, H);
  s = step(g, a, c);
  ld(j, s);
  ld(v, s + NW);
  ld(t, s + 2 * NW);
  ld(R.z, s + 3 * NW);
  fsub(t, t, j);
  fadd(t2, v, v);
  fsub(R.x, t, t2);                       // X3 = rr^2 - J - 2V

  // step 4: S1 J, rr (V - X3), Zsel^2
  sel3(zs, sel, P.z, qz, R.z);
  fsub(t2, v, R.x);
  pick(a, g.rank, s1, rr, zs, zs);
  pick(c, g.rank, j, t2, zs, zs);
  s = step(g, a, c);
  ld(t, s);
  fadd(t, t, t);
  ld(t2, s + NW);
  fsub(R.y, t2, t);                       // Y3 = rr (V - X3) - 2 S1 J
  ld(d, s + 2 * NW);
}

// The post-add selects of both add sites (the JAX package's
// _jac_apply_add): a zero digit keeps the accumulator (sel 0), a
// not-yet-started accumulator takes the pick (sel 1), otherwise the
// formula's result (sel 2), where H == 0 flags the lane.
__device__ __forceinline__ void apply_add(Pt& acc, const Pt& res,
                                          const Fe& H, const Fe& px,
                                          const Fe& py, const Fe& pz,
                                          int sel, bool& exc) {
  exc = exc || (sel == 2 && fe_is_zero(H));
  sel3(acc.x, sel, acc.x, px, res.x);
  sel3(acc.y, sel, acc.y, py, res.y);
  sel3(acc.z, sel, acc.z, pz, res.z);
}
