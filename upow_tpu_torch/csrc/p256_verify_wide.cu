// Batched P-256 ECDSA verify at the wide windows, w = 6-13: scalar prep +
// Jacobian Strauss ladder in ONE launch, G groups of four threads to a
// signature (G = 1, 2, 4, 8, 16 or 32, chosen by the wrapper from N), the
// Q tables in device memory.
//
// Replaces upow_tpu/crypto/p256.py::_ladder_kernel_jac (the Pallas kernel,
// fused with _scalar_prep) at the windows the JAX package's
// DeviceConfig.apply_kernel_overrides admits above 5 (device.verify_window
// in [2, 13]; p256_verify.cu runs 2-5).  Input, output, formulas, digits
// and tests are p256_verify.cu's exactly (its header says what each is
// for); the group steps are p256_jac.cuh's.  The plain PyTorch version of
// the same function is crypto/p256.py::verify_plain.
//
// What is new at these windows, and what the design does about it:
// - The tables outgrow shared memory.  One signature's Q table is 2^w - 1
//   entries of 160 B (X, Y, Z, Z^2, Z^3): 10,080 B at w = 6, 40,800 B at
//   w = 8 and 1,310,560 B at w = 13, so 32 signatures a block no longer
//   fit from w = 6 and one signature does not fit from w = 11.  Here each
//   resident signature owns one table slot in a device-memory scratch
//   that the wrapper allocates (crypto/p256.py::_launch_wide), and the
//   signatures are walked grid-stride: the scratch is bounded by the grid
//   (at most the blocks resident at once, from the occupancy the
//   attributes function reports), not by N, so a verify stays one launch
//   at any N.  The table pointer is not read-only (no __ldg, no const
//   __restrict__): the kernel writes it.
// - The affine [k]G table (64 B an entry) outgrows the 64 KB __constant__
//   bank from w = 10 (65,472 B at w = 10, 524,224 B at w = 13), and
//   p256_common.cuh's c_k holds only the 31 entries of w = 5.  The window's
//   table is a device buffer built once a card and window by the wrapper
//   (crypto/p256.py::_g_table_device, [k]G by successive addition on the
//   host), read through the read-only path.
// - The Q table dominates a lane's chain: 341 + 4 (2^w - 2) + rounds (3 w
//   + 8) + 1 group steps built serially, 15 % of it at w = 6 and 96 % at
//   w = 13.  The accept launches 1,026 lanes and 1, which fill a tenth of
//   the card or less with one group a signature.  So a signature takes G
//   groups (a power of two up to 32 that crypto/p256.py::wide_plan picks
//   from N and w by a cost model of the chain): G = 1 at 8,192 lanes (one
//   group does everything, in the order of the one-group layout), 2-8 at
//   1,026 as w grows, 32 at 1 lane from w = 9.  At G > 1 group 0's
//   rank 0 first computes Q's Montgomery forms and the lane's flags and
//   publishes them (shared memory, and entry [1]Q of the table); after
//   one sync of the signature it goes on
//   with s^-1, u1 and u2 (341 serial mod-n products) while groups 1 ..
//   G - 1 build the table: each takes a contiguous segment of entries
//   2 .. 2^w - 1, computes the segment's first entry [b]Q from Q by
//   double-and-add (at most w - 1 doublings and popcount(b) - 1 madds)
//   and walks the rest by madd with the affine Q, storing X, Y, Z, Z^2
//   and Z^3 of each entry as the one-group build does.  A second sync of
//   the signature, and group 0 runs the ladder and the final test alone.
//   A lane's chain becomes about max(343, 5 w + 4 ceil((2^w - 2) / (G -
//   1))) + rounds (3 w + 8) + 1 steps.
// - Why the order of the build is free: an entry's coordinates depend on
//   the way it was summed only up to (X, Y, Z) -> (l^2 X, l^3 Y, l Z), and
//   the ladder's verdict and exception bits do not (dbl-2001-b,
//   madd-2007-bl and add-2007-bl commute with that rescaling, and H == 0,
//   Z == 0 and X == r Z^2 are invariant under it).  For an on-curve Q no
//   partial sum [k]Q, k < 2^13, is the identity or +-Q, so no formula of
//   a segmented build meets an exceptional case.  An off-curve Q runs the
//   group law of another curve, where a point of small order makes the
//   serial and a segmented build diverge (on a key of order 3 the
//   exception bit flips: tests/test_torch_p256_wide_coop.py); so a lane
//   whose flags say not valid (range or on-curve check failed, verdict
//   masked, the exception bit still compared) is built by group 1 alone
//   as one chain, the JAX package's order exactly.
// - Where a signature's groups lie: at G = 2 and 4 in G warps of the
//   block, one group a warp, so that each warp holds one role for eight
//   signatures (group 0's warp runs eight preps and then eight ladders in
//   one instruction stream, each table warp eight segments of the same
//   bounds); at G = 8, 16 and 32 in G consecutive groups.  A warp's chain
//   is bound by its scheduler's instruction rate (a step is about 1,390
//   instructions), so a warp
//   that carries one ladder where it could carry eight, or mixes roles,
//   costs a scheduler's time for little work.
// - Syncs: at G = 1 the group's own __syncwarp; at G >= 2 the block's
//   __syncthreads, with the block's trips through the grid-stride loop
//   made uniform (a slot past n idles through them), so every thread
//   meets every barrier.  It orders shared and device memory among the
//   block's threads, so the table groups' stores precede group 0's
//   ladder reads.  A slot reused by the next signature: group 0's ladder
//   reads end before the final test's step sync, which all four of its
//   ranks pass before its rank 0 writes [1]Q and the flags of the next
//   signature, and the table groups write only after the next trip's first
//   sync, which group 0 reaches after its ladder.
// - Each group's shared area (its two slot sets, and on the signature's
//   group 0 u1, u2, r R, (r + n) R, qx R, qy R and the flags: 464 B)
//   stays in shared memory, 14,848 B a block, so registers, not shared
//   memory, bound the blocks an SM holds.  W and G are runtime arguments,
//   so one instantiation serves every window and layout and the source
//   builds in about the time of one ladder (the device runtime's arm
//   builds every library under its deadline).
// - Bytes: each signature writes its whole table (10.7 GB for 8,192
//   signatures at w = 13) and reads one entry a round; what the layout
//   moves is crypto/p256.py::bytes_needed.  The segments' double-and-add
//   bases are extra products that the bound (mul_ops_needed) leaves out.

#include "p256_jac.cuh"

// A group's shared area, in 32-bit words (the signature's own fields on
// its group 0's area)
#define A_SLOT 0                     // two sets of GROUP product slots
#define A_U1 (2 * GROUP * NW)        // u1, plain (digits)
#define A_U2 (A_U1 + NW)             // u2, plain
#define A_RM (A_U2 + NW)             // r R mod p
#define A_RNM (A_RM + NW)            // (r + n) R mod p
#define A_QX (A_RNM + NW)            // qx R mod p, for the table groups
#define A_QY (A_QX + NW)             // qy R mod p
#define A_FLAGS (A_QY + NW)          // bit 0 valid, bit 1 r + n < p
#define A_WORDS (A_FLAGS + 4)        // padded to 16 bytes
#define AREA_BYTES (4 * SIGS * A_WORDS)
#define MAX_GROUPS SIGS              // groups a signature: the whole block
#define WARPS (THREADS / 32)         // warps a block
#define WARP_GROUPS (32 / GROUP)     // groups a warp

// The sync of a signature's threads: its one group's __syncwarp at G = 1,
// else the block's __syncthreads (the block's signatures share their
// trips).  Either orders shared and device memory among the threads it
// names.
__device__ __forceinline__ void sig_sync(const Group& g, int groups) {
  if (groups == 1)
    __syncwarp(g.mask);
  else
    __syncthreads();
}

// The k-th w-bit digit of the plain 256-bit value u (8 little-endian
// words) from the most significant end, of ``rounds`` digits: a digit
// spans at most two words, and the top digit of an uneven split reads
// zero bits past 256 (p256_verify.cu's window_digit with W at run time).
__device__ __forceinline__ u32 wide_digit(const u32* u, int w, int rounds,
                                          int k) {
  const int bit = w * (rounds - 1 - k);
  const int word = bit >> 5, off = bit & 31;
  u32 v = u[word] >> off;
  if (off + w > 32 && word + 1 < NW) v |= u[word + 1] << (32 - off);
  return v & ((1u << w) - 1);
}

// The first part of p256_common.cuh's scalar_prep (which the w = 2-5
// kernels compile, so it stays whole there): Q's Montgomery forms, and
// the flags (bit 0 range checks and on-curve, bit 1 r + n < p).
__device__ __forceinline__ u32 prep_q(const u32* __restrict__ packed, int n,
                                      int lane, Fe& qx_m, Fe& qy_m) {
  Fe qx, qy, r2p, y2, x3, t;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    qx.v[j] = packed[(24 + j) * (size_t)n + lane];
    qy.v[j] = packed[(32 + j) * (size_t)n + lane];
  }
  const bool range_ok = packed[40 * (size_t)n + lane] != 0;
  const bool rn_ok = packed[41 * (size_t)n + lane] != 0;
  fe_const(r2p, C_R2P);
  fmul(qx_m, qx, r2p);
  fmul(qy_m, qy, r2p);
  fsqr(y2, qy_m);
  fsqr(x3, qx_m);
  fmul(x3, x3, qx_m);
  fsub(x3, x3, qx_m);
  fsub(x3, x3, qx_m);
  fsub(x3, x3, qx_m);
  fe_const(t, C_BP);
  fadd(x3, x3, t);                        // x^3 - 3x + b
  return (range_ok && fe_eq(y2, x3) ? 1u : 0u) | (rn_ok ? 2u : 0u);
}

// The rest of scalar_prep, into the signature's area: s^-1 mod n by
// Fermat (a fixed 4-bit window over n - 2), u1 = z s^-1 and u2 = r s^-1
// (plain, for the digits), r R and (r + n) R mod p.
__device__ __forceinline__ void prep_scalars(const u32* __restrict__ packed,
                                             int n, int lane, u32* area) {
  Fe z, r, s;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    z.v[j] = packed[(0 + j) * (size_t)n + lane];
    r.v[j] = packed[(8 + j) * (size_t)n + lane];
    s.v[j] = packed[(16 + j) * (size_t)n + lane];
  }
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
  nmul(t, t, one_plain);                  // out of Montgomery form
  st(area + A_U1, t);
  nmul(t, r, r2n);
  nmul(t, t, w);
  nmul(t, t, one_plain);
  st(area + A_U2, t);

  Fe r_m, rn_m;
  fe_const(t, C_R2P);
  fmul(r_m, r, t);
  fe_const(t, C_NP);
  fadd(rn_m, r_m, t);                     // (r + n) R mod p
  st(area + A_RM, r_m);
  st(area + A_RNM, rn_m);
}

// Entries [lo]Q .. [hi]Q of the table on one group: [lo]Q from the affine
// Q by double-and-add, most significant bit first (k, the multiple
// reached, is always lo's top bits, and rem the bits still to take), then
// [k + 1]Q = [k]Q + Q by madd.  The ranks store X, Y, Z, Z^2 of each
// entry; its Z^3 is the next madd's Z1^3 (rank 0), and the last entry's
// one more step.  At lo = 2 this is the one-group chain: one doubling,
// then madds.
__device__ __forceinline__ void build_segment(u32* qtab, int lo, int hi,
                                              const Fe& qx, const Fe& qy,
                                              const Fe& one_m, Group& g) {
  Pt acc, res;
  Fe d = one_m, H, zc;                    // d = Z^2 of acc
  acc.x = qx;
  acc.y = qy;
  acc.z = one_m;
  int k = 1, rem = 0;
  while ((lo >> rem) > 1) ++rem;
#pragma unroll 1
  for (;;) {
    u32* e = qtab + (size_t)(k - 1) * Q_ENTRY;
    if (k >= lo) {
      Fe f;
      pick(f, g.rank, acc.x, acc.y, acc.z, d);
      st(e + g.rank * NW, f);
    }
    if (k == hi) break;
    if (k < lo && k == lo >> rem) {       // take lo's next bit
      --rem;
      dbl_group(acc, d, g);
      k *= 2;
    } else {                              // a set bit, or the walk
      madd_group(res, H, zc, acc, d, qx, qy, one_m, 2, g);
      if (k >= lo && g.rank == 0) st(e + 4 * NW, zc);  // Z^3 of [k]Q
      acc = res;
      ++k;
    }
  }
  const u32* s = step(g, acc.z, d);       // Z^3 of [hi]Q
  if (g.rank == 0) {
    Fe f;
    ld(f, s);
    st(qtab + (size_t)(hi - 1) * Q_ENTRY + 4 * NW, f);
  }
}

// The signatures slot, slot + gridDim.x * (SIGS / groups), ... on the
// ``groups`` groups of four of the block that own ``slot``, whose Q table
// is qscratch + slot * table entries; gtab holds the window's affine
// [k]G, k = 1 .. 2^w - 1.
__global__ void __launch_bounds__(THREADS)
p256_verify_wide_kernel(const u32* __restrict__ packed,
                        int32_t* __restrict__ out, int n, int w, int groups,
                        const u32* __restrict__ gtab, u32* qscratch) {
  extern __shared__ u32 smem[];
  const int rank = threadIdx.x & (GROUP - 1);
  const int local = threadIdx.x / GROUP;   // the group in the block
  const int warp = threadIdx.x / 32;
  // part: the group in its signature; lead: the signature's group 0
  int part, sig_local, lead;
  if (groups <= WARPS) {                   // one group a warp of G warps
    part = warp & (groups - 1);
    sig_local = (warp - part) / groups * WARP_GROUPS + local % WARP_GROUPS;
    lead = local - part * WARP_GROUPS;
  } else {                                 // G consecutive groups
    part = local & (groups - 1);
    sig_local = local / groups;
    lead = local - part;
  }
  const int per_block = SIGS / groups;     // signatures a block
  const int slot = blockIdx.x * per_block + sig_local;
  const int table = (1 << w) - 1;
  const int rounds = (256 + w - 1) / w;
  u32* area = smem + local * A_WORDS;
  u32* sarea = smem + lead * A_WORDS;      // the signature's fields
  u32* qtab = qscratch + (size_t)slot * table * Q_ENTRY;
  Group g;
  g.slots = area + A_SLOT;
  g.rank = rank;
  g.mask = 0xFu << (threadIdx.x & 31 & ~(GROUP - 1));
  g.set = 0;
  // the table's segments: one, on the one group, at G = 1, else one on
  // each of groups 1 .. G - 1
  const int segments = groups == 1 ? 1 : groups - 1;
  const int segment = groups == 1 ? 0 : part - 1;

  Fe one_m;
  fe_const(one_m, C_ONEP);

  // the block's trips are uniform (a slot past n idles through them), so
  // every thread meets every __syncthreads
#pragma unroll 1
  for (int base = blockIdx.x * per_block; base < n;
       base += gridDim.x * per_block) {
    const int sig = base + sig_local;
    const bool live = sig < n;
    // ---- Q and the flags on group 0's rank 0, to the whole signature --
    if (live && part == 0 && rank == 0) {
      Fe qx_m, qy_m;
      sarea[A_FLAGS] = prep_q(packed, n, sig, qx_m, qy_m);
      st(sarea + A_QX, qx_m);
      st(sarea + A_QY, qy_m);
      st(qtab, qx_m);                    // [1]Q = (qx, qy, 1), Z^2 = Z^3 = 1
      st(qtab + NW, qy_m);
      st(qtab + 2 * NW, one_m);
      st(qtab + 3 * NW, one_m);
      st(qtab + 4 * NW, one_m);
    }
    sig_sync(g, groups);

    // ---- the rest of the prep on group 0's rank 0; the Q table on the
    // table groups (at G = 1 the same group, after the prep) -----------
    if (live && part == 0 && rank == 0) prep_scalars(packed, n, sig, sarea);
    if (live && segment >= 0) {
      // a lane that is not valid: one chain, the first segment's
      const int split = (sarea[A_FLAGS] & 1u) ? segments : 1;
      const int len = (table - 2 + split) / split;  // of entries 2 .. table
      const int lo = 2 + segment * len;
      if (lo <= table) {
        const int hi = lo + len - 1 < table ? lo + len - 1 : table;
        Fe qx, qy;
        ld(qx, sarea + A_QX);
        ld(qy, sarea + A_QY);
        build_segment(qtab, lo, hi, qx, qy, one_m, g);
      }
    }
    sig_sync(g, groups);
    if (!live || part != 0) continue;

    // ---- ladder on group 0: rounds of w dbl + G madd + Q add ----------
    Pt acc, res;
    Fe d, H, zc;
    acc.x = one_m;
    acc.y = one_m;
    fe_zero(acc.z);
    fe_zero(d);                          // 0^2
    bool started = false, exc = false;
#pragma unroll 1
    for (int k = 0; k < rounds; ++k) {
      const u32 d1 = wide_digit(sarea + A_U1, w, rounds, k);
      const u32 d2 = wide_digit(sarea + A_U2, w, rounds, k);
#pragma unroll 1
      for (int q = 0; q < w; ++q) dbl_group(acc, d, g);

      Fe gx, gy;
      const u32* ge = gtab + (size_t)(d1 ? d1 - 1 : 0) * G_ENTRY;
      ld(gx, ge);
      ld(gy, ge + NW);
      int sel = d1 == 0 ? 0 : started ? 2 : 1;
      madd_group(res, H, zc, acc, d, gx, gy, one_m, sel, g);
      apply_add(acc, res, H, gx, gy, one_m, sel, exc);
      started = started || d1 != 0;

      const u32* qe = qtab + (size_t)(d2 ? d2 - 1 : 0) * Q_ENTRY;
      sel = d2 == 0 ? 0 : started ? 2 : 1;
      add_group(res, H, acc, d, qe, sel, g);
      Fe px, py, pz;
      ld(px, qe);
      ld(py, qe + NW);
      ld(pz, qe + 2 * NW);
      apply_add(acc, res, H, px, py, pz, sel, exc);
      started = started || d2 != 0;
    }

    // ---- accept <=> X == r Z^2 or (rn_ok and X == (r+n) Z^2), R finite -
    Fe r_m, rn_m, a;
    ld(r_m, sarea + A_RM);
    ld(rn_m, sarea + A_RNM);
    pick(a, rank, r_m, rn_m, rn_m, rn_m);
    const u32* s = step(g, a, d);        // d = Z^2
    if (rank == 0) {
      Fe rz, rnz;
      ld(rz, s);
      ld(rnz, s + NW);
      const u32 flags = sarea[A_FLAGS];
      const bool at_inf = fe_is_zero(acc.z) || !started;
      const bool ok = fe_eq(acc.x, rz) || ((flags & 2u) && fe_eq(acc.x, rnz));
      const bool verdict = ok && !at_inf && (flags & 1u);
      out[sig] = (verdict ? 1 : 0) | (exc ? 2 : 0);
    }
  }
}

// One launch of ``grid`` blocks of SIGS / groups signatures each (at most
// the resident blocks: the wrapper sizes the grid and the scratch, grid *
// SIGS / groups tables of 2^w - 1 entries).
extern "C" int p256_verify_wide_launch(const void* packed, void* out, int n,
                                       int w, int groups, const void* gtab,
                                       void* scratch, int grid,
                                       void* stream) {
  if (n <= 0) return 0;
  if (w < 2 || w > 13 || grid <= 0 || groups < 1 || groups > MAX_GROUPS
      || (groups & (groups - 1)))
    return (int)cudaErrorInvalidValue;
  p256_verify_wide_kernel<<<grid, THREADS, AREA_BYTES,
                            (cudaStream_t)stream>>>(
      (const u32*)packed, (int32_t*)out, n, w, groups, (const u32*)gtab,
      (u32*)scratch);
  return (int)cudaGetLastError();
}

// The launch's shape and the kernel's resources: threads a group, threads
// a block, shared bytes a block, registers a thread, local (stack) bytes
// a thread, and the blocks an SM holds at once.
extern "C" int p256_verify_wide_attributes(int* out6) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa,
                                          (const void*)p256_verify_wide_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, p256_verify_wide_kernel, THREADS, AREA_BYTES);
  if (err != cudaSuccess) return (int)err;
  out6[0] = GROUP;
  out6[1] = THREADS;
  out6[2] = AREA_BYTES;
  out6[3] = fa.numRegs;
  out6[4] = (int)fa.localSizeBytes;
  out6[5] = blocks;
  return 0;
}
