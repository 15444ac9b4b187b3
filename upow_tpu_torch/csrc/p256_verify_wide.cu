// Batched P-256 ECDSA verify at the wide windows, w = 6-13: scalar prep +
// Jacobian Strauss ladder in ONE launch, four threads to a signature, the
// Q tables in device memory.
//
// Replaces upow_tpu/crypto/p256.py::_ladder_kernel_jac (the Pallas kernel,
// fused with _scalar_prep) at the windows the JAX package's
// DeviceConfig.apply_kernel_overrides admits above 5 (device.verify_window
// in [2, 13]; p256_verify.cu runs 2-5).  Input, output, formulas, table
// order, digits and tests are p256_verify.cu's exactly (its header says
// what each is for); the group steps are p256_jac.cuh's.  The plain
// PyTorch version of the same function is crypto/p256.py::verify_plain.
//
// What is new at these windows, and what the design does about it:
// - The tables outgrow shared memory.  One signature's Q table is 2^w - 1
//   entries of 160 B (X, Y, Z, Z^2, Z^3): 10,080 B at w = 6, 40,800 B at
//   w = 8 and 1,310,560 B at w = 13, so 32 signatures a block no longer
//   fit from w = 6 and one signature does not fit from w = 11.  Here each
//   resident group owns one table slot in a device-memory scratch that the
//   wrapper allocates (crypto/p256.py::_run_wide), and the groups walk the
//   signatures grid-stride: the scratch is bounded by the grid (at most
//   the blocks resident at once, from the occupancy the attributes
//   function reports), not by N, so a verify stays one launch at any N.
//   A rank writes its coordinate of each entry; the group's __syncwarp
//   orders device memory among its four lanes as it orders shared memory,
//   so the ladder's reads of an entry follow the syncs after its stores
//   exactly as in p256_verify.cu.  The table pointer is not read-only
//   (no __ldg, no const __restrict__): the kernel writes it.
// - The affine [k]G table (64 B an entry) outgrows the 64 KB __constant__
//   bank from w = 10 (65,472 B at w = 10, 524,224 B at w = 13), and
//   p256_common.cuh's c_k holds only the 31 entries of w = 5.  The window's
//   table is a device buffer built once a card and window by the wrapper
//   (crypto/p256.py::_g_table_device, [k]G by successive addition on the
//   host), read through the read-only path.
// - W is a runtime argument, so one instantiation serves 6-13 and this
//   source builds in about the time of one ladder (the device runtime's
//   arm builds every library under its deadline).
// - Per signature the chain is about 341 + 4 (2^w - 2) + rounds (3 w + 8)
//   + 1 group steps: 1,708 at w = 6, 2,382 at w = 8, 5,418 at w = 10 and
//   34,042 at w = 13, where the Q table's madd chain dominates.  Nothing
//   here shortens it: this is the simple layout that is right.  Each
//   group's shared area (its two slot sets, u1, u2, r R, (r + n) R and the
//   flags: 400 B) stays in shared memory, 12,800 B a block, so registers,
//   not shared memory, bound the blocks an SM holds.
// - Bytes: each signature writes its whole table (10.7 GB for 8,192
//   signatures at w = 13) and reads one entry a round; what the layout
//   moves is crypto/p256.py::bytes_needed.

#include "p256_jac.cuh"

// A group's shared area, in 32-bit words
#define A_SLOT 0                     // two sets of GROUP product slots
#define A_U1 (2 * GROUP * NW)        // u1, plain (digits)
#define A_U2 (A_U1 + NW)             // u2, plain
#define A_RM (A_U2 + NW)             // r R mod p
#define A_RNM (A_RM + NW)            // (r + n) R mod p
#define A_FLAGS (A_RNM + NW)         // bit 0 valid, bit 1 r + n < p
#define A_WORDS (A_FLAGS + 4)        // padded to 16 bytes
#define AREA_BYTES (4 * SIGS * A_WORDS)

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

// Every signature sig = slot, slot + gridDim.x * SIGS, ... on the group
// of four that owns ``slot``, whose Q table is qscratch + slot * table
// entries; gtab holds the window's affine [k]G, k = 1 .. 2^w - 1.
__global__ void __launch_bounds__(THREADS)
p256_verify_wide_kernel(const u32* __restrict__ packed,
                        int32_t* __restrict__ out, int n, int w,
                        const u32* __restrict__ gtab, u32* qscratch) {
  extern __shared__ u32 smem[];
  const int rank = threadIdx.x & (GROUP - 1);
  const int local = threadIdx.x / GROUP;
  const int slot = blockIdx.x * SIGS + local;
  const int table = (1 << w) - 1;
  const int rounds = (256 + w - 1) / w;
  u32* area = smem + local * A_WORDS;
  u32* qtab = qscratch + (size_t)slot * table * Q_ENTRY;
  Group g;
  g.slots = area + A_SLOT;
  g.rank = rank;
  g.mask = 0xFu << (threadIdx.x & 31 & ~(GROUP - 1));
  g.set = 0;

  Fe one_m;
  fe_const(one_m, C_ONEP);

  // all four ranks of a group share sig, so the whole group leaves
  // together; nothing below syncs more than the group
#pragma unroll 1
  for (int sig = slot; sig < n; sig += gridDim.x * SIGS) {
    // ---- scalar prep on rank 0, handed to the group -------------------
    // (the previous signature's last reads of the area and the table came
    // before its final step's sync, which every rank has passed)
    if (rank == 0) {
      Prep pr;
      scalar_prep(packed, n, sig, pr);
      st(area + A_U1, pr.u1);
      st(area + A_U2, pr.u2);
      st(area + A_RM, pr.r_m);
      st(area + A_RNM, pr.rn_m);
      area[A_FLAGS] = (pr.valid ? 1u : 0u) | (pr.rn_ok ? 2u : 0u);
      st(qtab, pr.qx_m);                 // [1]Q = (qx, qy, 1), Z^2 = Z^3 = 1
      st(qtab + NW, pr.qy_m);
      st(qtab + 2 * NW, one_m);
      st(qtab + 3 * NW, one_m);
      st(qtab + 4 * NW, one_m);
    }
    __syncwarp(g.mask);

    // ---- Q table: [2]Q = dbl, [k]Q = [k-1]Q + Q (madd chain) ----------
    Fe qx, qy, H, zc;
    ld(qx, qtab);
    ld(qy, qtab + NW);
    Pt acc, res;
    acc.x = qx;
    acc.y = qy;
    acc.z = one_m;
    Fe d = one_m;                        // 1^2
    dbl_group(acc, d, g);
#pragma unroll 1
    for (int k = 2; k <= table; ++k) {
      u32* e = qtab + (size_t)(k - 1) * Q_ENTRY;  // [k]Q: ranks store X, Y,
      Fe f;                                        // Z, Z^2
      pick(f, rank, acc.x, acc.y, acc.z, d);
      st(e + rank * NW, f);
      if (k == table) break;
      madd_group(res, H, zc, acc, d, qx, qy, one_m, 2, g);
      if (rank == 0) st(e + 4 * NW, zc);  // Z^3 of [k]Q
      acc = res;
    }
    {
      const u32* s = step(g, acc.z, d);  // Z^3 of [table]Q
      if (rank == 0) {
        Fe f;
        ld(f, s);
        st(qtab + (size_t)(table - 1) * Q_ENTRY + 4 * NW, f);
      }
    }                                    // the ladder's first sync orders
                                         // these stores before any read

    // ---- ladder: rounds of w dbl + G madd + Q add ---------------------
    acc.x = one_m;
    acc.y = one_m;
    fe_zero(acc.z);
    fe_zero(d);                          // 0^2
    bool started = false, exc = false;
#pragma unroll 1
    for (int k = 0; k < rounds; ++k) {
      const u32 d1 = wide_digit(area + A_U1, w, rounds, k);
      const u32 d2 = wide_digit(area + A_U2, w, rounds, k);
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
    ld(r_m, area + A_RM);
    ld(rn_m, area + A_RNM);
    pick(a, rank, r_m, rn_m, rn_m, rn_m);
    const u32* s = step(g, a, d);        // d = Z^2
    if (rank == 0) {
      Fe rz, rnz;
      ld(rz, s);
      ld(rnz, s + NW);
      const u32 flags = area[A_FLAGS];
      const bool at_inf = fe_is_zero(acc.z) || !started;
      const bool ok = fe_eq(acc.x, rz) || ((flags & 2u) && fe_eq(acc.x, rnz));
      const bool verdict = ok && !at_inf && (flags & 1u);
      out[sig] = (verdict ? 1 : 0) | (exc ? 2 : 0);
    }
  }
}

// One launch of ``grid`` blocks (at most the resident blocks: the wrapper
// sizes the grid and the scratch, grid * SIGS tables of 2^w - 1 entries).
extern "C" int p256_verify_wide_launch(const void* packed, void* out, int n,
                                       int w, const void* gtab,
                                       void* scratch, int grid,
                                       void* stream) {
  if (n <= 0) return 0;
  if (w < 2 || w > 13 || grid <= 0) return (int)cudaErrorInvalidValue;
  p256_verify_wide_kernel<<<grid, THREADS, AREA_BYTES,
                            (cudaStream_t)stream>>>(
      (const u32*)packed, (int32_t*)out, n, w, (const u32*)gtab,
      (u32*)scratch);
  return (int)cudaGetLastError();
}

// The launch's shape and the kernel's resources: threads a signature,
// threads a block, shared bytes a block, registers a thread, local
// (stack) bytes a thread, and the blocks an SM holds at once.
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
