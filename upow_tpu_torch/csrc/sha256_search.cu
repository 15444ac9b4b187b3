// Proof-of-work nonce search: the part of one SHA-256 compression that
// reads the nonce, the uPow target test, and the least hit nonce.
//
// Replaces upow_tpu/crypto/sha256.py::_pallas_kernel (launched by
// _pow_search_pallas), with the dynamic target of _hit_nonce_dynamic.
// Output: the least nonce in [base, base + count) that meets the target,
// or 0xFFFFFFFF, min-reduced into *out, which the caller fills with
// 0xFFFFFFFF before every launch.  The plain PyTorch version of the same
// function is crypto/sha256.py::pow_search_plain.
//
// What bounds it: 32-bit integer operations.  With a v2 header a nonce
// needs about 1,110 instructions (crypto/sha256.py::ops_per_nonce counts
// only those that read the nonce, from the template's dataflow): about
// 820 SHF, LOP3 and PRMT, which only the ALU pipe runs, at 64 per SM per
// clock, and about 290 adds, which may also issue as IMAD on the FMA
// pipe.  The ALU pipe binds: 0.8255 ms for 2^24 nonces on an H100 at
// 1,980 MHz.  Bytes are nil: 680 bytes of arguments in, 4 out.
//
// What the design does about it: a nonce fills four consecutive tail
// bytes (v2 header: all of word 10; v1: from byte 2 of word 1 into word 2),
// so rounds before its first word and every message word it does not
// reach are the same for every nonce.  The host folds them once per
// template (crypto/sha256.py::fold_template): the state after those
// rounds, the first nonce round's a and e less the nonce word, each later
// round's constant addend (K, the constant part of its message word, and h
// and d while they are still constants) and each message word's constant
// part.  The kernel has two paths (kSearchPaths, the order of
// crypto/sha256.py::ALIGNED_PATH and GENERIC_PATH): where the nonce fills
// tail word 10 it places it with one PRMT, computes only the message words
// the nonce reaches and runs the rounds from word 10 on; at any other
// offset it starts at round 0 and places the byte-swapped nonce in each
// tail word with one 64-bit shift by a folded amount.  Both compute only
// the digest words the target test reads (words 0 and 1, word 2 where the
// nibble is there), word 0's test first.  Everything is unrolled into
// registers; round constants are constant-bank operands.
// Every sum is an IMAD (fma_add), so the ALU pipe runs only the SHF and
// LOP3 the count needs; what then limits the kernel is each round's chain
// of dependent instructions, so the sums that do not read this round's e
// and a (h + K + w, then d + that) are taken off the chain, and the
// kernel keeps 5 blocks an SM resident (48 registers, no spills; 6 blocks
// force 40 registers and spills, which cost more than the warps gain).
// Measured on an H100 (700 W): a v2 2^24 round with 10 queued takes
// 0.97 ms (share 0.85 of the bound), against the first version's 1.53 ms
// (share 0.54), which rebuilt the tail with 64 selects and ran every
// round and schedule word; about 1,470 SASS instructions a nonce, some
// 850 on the ALU pipe (535 SHF, 288 LOP3) and 550 IMAD on the FMA pipe.

// The reduction: blocks run in no order, so each thread walks a
// grid-stride loop (any count up to 2^32 - 1 on a grid sized to fill the
// card once), stops at its first hit (its nonces only grow), and the block
// reduces unsigned with __reduce_min_sync, then one atomicMin.  Lanes at or
// beyond count never run, so no count has to be a multiple of a tile.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "sha256_common.cuh"

typedef uint32_t u32;
typedef uint64_t u64;

#define SEARCH_THREADS 256
#define SEARCH_BLOCKS_PER_SM 5
#define SEARCH_SENTINEL 0xFFFFFFFFu

// Mirrors crypto/sha256.py::kernel_args (ARG_WORDS 32-bit words).  S is
// the path's first round: the aligned path's nonce word, 0 for the other.
struct SearchArgs {
  u32 state[8];        // a..h after rounds 0..S-1 (the midstate if S is 0)
  u32 mid[3];          // the midstate's words 0..2, for the digest words
  u32 one;             // 1: each sum is an IMAD by it (fma_add)
  u32 round_a;         // a after round S, less the nonce part of word S
  u32 round_e;         // e after round S, likewise
  u32 round_d[3];      // rounds S+1..S+3: round_k[i] + the constant d
  u32 round_k[64];     // round i > S: K[i] + word i's constant part
                       // (+ the constant h for i <= S+3)
  u32 word_c[64];      // message word j less its nonce part
  u32 nonce_shift[16]; // generic path: tail word k's nonce part is the low
                       // word of (byte-swapped nonce << 32) >> nonce_shift[k]
  u32 target[7];       // mask0, val0, mask1, val1, nibble word, shift, charset
  u32 base;
  u32 count;
};

// The message words a nonce placed in tail words `words` (a bit each)
// reaches: w[j] = w[j-16] + s0(w[j-15]) + w[j-7] + s1(w[j-2]).
__host__ __device__ constexpr u64 nonce_reach(u64 words) {
  for (int j = 16; j < 64; ++j)
    if (((words >> (j - 16)) | (words >> (j - 15)) | (words >> (j - 7))
         | (words >> (j - 2))) & 1u)
      words |= u64(1) << j;
  return words;
}

// x + y as an IMAD by `one`, which is 1 but comes from the arguments, so
// the compiler cannot turn it into an IADD3: the FMA pipe takes every sum,
// and the ALU pipe, which binds, only the shifts and the logic.
__device__ __forceinline__ u32 fma_add(u32 x, u32 y, u32 one) {
  return x * one + y;
}

__device__ __forceinline__ u32 sigma0(u32 x) {
  return sha256::rotr(x, 7) ^ sha256::rotr(x, 18) ^ (x >> 3);
}
__device__ __forceinline__ u32 sigma1(u32 x) {
  return sha256::rotr(x, 17) ^ sha256::rotr(x, 19) ^ (x >> 10);
}

// a after rounds 63, 62 and 61: digest words 0, 1 and 2 less the midstate's
struct Tail {
  u32 a0, a1, a2;
};

// The rounds of one nonce from the fold, for sha256_search_kernel<W>.
template <int W>
__device__ __forceinline__ Tail search_rounds(const SearchArgs& a, u32 nonce,
                                              u32 one) {
  // the first round, the tail words that may hold nonce bytes, and the
  // message words they reach
  constexpr int S = W < 0 ? 0 : W;
  constexpr u64 kNonce = W < 0 ? 0xFFFFu : u64(1) << W;
  constexpr u64 kReach = nonce_reach(kNonce);
  // v[j]: the nonce part of message word j, for the words kReach marks
  u32 v[64];
  // the nonce's bytes, least first, as a big-endian word: one PRMT
  const u32 swapped = __byte_perm(nonce, 0u, 0x0123u);
  if (W < 0) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      v[k] = (u32)(((u64)swapped << 32) >> a.nonce_shift[k]);
  } else {
    v[S] = swapped;
  }
  u32 A = fma_add(v[S], a.round_a, one), B = a.state[0], C = a.state[1];
  u32 E = fma_add(v[S], a.round_e, one), F = a.state[4], G = a.state[5];
  u32 D = a.state[2], H = a.state[6];
#pragma unroll
  for (int r = S + 1; r < 64; ++r) {
    const bool var = (kReach >> r) & 1u;
    if (r >= 16 && var) {
      // word j in full is its nonce part plus its constant part; the
      // linear terms' constant parts are folded into word_c[r]
      const int a16 = (r - 16) & 63, a15 = (r - 15) & 63, a7 = (r - 7) & 63,
                a2 = (r - 2) & 63;
      const u32 w15 =
          W >= 0 && a15 == S ? v[a15] : fma_add(v[a15], a.word_c[a15], one);
      const u32 w2 =
          W >= 0 && a2 == S ? v[a2] : fma_add(v[a2], a.word_c[a2], one);
      u32 x = 0u;
      if ((kReach >> a16) & 1u) x = v[a16];
      if ((kReach >> a15) & 1u) x = fma_add(sigma0(w15), x, one);
      if ((kReach >> a7) & 1u) x = fma_add(v[a7], x, one);
      if ((kReach >> a2) & 1u) x = fma_add(sigma1(w2), x, one);
      v[r] = x;
    }
    // t1 = h + S1 + ch + K[r] + w[r] and e = d + t1, with everything but
    // S1 + ch summed off the critical path: hk = h + K[r] + w[r], dhk = d + hk
    u32 hk, dhk;
    if (r <= S + 3) {
      // h and d are still the folded state's: both in the constants
      hk = var ? fma_add(v[r & 63], a.round_k[r], one) : a.round_k[r];
      dhk = var ? fma_add(v[r & 63], a.round_d[(r - S - 1) & 3], one)
                : a.round_d[(r - S - 1) & 3];
    } else {
      hk = fma_add(H, a.round_k[r], one);
      if (var) hk = fma_add(v[r & 63], hk, one);
      dhk = fma_add(D, hk, one);
    }
    const u32 S1 =
        sha256::rotr(E, 6) ^ sha256::rotr(E, 11) ^ sha256::rotr(E, 25);
    const u32 ch = (E & F) ^ (~E & G);
    const u32 s1ch = fma_add(S1, ch, one);
    const u32 t1 = fma_add(s1ch, hk, one);
    const u32 S0 =
        sha256::rotr(A, 2) ^ sha256::rotr(A, 13) ^ sha256::rotr(A, 22);
    const u32 maj = (A & B) ^ (A & C) ^ (B & C);
    H = G;
    G = F;
    F = E;
    E = fma_add(s1ch, dhk, one);
    D = C;
    C = B;
    B = A;
    A = fma_add(t1, fma_add(S0, maj, one), one);
  }
  return Tail{A, B, C};
}

// The PoW rule of _hit_nonce_dynamic on the digest words: prefix match on
// words 0 and 1; the fractional nibble (in word 0, 1 or 2) below the
// charset size, unless the charset is 16 or more.  Word 0 first: nearly
// every nonce stops there.
__device__ __forceinline__ bool meets(const SearchArgs& a, const Tail& t) {
  const u32 d0 = a.mid[0] + t.a0;
  if ((d0 & a.target[0]) != a.target[1]) return false;
  const u32 d1 = a.mid[1] + t.a1;
  const u32 word =
      a.target[4] == 0 ? d0 : (a.target[4] == 1 ? d1 : a.mid[2] + t.a2);
  return (d1 & a.target[2]) == a.target[3]
         && (a.target[6] >= 16u || ((word >> a.target[5]) & 0xFu) < a.target[6]);
}

// The nonce fills tail word W, or, with W = -1, starts anywhere in the
// tail (nonce_shift).
template <int W>
__global__ void __launch_bounds__(SEARCH_THREADS, SEARCH_BLOCKS_PER_SM)
    sha256_search_kernel(const SearchArgs a, u32* out) {
  __shared__ u32 warp_best[SEARCH_THREADS / 32];
  const u32 one = a.one;
  u32 best = SEARCH_SENTINEL;
  const u64 stride = (u64)gridDim.x * blockDim.x;
  for (u64 i = (u64)blockIdx.x * blockDim.x + threadIdx.x; i < a.count;
       i += stride) {
    // base + count <= 2^32 (the wrapper checks), so this never wraps
    const u32 nonce = a.base + (u32)i;
    if (meets(a, search_rounds<W>(a, nonce, one))) {
      best = nonce;  // this thread's later nonces are all larger
      break;
    }
  }
  // every thread reaches here: unsigned min over the warp, then the block
  best = __reduce_min_sync(0xFFFFFFFFu, best);
  const u32 lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    const u32 warps = (blockDim.x + 31u) >> 5;
    u32 v = lane < warps ? warp_best[lane] : SEARCH_SENTINEL;
    v = __reduce_min_sync(0xFFFFFFFFu, v);
    if (lane == 0 && v != SEARCH_SENTINEL) atomicMin(out, v);
  }
}

// The paths, by crypto/sha256.py's ALIGNED_PATH and GENERIC_PATH: the
// nonce fills tail word 10 (ALIGNED_WORD, the v2 header's); any other
// offset.
typedef void (*SearchKernel)(const SearchArgs, u32*);
static const SearchKernel kSearchPaths[] = {
    sha256_search_kernel<10>,
    sha256_search_kernel<-1>,
};
#define SEARCH_PATHS (int)(sizeof(kSearchPaths) / sizeof(kSearchPaths[0]))

// args: ARG_WORDS host words (crypto/sha256.py::kernel_args); path: the
// index of the template's path in kSearchPaths; out: a device word
// holding 0xFFFFFFFF; the current device must be `device`.  Launches on
// `stream` and returns the CUDA error of the launch (0 on success); it
// does not synchronise.  The grid's wave (SMs times resident blocks an SM)
// is asked of the runtime at a path's first launch on a device and kept,
// as the txid and probe kernels do: a miner's round makes no runtime query.
#define SEARCH_MAX_DEVICES 64
extern "C" int sha256_search_launch(const u32* args, int words, int path,
                                    void* out, int device, void* stream) {
  static std::atomic<int> wave_cache[SEARCH_MAX_DEVICES][SEARCH_PATHS];
  if (words != (int)(sizeof(SearchArgs) / sizeof(u32)) || device < 0
      || device >= SEARCH_MAX_DEVICES || path < 0 || path >= SEARCH_PATHS)
    return (int)cudaErrorInvalidValue;
  SearchArgs a;
  std::memcpy(&a, args, sizeof a);
  if (a.count == 0) return 0;
  const SearchKernel kernel = kSearchPaths[path];
  int wave = wave_cache[device][path].load(std::memory_order_relaxed);
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, SEARCH_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    wave = sms * (per_sm > 0 ? per_sm : 1);
    wave_cache[device][path].store(wave, std::memory_order_relaxed);
  }
  // one resident wave of blocks; the grid-stride loop covers the rest
  const u64 need = ((u64)a.count + SEARCH_THREADS - 1) / SEARCH_THREADS;
  const int blocks = (int)(need < (u64)wave ? need : (u64)wave);
  kernel<<<blocks, SEARCH_THREADS, 0, (cudaStream_t)stream>>>(a, (u32*)out);
  return (int)cudaGetLastError();
}
