// Proof-of-work nonce search: one SHA-256 compression per nonce from the
// template's midstate, the uPow target test, and the least hit nonce.
//
// Replaces upow_tpu/crypto/sha256.py::_pallas_kernel (launched by
// _pow_search_pallas), with the dynamic target of _hit_nonce_dynamic: the
// template (midstate, tail words, the (word, shift) of each nonce byte) and
// the 7-word pack_target vector arrive as one by-value argument block, so
// one build serves every template, header version and difficulty.  Output:
// the least nonce in [base, base + count) that meets the target, or
// 0xFFFFFFFF, min-reduced into *out, which the caller fills with
// 0xFFFFFFFF before every launch.  The plain PyTorch version of the same
// function is crypto/sha256.py::pow_search_plain.
//
// What bounds it: 32-bit integer operations.  With a v2 header a nonce
// needs about 1,110 instructions (crypto/sha256.py::ops_per_nonce counts
// only those that read the nonce, from the template's dataflow): about
// 820 SHF, LOP3 and PRMT, which only the ALU pipe runs, at 64 per SM per
// clock, and about 290 adds, which may also issue as IMAD on the FMA
// pipe.  The ALU pipe binds.  Bytes are nil: 164 bytes of arguments in,
// 4 out.
//
// What the design does about it: the compression (sha256_common.cuh) is
// fully unrolled into registers with one funnel shift per rotate, and
// nothing touches memory inside the loop.  The TPU kernel's sequential
// grid carried one SMEM minimum from step to step, with a sign flip since
// Mosaic has no unsigned reduction; here blocks run in no order, so each
// thread walks a grid-stride loop (any count up to 2^32 - 1 on a grid sized
// to fill the card once), stops at its first hit (its nonces only grow),
// and the block reduces unsigned with __reduce_min_sync, then one
// atomicMin.  Lanes at or beyond count never run (the valid mask of
// _hit_nonce_dynamic), so no count has to be a multiple of a tile.  This
// first version keeps the generic byte scatter of _build_w, one select per
// nonce byte and tail word, and runs every round and schedule word for
// every nonce, those that do not depend on it too: about 1,580 SASS
// instructions a nonce for sm_90a, where the bound counts about 1,110.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "sha256_common.cuh"

typedef uint32_t u32;
typedef uint64_t u64;

#define SEARCH_THREADS 256
#define SEARCH_SENTINEL 0xFFFFFFFFu

// Mirrors crypto/sha256.py::kernel_args (ARG_WORDS 32-bit words).
struct SearchArgs {
  u32 mid[8];          // state after the prefix's full blocks
  u32 tail[16];        // last block, nonce bytes zero, padding applied
  u32 nonce_word[4];   // tail word of little-endian nonce byte j
  u32 nonce_shift[4];  // its left shift in that word
  u32 target[7];       // mask0, val0, mask1, val1, nibble word, shift, charset
  u32 base;
  u32 count;
};

// The PoW rule of _hit_nonce_dynamic: prefix match on digest words 0 and
// 1; the fractional nibble (in word 0, 1 or 2) below the charset size,
// unless the charset is 16 or more.
__device__ __forceinline__ bool meets(const u32 st[8], const u32 t[7]) {
  const u32 word = t[4] == 0 ? st[0] : (t[4] == 1 ? st[1] : st[2]);
  const u32 nib = (word >> t[5]) & 0xFu;
  return ((st[0] & t[0]) == t[1]) && ((st[1] & t[2]) == t[3]) &&
         (t[6] >= 16u || nib < t[6]);
}

__global__ void __launch_bounds__(SEARCH_THREADS)
    sha256_search_kernel(const SearchArgs a, u32* out) {
  __shared__ u32 warp_best[SEARCH_THREADS / 32];
  u32 best = SEARCH_SENTINEL;
  const u64 stride = (u64)gridDim.x * blockDim.x;
  for (u64 i = (u64)blockIdx.x * blockDim.x + threadIdx.x; i < a.count;
       i += stride) {
    // base + count <= 2^32 (the wrapper checks), so this never wraps
    const u32 nonce = a.base + (u32)i;
    u32 w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = a.tail[k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const u32 v = ((nonce >> (8 * j)) & 0xFFu) << a.nonce_shift[j];
#pragma unroll
      for (int k = 0; k < 16; ++k) w[k] |= a.nonce_word[j] == (u32)k ? v : 0u;
    }
    u32 st[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) st[k] = a.mid[k];
    sha256::compress(st, w);
    if (meets(st, a.target)) {
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

// args: ARG_WORDS host words (crypto/sha256.py::kernel_args); out: a device
// word holding 0xFFFFFFFF; the current device must be `device`.  Launches on
// `stream` and returns the CUDA error of the launch (0 on success); it does
// not synchronise.  The grid's wave (SMs times resident blocks an SM) is
// asked of the runtime at the first launch on a device and kept, as the
// txid and probe kernels do: a miner's round makes no runtime query.
#define SEARCH_MAX_DEVICES 64
extern "C" int sha256_search_launch(const u32* args, int words, void* out,
                                    int device, void* stream) {
  static std::atomic<int> wave_cache[SEARCH_MAX_DEVICES];
  if (words != (int)(sizeof(SearchArgs) / sizeof(u32)) || device < 0
      || device >= SEARCH_MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  SearchArgs a;
  std::memcpy(&a, args, sizeof a);
  if (a.count == 0) return 0;
  int wave = wave_cache[device].load(std::memory_order_relaxed);
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sha256_search_kernel, SEARCH_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    wave = sms * (per_sm > 0 ? per_sm : 1);
    wave_cache[device].store(wave, std::memory_order_relaxed);
  }
  // one resident wave of blocks; the grid-stride loop covers the rest
  const u64 need = ((u64)a.count + SEARCH_THREADS - 1) / SEARCH_THREADS;
  const int blocks = (int)(need < (u64)wave ? need : (u64)wave);
  sha256_search_kernel<<<blocks, SEARCH_THREADS, 0, (cudaStream_t)stream>>>(
      a, (u32*)out);
  return (int)cudaGetLastError();
}
