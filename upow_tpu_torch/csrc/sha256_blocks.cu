// Batched SHA-256 of pre-padded messages of any lengths in one launch:
// the txids and the two signing digests of every tx in a sync page or a
// block's verify micro-batch.
//
// Replaces upow_tpu/crypto/sha256.py::_sha256_blocks_jnp (an XLA program
// jitted per (rows, n_blocks), called by sha256_batch_jnp and txid_batch
// once a length bucket).  Input: the padded messages' big-endian words
// back to back (crypto/sha256.py::pack_ragged pads as the JAX package
// does) and a table of one (block offset, n_blocks) pair a message, or no
// table and one block count for a uniform batch (row m at m * n_blocks
// blocks); output: 8 digest words a table row.  The plain PyTorch version
// of the same function is crypto/sha256.py::sha256_ragged_plain (and
// sha256_blocks_plain for a uniform batch).
//
// What bounds it: 32-bit integer operations in aggregate.  A compression
// over 16 unknown words needs about 1,024 SHF and LOP3 (ALU pipe only, 64
// per SM per clock) and 360 adds (crypto/sha256.py::BLOCK_ALU_OPS and
// BLOCK_ADD_OPS): about 16 clocks a compression per SM, so a sync page of
// 8,420 txs (about 30,000 compressions) is a few microseconds of work on
// 132 SMs; its bytes take less.  But a message's blocks are serial
// (Merkle-Damgard), so the longest message is one thread's chain of
// compressions whatever the layout: a page's 154-block fan tx is at least
// 154 compressions of about 1,431 instructions issued in a row.
//
// What the design does about it.  One launch a batch: one thread a table
// row in a grid-stride loop over one resident wave, the rows longest
// first (the wrapper orders them), so the longest chain starts in the
// first warp at once and the short messages fill the other SMs while it
// runs.  A thread chains sha256_common.cuh's fully unrolled compression
// over its blocks from the initial state, and loads the next block's four
// 16-byte words before it compresses the current one, so the loads of a
// long chain overlap its arithmetic.  The launch reads the grid's wave
// from a per-device cache filled at the first launch on a device.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_common.cuh"

typedef uint32_t u32;
typedef uint64_t u64;

#define BLOCKS_THREADS 128

__constant__ const u32 kH0[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                                 0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                                 0x1F83D9ABu, 0x5BE0CD19u};

// table: rows (block offset, n_blocks), or null for a uniform batch of
// `uniform_blocks` blocks a row
__global__ void __launch_bounds__(BLOCKS_THREADS)
    sha256_blocks_kernel(const uint4* __restrict__ words,
                         const int2* __restrict__ table, int uniform_blocks,
                         uint4* __restrict__ out, int rows) {
  const u64 stride = (u64)gridDim.x * blockDim.x;
  for (u64 m = (u64)blockIdx.x * blockDim.x + threadIdx.x; m < (u64)rows;
       m += stride) {
    u64 offset;
    int n_blocks;
    if (table != nullptr) {
      const int2 row = table[m];
      offset = (u64)row.x;
      n_blocks = row.y;
    } else {
      offset = m * (u64)uniform_blocks;
      n_blocks = uniform_blocks;
    }
    const uint4* msg = words + offset * 4;
    u32 st[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) st[k] = kH0[k];
    uint4 next[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) next[q] = msg[q];
    for (int b = 0; b < n_blocks; ++b) {
      u32 w[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[4 * q] = next[q].x;
        w[4 * q + 1] = next[q].y;
        w[4 * q + 2] = next[q].z;
        w[4 * q + 3] = next[q].w;
      }
      // the next block's words in flight while this one is compressed
      if (b + 1 < n_blocks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) next[q] = msg[(b + 1) * 4 + q];
      }
      sha256::compress(st, w);
    }
    out[2 * m] = make_uint4(st[0], st[1], st[2], st[3]);
    out[2 * m + 1] = make_uint4(st[4], st[5], st[6], st[7]);
  }
}

// --- the host side: the launch path --------------------------------------

// Blocks in one resident wave of the kernel on device `dev`, asked of the
// runtime at the first launch on that device and kept (0: not yet asked).
#define MAX_DEVICES 64
static std::atomic<int> g_wave[MAX_DEVICES];

static cudaError_t wave_blocks(int dev, int* blocks) {
  int wave = g_wave[dev].load(std::memory_order_relaxed);
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sha256_blocks_kernel, BLOCKS_THREADS, 0);
    if (err != cudaSuccess) return err;
    wave = sms * (per_sm > 0 ? per_sm : 1);
    g_wave[dev].store(wave, std::memory_order_relaxed);
  }
  *blocks = wave;
  return cudaSuccess;
}

// words: the messages' device words, 16-byte aligned; table: `rows` int32
// (block offset, n_blocks) pairs on the device, or null with
// uniform_blocks >= 1; out: rows * 8 device words, 16-byte aligned; the
// current device must be `device`.  Launches on `stream` and returns the
// CUDA error of the launch (0 on success); it does not synchronise.  The
// table's offsets and counts are the caller's to keep inside `words`.
extern "C" int sha256_blocks_launch(const void* words, const void* table,
                                    int uniform_blocks, void* out, int rows,
                                    int device, void* stream) {
  if (rows < 0 || (table == nullptr && uniform_blocks < 1) || device < 0
      || device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int wave = 0;
  const cudaError_t err = wave_blocks(device, &wave);
  if (err != cudaSuccess) return (int)err;
  // one resident wave of blocks at most; the grid-stride loop covers the
  // rest
  const u64 need = ((u64)rows + BLOCKS_THREADS - 1) / BLOCKS_THREADS;
  const int blocks = (int)(need < (u64)wave ? need : (u64)wave);
  sha256_blocks_kernel<<<blocks, BLOCKS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)words, (const int2*)table, uniform_blocks, (uint4*)out,
      rows);
  return (int)cudaGetLastError();
}

// Threads a block, registers a thread, local (stack) bytes a thread.
extern "C" int sha256_blocks_attributes(int* out3) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, sha256_blocks_kernel);
  if (err != cudaSuccess) return (int)err;
  out3[0] = BLOCKS_THREADS;
  out3[1] = fa.numRegs;
  out3[2] = (int)fa.localSizeBytes;
  return 0;
}
