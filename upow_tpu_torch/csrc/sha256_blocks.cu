// Batched SHA-256 of pre-padded messages of one length bucket: the txids
// and the two signing digests of every tx in a sync page or a block's
// verify micro-batch.
//
// Replaces upow_tpu/crypto/sha256.py::_sha256_blocks_jnp (an XLA program
// jitted per (rows, n_blocks), called by sha256_batch_jnp and txid_batch).
// Input: (batch, n_blocks * 16) message words, each the big-endian reading
// of 4 padded bytes (crypto/sha256.py::pack_bucket pads as the JAX package
// does); output: (batch, 8) digest words.  The plain PyTorch version of the
// same function is crypto/sha256.py::sha256_blocks_plain.
//
// What bounds it: 32-bit integer operations.  A compression over 16
// unknown words needs about 1,024 SHF and LOP3 (ALU pipe only, 64 per SM
// per clock) and 360 adds (crypto/sha256.py::BLOCK_ALU_OPS/BLOCK_ADD_OPS):
// about 16 clocks a compression per SM, so a sync page of 8,000 txs (about
// 40,000 compressions) is a few microseconds of work on 132 SMs.  Its
// bytes (64 a compression in, 32 a message out) take less.  At the main
// path's sizes the launch and the host-to-device copy of the padded words
// cost more than either.
//
// What the design does about it: nothing beyond the simplest right kernel.
// One thread hashes one message in a grid-stride loop, chaining
// sha256_common.cuh's fully unrolled compression from the initial state
// over its blocks, with 16-byte loads and stores; threads past the batch
// never run.  A thread's loads are its own message's words, so a warp's
// loads are strided by the message width and not coalesced: left as it is
// while the copy and the launch dominate.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_common.cuh"

typedef uint32_t u32;
typedef uint64_t u64;

#define BLOCKS_THREADS 128

__constant__ const u32 kH0[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                                 0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                                 0x1F83D9ABu, 0x5BE0CD19u};

__global__ void __launch_bounds__(BLOCKS_THREADS)
    sha256_blocks_kernel(const uint4* __restrict__ words,
                         uint4* __restrict__ out, int batch, int n_blocks) {
  const u64 stride = (u64)gridDim.x * blockDim.x;
  for (u64 m = (u64)blockIdx.x * blockDim.x + threadIdx.x; m < (u64)batch;
       m += stride) {
    const uint4* msg = words + m * (u64)n_blocks * 4;
    u32 st[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) st[k] = kH0[k];
    for (int b = 0; b < n_blocks; ++b) {
      u32 w[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = msg[b * 4 + q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
      sha256::compress(st, w);
    }
    out[2 * m] = make_uint4(st[0], st[1], st[2], st[3]);
    out[2 * m + 1] = make_uint4(st[4], st[5], st[6], st[7]);
  }
}

// words: batch * n_blocks * 16 device words; out: batch * 8 device words,
// both 16-byte aligned.  Launches on `stream` and returns the CUDA error of
// the launch (0 on success); it does not synchronise.
extern "C" int sha256_blocks_launch(const void* words, void* out, int batch,
                                    int n_blocks, void* stream) {
  if (batch < 0 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sha256_blocks_kernel, BLOCKS_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  // one resident wave of blocks at most; the grid-stride loop covers the
  // rest
  const u64 need = ((u64)batch + BLOCKS_THREADS - 1) / BLOCKS_THREADS;
  const u64 wave = (u64)sms * (u64)(per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(need < wave ? need : wave);
  sha256_blocks_kernel<<<blocks, BLOCKS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)words, (uint4*)out, batch, n_blocks);
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
