// The resident UTXO index's windowed sorted probe: per outpoint of an
// accept micro-batch, is it in the index, and what amount does it hold.
//
// Replaces upow_tpu/state/device_index.py::_probe_kernel (an XLA program
// jitted per (capacity, queries), called by DeviceUtxoIndex._probe_eval and
// fused_probe).  Input: six (cap,) int32 resident lanes (keys_hi sorted
// ascending as signed int32, keys_lo, chk_a, chk_b, amt_lo, amt_hi), of
// which the first n_live rows are live and the rest pads (keys I32_MAX,
// the rest 0), and four (q,) int32 query lanes.  Output per query: hit (all
// four identity lanes equal in one of the window's slots), key_hit (the two
// key lanes equal), overflow (the high lane still equal at the window's
// last slot), one byte each, and the two amount lanes at the first full
// match, or at the lower bound when nothing matches, clipped to cap - 1.
// The plain PyTorch version of the same function is
// state/device_index.py::probe_plain.
//
// What bounds it: bytes, and few of them.  A query reads about
// log2(n_live) keys_hi words on its search path and a few window and
// amount words (state/device_index.py::probe_bytes_needed counts them at
// 32-byte sectors), about 4-5 MB for 8,192 queries on 2^24 keys: about
// 1.3 us at 3.35 TB/s.  The operations are a few compares a word.  What
// costs more is latency: a binary search is a chain of dependent loads,
// about 24 of them at 2^24 keys, each a trip to L2 or device memory, and
// the launch itself (about 0.02-0.03 ms for the port's other kernels).
//
// What the design does about it: nothing beyond the simplest right kernel.
// One thread a query in a grid-stride loop over the queries (threads past
// the batch never run): a signed lower bound over keys_hi[0, n_live), which
// gives the position the JAX program's search over the whole padded
// capacity gives, since the pads are I32_MAX and sort last; then the
// window's slots from that position, comparing the high lane first and
// stopping at its first mismatch (the keys are sorted, so no later slot
// can match), then the low lane, then the two check lanes.  Keeping the
// top levels of the search in shared memory, or a warp searching
// together, is later work.

#include <cstdint>
#include <cuda_runtime.h>

#define PROBE_THREADS 256

__global__ void __launch_bounds__(PROBE_THREADS)
    utxo_probe_kernel(const int* __restrict__ keys_hi,
                      const int* __restrict__ keys_lo,
                      const int* __restrict__ chk_a,
                      const int* __restrict__ chk_b,
                      const int* __restrict__ amt_lo,
                      const int* __restrict__ amt_hi, int n_live, int cap,
                      const int* __restrict__ q_hi,
                      const int* __restrict__ q_lo,
                      const int* __restrict__ q_ca,
                      const int* __restrict__ q_cb, int q, int window,
                      unsigned char* __restrict__ hit,
                      unsigned char* __restrict__ key_hit,
                      unsigned char* __restrict__ overflow,
                      int* __restrict__ out_lo, int* __restrict__ out_hi) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < q; i += stride) {
    const int h = q_hi[i];
    // lower bound: the first live row whose high lane is >= h, compared
    // as signed int32 (the host's sign flip made uint32 order int32 order)
    int pos = 0, len = n_live;
    while (len > 0) {
      const int half = len >> 1;
      if (keys_hi[pos + half] < h) {
        pos += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    const int lo = q_lo[i], ca = q_ca[i], cb = q_cb[i];
    bool any_key = false, ovf = false;
    int first = -1;
    for (int k = 0; k < window; ++k) {
      const int j = pos + k;
      if (j >= n_live || keys_hi[j] != h) break;
      if (k == window - 1) ovf = true;
      if (keys_lo[j] != lo) continue;
      any_key = true;
      if (first < 0 && chk_a[j] == ca && chk_b[j] == cb) first = k;
    }
    int row = pos + (first < 0 ? 0 : first);
    if (row > cap - 1) row = cap - 1;
    hit[i] = first >= 0;
    key_hit[i] = any_key;
    overflow[i] = ovf;
    out_lo[i] = amt_lo[row];
    out_hi[i] = amt_hi[row];
  }
}

// Six resident lanes of cap >= 1 rows (0 <= n_live <= cap), four query
// lanes and five outputs of q rows, all device pointers.  Launches on
// `stream` and returns the CUDA error of the launch (0 on success); it
// does not synchronise.
extern "C" int utxo_probe_launch(const void* keys_hi, const void* keys_lo,
                                 const void* chk_a, const void* chk_b,
                                 const void* amt_lo, const void* amt_hi,
                                 int n_live, int cap, const void* q_hi,
                                 const void* q_lo, const void* q_ca,
                                 const void* q_cb, int q, int window,
                                 void* hit, void* key_hit, void* overflow,
                                 void* out_lo, void* out_hi, void* stream) {
  if (cap < 1 || n_live < 0 || n_live > cap || q < 0 || window < 1)
    return (int)cudaErrorInvalidValue;
  if (q == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, utxo_probe_kernel, PROBE_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  // one resident wave of blocks at most; the grid-stride loop covers the
  // rest
  const long long need = ((long long)q + PROBE_THREADS - 1) / PROBE_THREADS;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(need < wave ? need : wave);
  utxo_probe_kernel<<<blocks, PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)keys_hi, (const int*)keys_lo, (const int*)chk_a,
      (const int*)chk_b, (const int*)amt_lo, (const int*)amt_hi, n_live, cap,
      (const int*)q_hi, (const int*)q_lo, (const int*)q_ca, (const int*)q_cb,
      q, window, (unsigned char*)hit, (unsigned char*)key_hit,
      (unsigned char*)overflow, (int*)out_lo, (int*)out_hi);
  return (int)cudaGetLastError();
}

// Threads a block, registers a thread, local (stack) bytes a thread.
extern "C" int utxo_probe_attributes(int* out3) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, utxo_probe_kernel);
  if (err != cudaSuccess) return (int)err;
  out3[0] = PROBE_THREADS;
  out3[1] = fa.numRegs;
  out3[2] = (int)fa.localSizeBytes;
  return 0;
}
