// The resident UTXO index's windowed sorted probe: per outpoint of an
// accept micro-batch, is it in the index, and what amount does it hold.
//
// Replaces upow_tpu/state/device_index.py::_probe_kernel (an XLA program
// jitted per (capacity, queries), called by DeviceUtxoIndex._probe_eval and
// fused_probe).  Input: six (cap,) int32 resident lanes (keys_hi sorted
// ascending as signed int32, keys_lo, chk_a, chk_b, amt_lo, amt_hi), of
// which the first n_live rows are live and the rest pads (keys I32_MAX,
// the rest 0), a fence of every 2^shift-th live keys_hi, and (4, q)
// int32 query lanes.  Output per query: hit (all four identity lanes equal
// in one of the window's slots), key_hit (the two key lanes equal),
// overflow (the high lane still equal at the window's last slot), one
// byte each, and the two amount lanes at the first full match, or at the
// lower bound when nothing matches, clipped to cap - 1.  The plain
// PyTorch version of the same function is state/device_index.py::
// probe_plain.
//
// What bounds it: bytes, and few of them.  A query reads about
// log2(n_live) keys_hi words on its search path and a few window and
// amount words (state/device_index.py::probe_bytes_needed counts them at
// 32-byte sectors), about 3.5 MB for 8,192 queries on 2^24 keys: about
// 1 us at 3.35 TB/s.  The operations are a few compares a word.  What
// costs more is latency: a binary search is a chain of dependent loads,
// 24 of them at 2^24 keys, each a trip to L2 or device memory; and the
// host's launch path around the kernel.
//
// What the design does about it.  The search's top levels live in
// shared memory: the wrapper keeps a fence of every 2^shift-th live key
// (at most FENCE_MAX entries, 32 KB, gathered on the card when the
// index's lanes are uploaded), each block copies it in once, and a
// query's lower bound runs first over the fence and then over the one
// segment of keys_hi between two fence points: at 2^24 keys 13 levels in
// shared memory and 11 dependent loads from global memory instead of 24,
// the last three inside one 32-byte sector.  One thread a query in a
// grid-stride loop over at most one resident wave of blocks, so a block
// loads the fence once however many queries it takes.  Then the window's
// slots from the lower bound, comparing the high lane first and stopping
// at its first mismatch (the keys are sorted, so no later slot can
// match), then the low lane, then the two check lanes.  The launch path
// takes one prepared argument block (the lanes' pointers, n_live, cap,
// the fence and the device, built once an upload) and reads the grid's
// wave from a per-device cache filled at the first launch on a device.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cuda_runtime.h>

#define PROBE_THREADS 256
// fence entries a block keeps in shared memory (32 KB); the wrapper picks
// the least shift that fits the live keys into it
#define FENCE_MAX 8192

// the resident side of a probe, by value: six lanes, the fence, sizes
struct ProbeLanes {
  const int* keys_hi;
  const int* keys_lo;
  const int* chk_a;
  const int* chk_b;
  const int* amt_lo;
  const int* amt_hi;
  const int* fence;  // keys_hi[j << shift] for j < n_fence, 16-byte aligned
  int n_live, cap, n_fence, shift;
};

// the lower bound's order: signed int32 (the host's sign flip made
// uint32 order int32 order)
__device__ __forceinline__ bool below(int key, int h) { return key < h; }

// the first of `len` keys from `base` whose key is not below h, as an
// offset from base (len when there is none)
__device__ __forceinline__ int lower_bound(const int* base, int len, int h) {
  int pos = 0;
  while (len > 0) {
    const int half = len >> 1;
    if (below(base[pos + half], h)) {
      pos += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return pos;
}

// queries: (4, q) lanes, key high and low, check a and b; out: q amt_lo
// words, q amt_hi words, then q bytes each of hit, key_hit and overflow
__global__ void __launch_bounds__(PROBE_THREADS)
    utxo_probe_kernel(ProbeLanes r, const int* __restrict__ queries, int q,
                      int window, unsigned char* __restrict__ out) {
  __shared__ __align__(16) int fence[FENCE_MAX];
  // the fence in 16-byte words, eight a thread in flight at once (one
  // round trip for 256 threads and 8,192 entries), then the odd tail
  const int n4 = r.n_fence >> 2;
  const int4* src4 = (const int4*)r.fence;
  int4* dst4 = (int4*)fence;
  for (int base = threadIdx.x; base < n4; base += 8 * blockDim.x) {
    int4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = base + k * (int)blockDim.x;
      if (j < n4) v[k] = src4[j];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = base + k * (int)blockDim.x;
      if (j < n4) dst4[j] = v[k];
    }
  }
  for (int j = 4 * n4 + threadIdx.x; j < r.n_fence; j += blockDim.x)
    fence[j] = r.fence[j];
  __syncthreads();
  int* out_lo = (int*)out;
  int* out_hi = out_lo + q;
  unsigned char* hit = out + 8 * (size_t)q;
  unsigned char* key_hit = hit + q;
  unsigned char* overflow = key_hit + q;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < q; i += stride) {
    const int h = queries[i];
    // the first fence point not below h; the live keys below it end in
    // the segment after the fence point before it
    const int J = lower_bound(fence, r.n_fence, h);
    int pos = 0;
    if (J > 0) {
      const int seg = J - 1;
      pos = (seg << r.shift) + 1;
      const long long end_ll = (long long)(seg + 1) << r.shift;
      const int end = end_ll < r.n_live ? (int)end_ll : r.n_live;
      const int len = end - pos;
      pos += lower_bound(r.keys_hi + pos, len, h);
    }
    const int lo = queries[q + i], ca = queries[2 * (size_t)q + i],
              cb = queries[3 * (size_t)q + i];
    bool any_key = false, ovf = false;
    int first = -1;
    for (int k = 0; k < window; ++k) {
      const int j = pos + k;
      if (j >= r.n_live || r.keys_hi[j] != h) break;
      if (k == window - 1) ovf = true;
      if (r.keys_lo[j] != lo) continue;
      any_key = true;
      if (first < 0 && r.chk_a[j] == ca && r.chk_b[j] == cb) first = k;
    }
    int row = pos + (first < 0 ? 0 : first);
    if (row > r.cap - 1) row = r.cap - 1;
    hit[i] = first >= 0;
    key_hit[i] = any_key;
    overflow[i] = ovf;
    out_lo[i] = r.amt_lo[row];
    out_hi[i] = r.amt_hi[row];
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
          &per_sm, utxo_probe_kernel, PROBE_THREADS, 0);
    if (err != cudaSuccess) return err;
    wave = sms * (per_sm > 0 ? per_sm : 1);
    g_wave[dev].store(wave, std::memory_order_relaxed);
  }
  *blocks = wave;
  return cudaSuccess;
}

// The prepared argument block, int64 words: the six lanes' and the
// fence's device pointers, then n_live, cap, n_fence, shift and the
// device ordinal (state/device_index.py::ProbeArgs writes it).
enum { P_FENCE = 6, P_N_LIVE, P_CAP, P_N_FENCE, P_SHIFT, P_DEVICE };

// (4, q) int32 query lanes and one 11 * q-byte output, device pointers
// on the prepared block's device, which must be the current one.
// Launches on `stream` and returns the CUDA error of the launch (0 on
// success); it does not synchronise.
extern "C" int utxo_probe_launch(const long long* prepared,
                                 const void* queries, int q, int window,
                                 void* out, void* stream) {
  ProbeLanes r;
  r.keys_hi = (const int*)prepared[0];
  r.keys_lo = (const int*)prepared[1];
  r.chk_a = (const int*)prepared[2];
  r.chk_b = (const int*)prepared[3];
  r.amt_lo = (const int*)prepared[4];
  r.amt_hi = (const int*)prepared[5];
  r.fence = (const int*)prepared[P_FENCE];
  r.n_live = (int)prepared[P_N_LIVE];
  r.cap = (int)prepared[P_CAP];
  r.n_fence = (int)prepared[P_N_FENCE];
  r.shift = (int)prepared[P_SHIFT];
  const long long dev = prepared[P_DEVICE];
  if (r.cap < 1 || r.n_live < 0 || r.n_live > r.cap || q < 0 || window < 1
      || r.n_fence < 0 || r.n_fence > FENCE_MAX || r.shift < 0
      || r.shift > 30
      || r.n_fence != (int)(((long long)r.n_live + (1ll << r.shift) - 1)
                            >> r.shift)
      || (prepared[P_FENCE] & 15) != 0 || dev < 0 || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  if (q == 0) return 0;
  int wave = 0;
  const cudaError_t err = wave_blocks((int)dev, &wave);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)q + PROBE_THREADS - 1) / PROBE_THREADS;
  const int blocks = (int)(need < wave ? need : wave);
  utxo_probe_kernel<<<blocks, PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      r, (const int*)queries, q, window, (unsigned char*)out);
  return (int)cudaGetLastError();
}

// Threads a block, registers a thread, local (stack) bytes a thread,
// static shared bytes a block.
extern "C" int utxo_probe_attributes(int* out4) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, utxo_probe_kernel);
  if (err != cudaSuccess) return (int)err;
  out4[0] = PROBE_THREADS;
  out4[1] = fa.numRegs;
  out4[2] = (int)fa.localSizeBytes;
  out4[3] = (int)fa.sharedSizeBytes;
  return 0;
}

// Mean nanoseconds of the launch's per-launch configuration lookup (the
// cached wave of the device the caller is on), over `reps` calls timed
// here in C: the C side of the launch path apart from the launch.
extern "C" double utxo_probe_query_ns(int reps) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  long long sink = 0;
  for (int r = 0; r < reps; ++r) {
    int wave = 0;
    wave_blocks(dev, &wave);
    sink += wave;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return sink < 0 ? -1.0
                  : std::chrono::duration<double, std::nano>(t1 - t0).count()
                        / (reps > 0 ? reps : 1);
}
