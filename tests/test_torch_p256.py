"""The port's P-256 verify (upow_tpu_torch.crypto.p256) against the JAX
package's, on the same inputs.

* Host packing: the fused (42, N) array and the oracle lists are the
  same bits in both packages, including every sanitation case.
* The plain PyTorch version of the CUDA kernel (fused scalar prep +
  Jacobian ladder) against JAX ``_scalar_prep`` + ``_jac_verify_eager``
  (the numpy twin of the Pallas kernel) on one packed array: verdict
  AND exception bit, lane for lane.  The mix includes crafted lanes that
  drive the ladder into its accumulator/table collisions, identity
  re-entry and r + n < p paths (s = 1 makes u1 = z and u2 = r, so the
  digits are chosen directly through the real interface).
* The CUDA source itself, compiled by the host's g++ under a shim that
  runs each block's threads as std::threads and each signature's group
  of four in turns (``_GROUP_SHIM``, shared with the complete kernel's
  test), so the kernel's arithmetic and its group syncs are held against
  the plain version without a card; and the kernel on the card, where
  there is one.

No tolerance: every compared value is a bit.
"""

import hashlib
import random
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upow_tpu.crypto import p256 as jp256
from upow_tpu_torch.core import curve
from upow_tpu_torch.core.constants import CURVE_GX, CURVE_GY, CURVE_N, CURVE_P
from upow_tpu_torch.crypto import p256

def _signed(i, seed, corrupt=False):
    d, pub = curve.keygen(rng=seed)
    m = bytes([i % 256]) * (i % 9 + 5)
    r, s = curve.sign(m, d)
    if corrupt:
        s = (s + 1) % CURVE_N
    return hashlib.sha256(m).digest(), (r, s), pub


def _crafted(z: int, r: int, Q):
    """s = 1 makes u1 = z and u2 = r: the ladder's digits, chosen."""
    return z.to_bytes(32, "big"), (r, 1), Q


def _neg(P):
    return (P[0], CURVE_P - P[1])


def _mix():
    """(digests, sigs, pubs) exercising every path of the fused verify."""
    G = curve.G
    lanes = [_signed(i, 4100 + i, corrupt=(i % 3 == 2)) for i in range(6)]
    d0, s0, pub0 = _signed(77, 4177)
    Q = curve.point_mul(random.Random(0x7025).randrange(1, CURVE_N), G)
    neg16 = _neg(curve.point_mul(16, G))
    lanes += [
        # accumulator meets a table pick: P1 == P2 and P1 == -P2
        _crafted(3, 3, G), _crafted(7, 7, G), _crafted(3, 3, _neg(G)),
        # multi-round: acc = [16]G meets the Q pick [1](-[16]G)
        _crafted(0x10, 0x01, neg16),
        # identity re-entry: u1-only start, u2-only start, staggered
        _crafted(0x04, 0x50, Q), _crafted(0x90, 0x03, Q),
        _crafted(0x00, 0x07, Q),
        # sanitation: off-curve, (0, 0), r >= n, coordinate in [p, 2^256)
        (d0, s0, (CURVE_GX, CURVE_GY + 1)), (d0, s0, (0, 0)),
        (d0, (CURVE_N + 3, s0[1]), pub0),
        (d0, s0, (pub0[0] + CURVE_P, pub0[1])) if pub0[0] + CURVE_P < 2 ** 256
        else (d0, s0, (pub0[0], pub0[1] + CURVE_P)),
        # oversized digest (reduced mod n on the host) and hostile ints
        (hashlib.sha512(b"big").digest(), s0, pub0),
        (d0, (-1, s0[1]), pub0), (d0, (s0[0], 1 << 280), pub0),
        (d0, s0, (pub0[0] + (1 << 257), -5)),
        (d0, s0, pub0),
    ]
    return tuple(list(x) for x in zip(*lanes))


def test_pack_device_inputs_matches_jax():
    digests, sigs, pubs = _mix()
    n = len(digests)
    mine = p256._pack_device_inputs(digests, sigs, pubs, n)
    theirs = jp256._pack_device_inputs(digests, sigs, pubs, n)
    assert np.array_equal(mine[0], np.asarray(theirs[0]))
    assert mine[0].dtype == np.uint32
    assert list(mine[1:]) == list(theirs[1:])
    packed = p256.packed_tensor(mine[0], "cpu")
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (42, n)
    assert np.array_equal(packed.numpy().view(np.uint32), mine[0])


def test_plain_fused_verify_matches_jax_prep_and_eager():
    """Verdict and exception bit of every lane, against the JAX scalar
    prep (jit on the CPU) and the numpy twin of the Pallas kernel."""
    digests, sigs, pubs = _mix()
    n = len(digests)
    fused, zs, rs, ss, qxs, qys = p256._pack_device_inputs(
        digests, sigs, pubs, n)
    d1, d2, qx, qy, rm, rnm, flags = (
        np.asarray(a) for a in jp256._scalar_prep(
            *jp256._unpack_fused(jnp.asarray(fused))))
    ok_j, exc_j = jp256._jac_verify_eager(d1, d2, qx, qy, rm, rnm,
                                          flags[0] != 0, flags[1] != 0)

    launches = p256.LAUNCHES
    bits = p256.verify_packed(p256.packed_tensor(fused, "cpu")).numpy()
    assert p256.LAUNCHES == launches  # a CPU tensor never launches
    assert list((bits & 1) != 0) == list(ok_j)
    assert list((bits & 2) != 0) == list(exc_j)
    # the crafted collisions really reach the exception path, and the
    # honest lanes agree with the host oracle
    # (lanes 6-9; lane 14's (0, 0) pubkey builds a garbage Q table that
    # collides too — the verdict is masked by range_ok either way)
    assert list(np.nonzero(exc_j)[0]) == [6, 7, 8, 9, 14]
    for i in range(6):
        assert bool(bits[i] & 1) == p256._host_verify_prehashed(
            zs[i], rs[i], ss[i], qxs[i], qys[i])
    assert bits[-1] & 1 and not bits[-1] & 2


def test_mults_per_lane_counts_the_formulas():
    counts = p256.mults_per_lane()
    # prep 341 + mod-p 6 + Q table 151 + ladder 64 x 59 + final 3
    assert sum(counts.values()) == 341 + 6 + 151 + 64 * 59 + 3
    assert counts == {"n_mul": 83, "n_sqr": 256, "n_red": 2,
                      "p_mul": 2020, "p_sqr": 1916}
    digests, sigs, pubs = _mix()
    _f, zs, rs, ss, qxs, qys = p256._pack_device_inputs(
        digests, sigs, pubs, len(digests))

    def need(i):
        return p256.mul_ops_needed(zs[i:i + 1], rs[i:i + 1], ss[i:i + 1],
                                   qxs[i:i + 1], qys[i:i + 1])

    ops = p256.MUL_OPS
    assert need(14) == need(15) == 0  # (0, 0) pubkey; r >= n
    assert need(13) == 3 * ops["p_mul"] + 2 * ops["p_sqr"]  # off the curve
    # lane 12: u1 = 0 and u2 = 7, so the ladder only picks [7]Q in its
    # last round; n - 2 has 56 nonzero digits, 55 after the first
    assert need(12) == (ops["p_mul"] * (3 + 94 + 3) + ops["p_sqr"] * (2 + 57 + 1)
                        + ops["n_mul"] * (1 + 14 + 55 + 4)
                        + ops["n_sqr"] * 4 * 63 + ops["n_red"] * 2)
    # an honest lane skips only zero digits of the full count, and needs
    # about 40 % of the generic CIOS cost (264 operations a product)
    full = sum(ops[k] * v for k, v in counts.items())
    assert 0.9 * full < need(21) < full
    assert 0.35 < need(21) / (sum(counts.values()) * 264) < 0.45


# The CUDA names the group kernels use (p256_verify.cu, p256_complete.cu
# and p256_verify_wide.cu, groups of four threads), for the host's g++
# (C++20): a block's threads run as std::threads, threadIdx and blockIdx
# thread-local, dynamic shared memory one buffer for the block.
# __syncwarp(mask) with a mask that names the caller's group of four
# exactly hands the group on in turns: after a sync the group's ranks run
# one at a time, each up to its next sync, in the order 3, 2, 1, 0 in even
# groups and 0, 1, 2, 3 in odd ones.  So a rank that reads another's
# shared memory before a sync that orders the two reads it stale, every
# run alike, and a dropped sync shows.  Before a group's first sync its
# ranks run freely.  __syncthreads counts as a group sync for the caller's
# group, then waits for the whole block, then the group goes on in turns;
# any other __syncwarp mask aborts.
_GROUP_SHIM = r"""
#pragma once
#include <barrier>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>
typedef int cudaError_t;
typedef void* cudaStream_t;
static const int cudaErrorInvalidValue = 1;
#define __device__
#define __global__
#define __constant__
#define __shared__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct dim3_ { unsigned x; };
inline thread_local dim3_ blockIdx, threadIdx;
struct Turns {
  std::mutex m;
  std::condition_variable cv;
  int phase = 0, arrived = 0, turn = -1;
};
struct BlockSync {
  explicit BlockSync(int threads) : block(threads), groups(threads / 4) {}
  std::barrier<> block;
  std::vector<Turns> groups;
};
inline BlockSync* g_sync;
// under the group's lock: the calling rank is done with the current
// phase; pass the turn on, and the group's last arrival opens the next
// phase at its first rank.  Returns the phase the caller finished.
inline int group_arrive(Turns& t) {
  const int grp = threadIdx.x / 4, rank = threadIdx.x & 3;
  const int phase = t.phase;
  if (++t.arrived == 4) {
    t.arrived = 0;
    ++t.phase;
    t.turn = grp & 1 ? 0 : 3;
  } else {
    t.turn = grp & 1 ? rank + 1 : rank - 1;
  }
  t.cv.notify_all();
  return phase;
}
inline Turns& turns() { return g_sync->groups[threadIdx.x / 4]; }
// the group's arrival and hand-over, the block's barrier, then the
// group's next phase in turns
inline void __syncthreads() {
  Turns& t = turns();
  int phase;
  {
    std::lock_guard<std::mutex> lk(t.m);
    phase = group_arrive(t);
  }
  g_sync->block.arrive_and_wait();
  std::unique_lock<std::mutex> lk(t.m);
  const int rank = threadIdx.x & 3;
  t.cv.wait(lk, [&] { return t.phase > phase && t.turn == rank; });
}
inline void __syncwarp(unsigned mask) {
  if (mask != 0xFu << (threadIdx.x & 31 & ~3u)) std::abort();
  Turns& t = turns();
  std::unique_lock<std::mutex> lk(t.m);
  const int phase = group_arrive(t);
  const int rank = threadIdx.x & 3;
  t.cv.wait(lk, [&] { return t.phase > phase && t.turn == rank; });
}
inline void group_exit() {  // the thread left the kernel
  Turns& t = turns();
  std::lock_guard<std::mutex> lk(t.m);
  group_arrive(t);
}
template <class T, class U>
cudaError_t cudaMemcpyToSymbol(T& sym, const U* src, size_t n) {
  std::memcpy(&sym, src, n);
  return 0;
}
"""

# main() for a group kernel (KERNEL: its name), included after the
# kernel's source so that it launches the kernel's own block shape.
_GROUP_MAIN = r"""
#include <cstdio>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
extern "C" int p256_set_constants(const uint32_t* host, int words);
alignas(16) uint32_t smem[1 << 16];
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int nc = 0, n = 0;
  if (fread(&nc, 4, 1, f) != 1) return 2;
  std::vector<uint32_t> c(nc);
  if (fread(c.data(), 4, nc, f) != (size_t)nc) return 2;
  if (fread(&n, 4, 1, f) != 1) return 2;
  std::vector<uint32_t> pk(42 * (size_t)n);
  if (fread(pk.data(), 4, pk.size(), f) != pk.size()) return 2;
  fclose(f);
  if (p256_set_constants(c.data(), nc) != 0) return 3;
  std::vector<int32_t> out(n, -1);
  const int threads = THREADS, blocks = (n + SIGS - 1) / SIGS;
  for (int b = 0; b < blocks; ++b) {
    memset(smem, 0xA5, sizeof smem);  // shared memory starts undefined
    BlockSync sync(threads);
    g_sync = &sync;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        KERNEL(pk.data(), out.data(), n);
        group_exit();
      });
    for (auto& t : ts) t.join();
  }
  FILE* g = fopen(argv[2], "wb");
  fwrite(out.data(), 4, n, g);
  fclose(g);
  return 0;
}
"""


def build_group_kernel(tmp: Path, name: str, kernel: str = "",
                       main: str = "") -> Path:
    """csrc/<name>.cu built by the host's g++ under _GROUP_SHIM, running
    its ``kernel`` (by default ``<name>_kernel``) under _GROUP_MAIN, or
    under ``main`` (a whole main.cpp that includes "kernel.cpp"); returns
    the binary, which reads (constants, n, packed) and writes n int32."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    csrc = Path(p256.__file__).parent.parent / "csrc"
    src = (csrc / f"{name}.cu").read_text()
    # the launch wrapper is CUDA-only syntax; the kernel is called directly
    src = src[:src.index(f'extern "C" int {name}_launch')]
    (tmp / "cuda_runtime.h").write_text(_GROUP_SHIM)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, tmp)
    (tmp / "kernel.cpp").write_text(src)
    (tmp / "main.cpp").write_text(main or '#include "kernel.cpp"\n' + _GROUP_MAIN
                                  .replace("KERNEL", kernel or f"{name}_kernel"))
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-I", str(tmp),
                    str(tmp / "main.cpp"), "-o", str(tmp / "kernel")],
                   check=True, capture_output=True, timeout=300)
    return tmp / "kernel"


def run_group_kernel(binary: Path, fused: np.ndarray) -> np.ndarray:
    """The g++-built kernel on one packed (42, n) uint32 array."""
    n = fused.shape[1]
    consts = p256.kernel_constants()
    blob = (np.array([consts.size], np.int32).tobytes() + consts.tobytes()
            + np.array([n], np.int32).tobytes() + fused.tobytes())
    inp, outp = binary.with_name(f"in{n}.bin"), binary.with_name(f"out{n}.bin")
    inp.write_bytes(blob)
    subprocess.run([str(binary), str(inp), str(outp)], check=True,
                   timeout=300)
    return np.fromfile(outp, dtype=np.int32)


def _mix_lanes(lanes):
    """The mix, repeated to ``lanes`` lanes."""
    digests, sigs, pubs = _mix()
    reps = -(-lanes // len(digests))
    return tuple((x * reps)[:lanes] for x in (digests, sigs, pubs))


@pytest.fixture(scope="module")
def jac_kernel(tmp_path_factory):
    return build_group_kernel(tmp_path_factory.mktemp("jac"), "p256_verify")


@pytest.mark.parametrize("lanes", [22, 33])
def test_kernel_source_matches_plain_under_host_compiler(jac_kernel, lanes):
    """csrc/p256_verify.cu, device code compiled as host C++ with each
    block's threads run as std::threads (groups of four synced in turns),
    against the plain PyTorch version, bit for bit: the mix (22 lanes, a
    partial warp and block) and the mix repeated to 33 lanes (one live
    group in a second block).  The mix's 5 exception lanes stay flagged
    in every copy."""
    digests, sigs, pubs = _mix_lanes(lanes)
    fused = p256._pack_device_inputs(digests, sigs, pubs, lanes)[0]
    got = run_group_kernel(jac_kernel, fused)
    want = p256.verify_plain(p256.packed_tensor(fused, "cpu")).numpy()
    assert got.tolist() == want.tolist()
    n0 = len(_mix()[0])
    assert [i for i in range(lanes) if got[i] & 2] == \
        [i for i in range(lanes) if i % n0 in (6, 7, 8, 9, 14)]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8192, 1026, 33, 1])
def test_kernel_matches_plain_on_card(lanes):
    """The CUDA kernel against its plain version on the card, bit for
    bit, at a full block of signatures, the accept's two launch shapes
    and a partial warp (runs on a machine with a card; skips
    elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    digests, sigs, pubs = _mix_lanes(lanes)
    fused = p256._pack_device_inputs(digests, sigs, pubs, lanes)[0]
    packed = p256.packed_tensor(fused, "cuda")
    launches = p256.LAUNCHES
    got = p256.verify_packed(packed)
    torch.cuda.synchronize()
    assert p256.LAUNCHES == launches + 1
    assert torch.equal(got, p256.verify_plain(packed))
