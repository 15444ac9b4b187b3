"""The port's resident UTXO index against the JAX package's.

Inputs are made from a numpy seed and go through both packages:

* the host fingerprints (``fingerprint``, ``fingerprint_batch``,
  ``check_fp``, ``check_batch``) and the query lanes;
* ``probe_plain`` against JAX ``_probe_kernel`` on all five outputs and
  every lane, over planted cases at up to 2^12 keys: a 12-entry run equal
  on the high lane (overflow at window 8), 64-bit twins (one key, other
  check lanes), a key whose high lane is ``I32_MAX``, a full capacity
  with no pad row, and ``n_live`` 0 and 1; half the queries present, a
  quarter equal on the high lane only, a quarter absent;
* ``DeviceUtxoIndex(device="cpu")`` against the JAX ``DeviceUtxoIndex``
  under one add / remove / apply_block / rollback_block sequence: every
  answer, ``stats()``, ``len`` and ``undo_depth`` after each step, with
  the universal-collision and 8,192-entry twin-pair cases of
  ``tests/test_device_index.py`` (``fingerprint_batch`` patched in both
  modules), the absent-remove no-op and the end of the undo log;
* the fence cases: a run of equal high lanes longer than the fence's
  stride that crosses fence points, queries at every fence point and
  the row before it, at ``n_live`` 0, 1 and sizes that are not a
  multiple of the stride, ``probe_plain`` against JAX there too;
* the prepared arguments (``ProbeArgs``): the fence and the argument
  block, the one-buffer layout on the CPU, the checks, and the index's
  refusal to probe lanes that changed pointer, shape or device since
  the upload;
* ``csrc/utxo_probe.cu`` compiled by the host's g++ under a shim that
  runs a block's threads as threads (``__syncthreads`` a barrier, the
  fence in one static buffer), on a ragged grid of 3 blocks of 5, at
  fence shifts from 0 (every key) to one fence point, against
  ``probe_plain``; and six mutations of it (an upper bound for the
  lower bound, an unsigned compare, a window one slot short, the
  segment one stride late, a segment one row short, the fence's last
  entries past a multiple of four left unloaded), each of which must
  disagree;
* the CUDA kernel itself on a card (``cuda`` marker; skips here).

The tolerance is exact: equal booleans and int32 lanes.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import upow_tpu.state.device_index as jdi
import upow_tpu_torch.state.device_index as tdi

RNG_SEED = 0x1DE8
I32_MAX = np.iinfo(np.int32).max
_U64 = (1 << 64) - 1
SIZES = [0, 1, 37, 64, 1024, 4096]
HI = np.uint64(0xFFFFFFFF00000000)
# (n_live, fence shift) of the fence cases: empty and one-row indexes, a
# run of 2.5 strides, sizes that are no multiple of the stride, a single
# fence point
FENCE_CASES = [(0, 0), (0, 3), (1, 0), (1, 2), (2, 1), (45, 3), (300, 1),
               (1029, 4), (4095, 12), (4096, 6)]


def _op(i: int, idx: int = 0):
    return (int(i).to_bytes(32, "big").hex(), idx)


def _random_ops(rng, n):
    return [(rng.bytes(32).hex(), int(rng.integers(0, 4))) for _ in range(n)]


def test_fingerprints_match_jax():
    rng = np.random.default_rng(RNG_SEED)
    ops = _random_ops(rng, 257) + [_op(0), _op(1, 255), ("ff" * 32, 7)]
    np.testing.assert_array_equal(tdi.fingerprint_batch(ops),
                                  jdi.fingerprint_batch(ops))
    np.testing.assert_array_equal(tdi.check_batch(ops), jdi.check_batch(ops))
    assert [tdi.fingerprint(o) for o in ops] == \
        [jdi.fingerprint(o) for o in ops]
    assert [tdi.check_fp(o) for o in ops] == [jdi.check_fp(o) for o in ops]
    fps, chks = tdi.fingerprint_batch(ops), tdi.check_batch(ops)
    q = tdi.query_lanes(fps, chks)
    np.testing.assert_array_equal(q[0], jdi._lane_hi(fps))
    np.testing.assert_array_equal(q[1], jdi._lane_lo(fps))
    np.testing.assert_array_equal(q[2:], np.stack(jdi._eq_lanes(chks)))
    assert tdi.fingerprint_batch([]).shape == (0,)


# --- the probe's lanes --------------------------------------------------------

def _lanes_of(keys, chks, amts, cap: int) -> np.ndarray:
    """(6, cap) int32 resident lanes of sorted keys, as the index lays
    them out, pads included."""
    n_live = len(keys)
    amt_u = amts.view(np.uint64)
    lanes = np.zeros((6, cap), dtype=np.int32)
    chk_a, chk_b = tdi._eq_lanes(chks)
    for r, lane in enumerate((
            tdi._lane_hi(keys), tdi._lane_lo(keys), chk_a, chk_b,
            (amt_u & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32),
            (amt_u >> np.uint64(32)).astype(np.uint32).view(np.int32))):
        lanes[r, :n_live] = lane
        lanes[r, n_live:] = tdi._PADS[r]
    return lanes


def _edge_queries(rng, qk, qc):
    """Append a query on the pads' high lane and one above every key."""
    qk = np.concatenate([qk, [HI | np.uint64(5), np.uint64(_U64)]])
    qc = np.concatenate([qc, rng.integers(0, 1 << 64, size=2,
                                          dtype=np.uint64)])
    return tdi.query_lanes(qk, qc)


def planted_lanes(rng, n_live: int, cap: int = 0):
    """(lanes (6, cap) int32, queries (4, q) int32) for ``n_live`` sorted
    random keys at capacity ``cap`` (the index's power of two by
    default), with the planted cases where ``n_live`` allows them."""
    cap = cap or tdi._pow2(n_live)
    keys = rng.integers(0, 1 << 64, size=n_live, dtype=np.uint64)
    if n_live >= 64:
        run_hi = keys[0] & HI
        keys[1:13] = run_hi | rng.integers(0, 1 << 32, size=12,
                                           dtype=np.uint64)
        keys[20] = keys[21] = keys[22]           # 64-bit twins
        keys[30] = HI | np.uint64(5)             # hi I32_MAX
    keys.sort()
    chks = rng.integers(0, 1 << 64, size=n_live, dtype=np.uint64)
    amts = rng.integers(0, 1 << 62, size=n_live, dtype=np.int64)
    lanes = _lanes_of(keys, chks, amts, cap)
    # queries: half present, a quarter equal on the high lane only, a
    # quarter absent; then every planted row and the I32_MAX high lane
    q = max(64, n_live)
    pick = rng.integers(0, max(n_live, 1), size=q)
    qk = rng.integers(0, 1 << 64, size=q, dtype=np.uint64)
    qc = rng.integers(0, 1 << 64, size=q, dtype=np.uint64)
    if n_live:
        half, quarter = q // 2, q // 4
        qk[:half], qc[:half] = keys[pick[:half]], chks[pick[:half]]
        same_hi = keys[pick[half:half + quarter]] & HI
        qk[half:half + quarter] = same_hi | rng.integers(
            0, 1 << 32, size=quarter, dtype=np.uint64)
        planted = [i for i in (0, 1, 5, 12, 20, 21, 22, 30) if i < n_live]
        qk = np.concatenate([qk, keys[planted]])
        qc = np.concatenate([qc, chks[planted]])
    return lanes, _edge_queries(rng, qk, qc)


def fence_lanes(rng, n_live: int, shift: int):
    """(lanes, queries) of ``n_live`` sorted keys where a run of equal
    high lanes 2.5 fence strides long (2^shift rows a stride) starts one
    row past a fence point and crosses the next ones, where ``n_live``
    allows it.  Queries: every fence point and the row before each (all
    present), every row of the run, the run's high lane with absent low
    lanes, a key below every key, random absent keys, and the edges."""
    stride = 1 << shift
    keys = np.sort(rng.integers(0, 1 << 64, size=n_live, dtype=np.uint64))
    run = []
    if n_live >= 3:
        start = min(stride + 1, n_live // 3)
        length = min(n_live - start, 2 * stride + stride // 2 + 1)
        run = list(range(start, start + length))
        keys[run] = (keys[start] & HI) | np.sort(rng.integers(
            0, 1 << 32, size=length, dtype=np.uint64))
        keys.sort()
    chks = rng.integers(0, 1 << 64, size=n_live, dtype=np.uint64)
    amts = rng.integers(0, 1 << 62, size=n_live, dtype=np.int64)
    lanes = _lanes_of(keys, chks, amts, tdi._pow2(n_live))
    points = list(range(0, n_live, stride))
    rows = sorted({*points, *(j - 1 for j in points if j), *run})
    qk = [keys[rows]]
    qc = [chks[rows]]
    if run:
        qk.append((keys[run[0]] & HI) | rng.integers(0, 1 << 32, size=4,
                                                     dtype=np.uint64))
        qc.append(rng.integers(0, 1 << 64, size=4, dtype=np.uint64))
    qk.append(np.array([0], dtype=np.uint64))
    qc.append(np.array([1], dtype=np.uint64))
    qk.append(rng.integers(0, 1 << 64, size=16, dtype=np.uint64))
    qc.append(rng.integers(0, 1 << 64, size=16, dtype=np.uint64))
    return lanes, _edge_queries(rng, np.concatenate(qk), np.concatenate(qc))


def _jax_probe(lanes, n_live, queries):
    out = jdi._probe_kernel(*lanes, np.int32(n_live), *queries,
                            window=jdi.PROBE_WINDOW)
    return [np.asarray(o) for o in out]


def _torch_lanes(lanes, queries, device="cpu"):
    return ([torch.from_numpy(np.ascontiguousarray(r)).to(device)
             for r in lanes],
            [torch.from_numpy(np.ascontiguousarray(r)).to(device)
             for r in queries])


@pytest.mark.parametrize("n_live", SIZES)
def test_probe_plain_matches_jax(n_live):
    rng = np.random.default_rng(RNG_SEED + n_live)
    lanes, queries = planted_lanes(rng, n_live)
    want = _jax_probe(lanes, n_live, queries)
    res, qs = _torch_lanes(lanes, queries)
    got = tdi.probe_plain(*res, n_live, *qs)
    for g, w, name in zip(got, want, ("hit", "key_hit", "overflow",
                                      "amt_lo", "amt_hi")):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    hit, key_hit, overflow = (w for w in want[:3])
    if n_live >= 64:
        # the mix reaches every kind of answer
        assert hit.any() and overflow.any() and (key_hit & ~hit).any()
        assert (~key_hit).any()


@pytest.mark.parametrize("n_live,shift", FENCE_CASES)
def test_probe_plain_matches_jax_on_fence_runs(n_live, shift):
    """The fence cases: a run of equal high lanes longer than the stride
    and crossing fence points, and queries at the fence points; the
    plain version equals JAX there as everywhere."""
    lanes, queries = fence_lanes(np.random.default_rng(RNG_SEED + shift),
                                 n_live, shift)
    want = _jax_probe(lanes, n_live, queries)
    res, qs = _torch_lanes(lanes, queries)
    for g, w in zip(tdi.probe_plain(*res, n_live, *qs), want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want[0].sum() >= len(range(0, n_live, 1 << shift))
    if n_live > 3 << shift:
        runs = np.unique(lanes[0, :n_live], return_counts=True)[1]
        assert runs.max() > 1 << shift   # a run longer than the stride


def test_probe_plain_matches_jax_at_full_capacity():
    """n_live == cap: no pad row, so a query above every key clips its
    row to cap - 1."""
    rng = np.random.default_rng(RNG_SEED)
    lanes, queries = planted_lanes(rng, 256, cap=256)
    want = _jax_probe(lanes, 256, queries)
    res, qs = _torch_lanes(lanes, queries)
    for g, w in zip(tdi.probe_plain(*res, 256, *qs), want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_probe_wrapper_checks_and_runs_plain_on_cpu():
    rng = np.random.default_rng(RNG_SEED)
    lanes, queries = planted_lanes(rng, 64)
    res, qs = _torch_lanes(lanes, queries)
    launches = tdi.PROBE_LAUNCHES
    for g, w in zip(tdi.probe(*res, 64, *qs), tdi.probe_plain(*res, 64, *qs)):
        assert torch.equal(g, w)
    assert tdi.PROBE_LAUNCHES == launches  # the CPU launches nothing
    with pytest.raises(ValueError):
        tdi.probe(*res[:5], res[5].long(), 64, *qs)
    with pytest.raises(ValueError):
        tdi.probe(*res, 64, qs[0][:-1], *qs[1:])
    with pytest.raises(ValueError):
        tdi.probe(*res, res[0].shape[0] + 1, *qs)
    with pytest.raises(ValueError):
        tdi.probe(*res, 64, *qs, window=0)


@pytest.mark.parametrize("n_live,shift", FENCE_CASES)
def test_probe_args_fence_block_and_one_buffer(n_live, shift):
    """ProbeArgs keeps every 2^shift-th live keys_hi as the fence and
    lays out the argument block the C side reads; ``launch`` on the CPU
    packs the plain version's results into the kernel's one buffer,
    which ``split_results`` and ``split_host`` read back."""
    lanes, queries = fence_lanes(np.random.default_rng(RNG_SEED), n_live,
                                 shift)
    res, qs = _torch_lanes(lanes, queries)
    args = tdi.ProbeArgs(res, n_live, shift)
    np.testing.assert_array_equal(args.fence.numpy(),
                                  lanes[0, :n_live:1 << shift])
    assert args.fence.shape[0] == -(-n_live >> shift) <= tdi.FENCE_MAX
    assert args.block[6:].tolist() == [
        args.fence.data_ptr(), n_live, lanes.shape[1], args.fence.shape[0],
        shift, 0]
    assert args.block[:6].tolist() == [t.data_ptr() for t in res]
    want = tdi.probe_plain(*res, n_live, *qs)
    q = queries.shape[1]
    out = tdi.launch(args, torch.from_numpy(queries))
    assert out.dtype == torch.uint8 and out.shape == (11 * q,)
    for g, h, w in zip(tdi.split_results(out, q),
                       tdi.split_host(out.numpy(), q), want):
        assert g.dtype == w.dtype and torch.equal(g, w)
        np.testing.assert_array_equal(h, w.numpy())
    for g, w in zip(tdi.probe(*res, n_live, *qs), want):
        assert torch.equal(g, w)


def test_fence_shift_and_the_argument_checks():
    assert [tdi.fence_shift(n) for n in (0, 1, tdi.FENCE_MAX,
                                         tdi.FENCE_MAX + 1, 1 << 24,
                                         (1 << 24) + 1)] == [0, 0, 0, 1, 11,
                                                             12]
    lanes = torch.zeros((6, tdi.FENCE_MAX + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        tdi.ProbeArgs(lanes, tdi.FENCE_MAX + 1, shift=0)
    args = tdi.ProbeArgs(lanes, tdi.FENCE_MAX + 1)
    assert args.shift == 1 and args.fence.shape[0] == tdi.FENCE_MAX // 2 + 1
    with pytest.raises(ValueError):
        tdi.ProbeArgs(lanes[:5], 3)
    with pytest.raises(ValueError):
        tdi.ProbeArgs(torch.zeros((6, 0), dtype=torch.int32), 0)
    q = torch.zeros((4, 3), dtype=torch.int32)
    for bad in (q.long(), q.t().contiguous().t(), q[:3]):
        with pytest.raises(ValueError):
            tdi.launch(args, bad)
    with pytest.raises(ValueError):
        tdi.launch(args, q, window=0)
    assert tdi.launch(args, q).shape == (33,)


def test_prepared_lanes_raise_when_changed_since_the_upload():
    """The index validates its lanes once an upload and probes through
    the prepared block after that; lanes that changed shape, device or
    pointer since then make the probe raise instead of reading through
    stale pointers, and the next upload prepares them afresh."""
    rng = np.random.default_rng(RNG_SEED)
    ops = _random_ops(rng, 40)
    idx = tdi.DeviceUtxoIndex(ops, device="cpu")
    assert idx.contains_batch(ops[:5]).all()
    lanes = idx._dev
    cap = lanes.shape[1]
    for changed in (torch.zeros((6, cap // 2), dtype=torch.int32),
                    torch.zeros((6, cap), dtype=torch.int32, device="meta"),
                    lanes.clone()):
        idx._dev = changed
        with pytest.raises(ValueError, match="changed since the upload"):
            idx.contains_batch(ops[:5])
    idx._dev = lanes
    assert idx.contains_batch(ops[:5]).all()
    idx._dev = lanes.clone()
    idx.add([_op(7)])                   # dirty: the upload prepares again
    assert idx.contains_batch(ops[:5] + [_op(7)]).all()


def test_probe_bytes_needed_counts_the_search_window_and_amounts():
    """One query on 8 keys at one sector a lane: its search reads
    keys_hi's one sector, its window (a match at the lower bound) the
    other three identity lanes' one each, its amounts two more: 6
    sectors, plus 27 bytes of query and results."""
    keys = torch.arange(8, dtype=torch.int32)
    assert tdi.probe_bytes_needed(keys, 8, torch.tensor([3],
                                                        dtype=torch.int32)) \
        == 6 * 32 + 27
    # an empty index: only the pad row's amounts
    assert tdi.probe_bytes_needed(torch.full((1,), I32_MAX,
                                             dtype=torch.int32), 0,
                                  torch.tensor([3], dtype=torch.int32)) \
        == 2 * 32 + 27


# --- the index under one update sequence --------------------------------------

def _answers(idx, universe):
    present, amounts = idx.lookup_batch(universe)
    return {"contains": idx.contains_batch(universe).tolist(),
            "maybe": idx.maybe_contains_batch(universe).tolist(),
            "present": present.tolist(), "amounts": amounts.tolist(),
            "shadow": idx.shadow_contains_batch(universe).tolist(),
            "missing": idx.missing(universe), "len": len(idx),
            "undo": idx.undo_depth(), "stats": idx.stats()}


def _run_sequence(make, universe, steps):
    idx = make()
    log = [_answers(idx, universe)]
    for step in steps:
        out = step(idx)
        log.append((out, _answers(idx, universe)))
    return log


def _steps(ops):
    vals = [(1000 + i, "addr%d" % (i % 3), 0) for i in range(len(ops))]
    return [
        lambda i: i.add(ops[40:60], vals[40:60]),
        lambda i: i.remove(ops[0:10] + [_op(10 ** 9)]),   # one absent
        lambda i: i.apply_block(ops[60:70], ops[10:20],
                                created_values=vals[60:70]),
        lambda i: i.apply_block(ops[70:72], ops[60:63] + ops[20:22]),
        lambda i: i.rollback_block(),
        lambda i: i.add(ops[0:3]),                        # re-add, no values
        lambda i: i.rollback_block(),
        lambda i: i.rollback_block(),                     # log exhausted
        lambda i: i.remove(ops[0:3] + ops[0:3]),  # each twice: one a no-op
    ]


def test_index_sequence_matches_jax():
    rng = np.random.default_rng(RNG_SEED)
    ops = _random_ops(rng, 80)
    universe = ops + [_op(10 ** 9), _op(10 ** 9, 1)]
    values = [(10 * i, "a", 0) for i in range(40)]
    got = _run_sequence(lambda: tdi.DeviceUtxoIndex(
        ops[:40], values=values, device="cpu"), universe, _steps(ops))
    want = _run_sequence(lambda: jdi.DeviceUtxoIndex(
        ops[:40], values=values), universe, _steps(ops))
    assert got == want
    assert [s[0] for s in got[1:]] == [None] * 4 + [True, None, True,
                                                     False, None]


def test_universal_collision_matches_jax(monkeypatch):
    """Every fingerprint equal: twins resolved by the shadow map, the
    survivor of a spent twin still present (tests/test_device_index.py:49)."""
    collide = lambda ops: np.full(len(ops), 42, dtype=np.uint64)  # noqa: E731
    monkeypatch.setattr(jdi, "fingerprint_batch", collide)
    monkeypatch.setattr(tdi, "fingerprint_batch", collide)
    universe = [_op(i) for i in range(1, 6)]
    steps = [lambda i: i.remove([_op(1)]), lambda i: i.add([_op(3)]),
             lambda i: i.remove([_op(2)]), lambda i: i.remove([_op(3)])]
    got = _run_sequence(lambda: tdi.DeviceUtxoIndex(
        [_op(1), _op(2)], device="cpu"), universe, steps)
    want = _run_sequence(lambda: jdi.DeviceUtxoIndex([_op(1), _op(2)]),
                         universe, steps)
    assert got == want
    assert got[1][1]["contains"][:2] == [False, True]
    assert got[-1][1]["len"] == 0 and got[-1][1]["stats"]["shadow_consults"]


def test_twin_pairs_at_block_scale_match_jax(monkeypatch):
    """8,192 entries in twin pairs (tests/test_device_index.py:104): every
    probe ambiguous and resolved exactly, a batched spend of one twin a
    pair, and the rollback."""
    pairs = lambda ops: np.array(  # noqa: E731
        [int(o[0], 16) >> 1 for o in ops], dtype=np.uint64)
    monkeypatch.setattr(jdi, "fingerprint_batch", pairs)
    monkeypatch.setattr(tdi, "fingerprint_batch", pairs)
    n = 8192
    ops = [_op(i) for i in range(n)]
    values = [(i + 1, 0, 4) for i in range(n)]
    spent = [_op(i) for i in range(0, n, 2)]
    created = [_op(i) for i in range(2 * n, 2 * n + n // 2)]
    universe = ops + created + [_op(i) for i in range(3 * n, 3 * n + 64)]

    def run(idx):
        out = [idx.stats()["twin_fingerprints"]]
        present, amounts = idx.lookup_batch(universe)
        out += [present.tolist(), amounts.tolist()]
        idx.apply_block(created, spent, created_values=[(7, 0, 5)] * len(
            created))
        present, amounts = idx.lookup_batch(universe)
        out += [present.tolist(), amounts.tolist(), idx.stats()]
        out.append(idx.rollback_block())
        out += [idx.contains_batch(universe).tolist(), len(idx), idx.stats()]
        return out

    got = run(tdi.DeviceUtxoIndex(ops, values=values, device="cpu"))
    want = run(jdi.DeviceUtxoIndex(ops, values=values))
    assert got == want
    assert got[0] == n // 2 and all(got[1][:n]) and not any(got[1][n:])
    assert got[-1]["shadow_consults"] >= 3 * n


def test_rollback_past_the_undo_depth_matches_jax():
    rng = np.random.default_rng(RNG_SEED)
    ops = _random_ops(rng, 2 * (tdi.DeviceUtxoIndex.UNDO_DEPTH + 3))
    assert tdi.DeviceUtxoIndex.UNDO_DEPTH == jdi.DeviceUtxoIndex.UNDO_DEPTH \
        == 64

    def run(idx):
        for k in range(0, len(ops) - 2, 2):
            idx.apply_block([ops[k + 2]], [ops[k]])
        depth = idx.undo_depth()
        undone = [idx.rollback_block() for _ in range(depth + 2)]
        return depth, undone, idx.contains_batch(ops).tolist(), idx.stats()

    got = run(tdi.DeviceUtxoIndex([ops[0]], device="cpu"))
    assert got == run(jdi.DeviceUtxoIndex([ops[0]]))
    assert got[0] == 64 and got[1] == [True] * 64 + [False, False]


def test_index_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdi.DeviceUtxoIndex([_op(1)])


# --- the kernel source under the host's compiler ------------------------------

# Device code as host C++: each block's threads run as threads, with
# their own blockIdx and threadIdx, __syncthreads a barrier of the block,
# and __shared__ one static buffer the block's threads share.
_SHIM = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>
typedef int cudaError_t;
typedef void* cudaStream_t;
#define __device__
#define __global__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(n) __attribute__((aligned(n)))
struct int4 { int x, y, z, w; };
struct dim3_ { unsigned x; };
inline thread_local dim3_ blockIdx, threadIdx;
inline dim3_ blockDim, gridDim;
inline std::barrier<>* g_block;
inline void __syncthreads() { g_block->arrive_and_wait(); }
"""

_MAIN = r"""
#include <cstdio>
#include <thread>
#include <vector>
#include "kernel.inc"
// argv[1]: cases of (cap, n_live, q, window, shift, n_fence, 6 * cap
// lanes, n_fence fence entries, 4 * q queries) int32 words; argv[2]: per
// case the 11 * q-byte output.  Each case runs as a grid of 3 blocks of 5
// threads, one block after another, so the grid-stride loop covers a
// ragged edge and each block loads the fence itself.
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  FILE* g = fopen(argv[2], "wb");
  int head[6];
  while (fread(head, 4, 6, f) == 6) {
    const int cap = head[0], n_live = head[1], q = head[2], window = head[3];
    std::vector<int> lanes((size_t)6 * cap), fence(head[5] + 4),
        qs((size_t)4 * q);
    if (fread(lanes.data(), 4, lanes.size(), f) != lanes.size()) return 1;
    if (fread(fence.data(), 4, head[5], f) != (size_t)head[5]) return 1;
    if (fread(qs.data(), 4, qs.size(), f) != qs.size()) return 1;
    const int* l = lanes.data();
    ProbeLanes r{l, l + cap, l + 2 * cap, l + 3 * cap, l + 4 * cap,
                 l + 5 * cap, fence.data(), n_live, cap, head[5], head[4]};
    std::vector<unsigned char> out((size_t)11 * q, 0xA5);
    gridDim.x = 3;
    blockDim.x = 5;
    for (unsigned b = 0; b < gridDim.x; ++b) {
      std::barrier<> block(blockDim.x);
      g_block = &block;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < blockDim.x; ++t)
        ts.emplace_back([&, b, t] {
          blockIdx.x = b;
          threadIdx.x = t;
          utxo_probe_kernel(r, qs.data(), q, window, out.data());
        });
      for (auto& t : ts) t.join();
    }
    fwrite(out.data(), 1, out.size(), g);
  }
  fclose(f);
  fclose(g);
  return 0;
}
"""

# each mutation a (source text, replacement) the kernel must be caught by
MUTATIONS = {
    None: None,
    "upper_bound": ("return key < h;", "return key <= h;"),
    "unsigned_compare": ("return key < h;",
                         "return (unsigned)key < (unsigned)h;"),
    "window_short": ("for (int k = 0; k < window; ++k) {",
                     "for (int k = 0; k < window - 1; ++k) {"),
    "fence_off_by_one_stride": ("const int seg = J - 1;",
                                "const int seg = J;"),
    "segment_short": ("const int len = end - pos;",
                      "const int len = end - pos - 1;"),
    "fence_tail_dropped": ("j < r.n_fence; j += blockDim.x)",
                           "j < 4 * n4; j += blockDim.x)"),
}


def _kernel_cases():
    """(n_live, shift, lanes, queries): the planted sizes at their own
    fence shift and at strides of 2, 8 and 64 rows, then the fence
    cases."""
    cases = []
    for n_live in SIZES:
        lanes, queries = planted_lanes(
            np.random.default_rng(RNG_SEED + n_live), n_live)
        for shift in sorted({tdi.fence_shift(n_live), 1, 3, 6}):
            cases.append((n_live, shift, lanes, queries))
    for n_live, shift in FENCE_CASES:
        cases.append((n_live, shift, *fence_lanes(
            np.random.default_rng(RNG_SEED + shift), n_live, shift)))
    return cases


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_kernel_source_matches_plain_under_host_compiler(tmp_path, mutation):
    """csrc/utxo_probe.cu, device code compiled as host C++ with each
    block's threads as threads, against the plain version on every
    planted size and fence case; each mutation must disagree."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    csrc = Path(tdi.__file__).parent.parent / "csrc"
    src = (csrc / "utxo_probe.cu").read_text()
    # the launch path is host code around CUDA's launch syntax; the kernel
    # is called directly
    src = src[:src.index("// --- the host side")]
    if mutation is not None:
        old, new = MUTATIONS[mutation]
        assert src.count(old) == 1
        src = src.replace(old, new)
    (tmp_path / "cuda_runtime.h").write_text(_SHIM)
    (tmp_path / "kernel.inc").write_text(src)
    (tmp_path / "main.cpp").write_text(_MAIN)
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I",
                    str(tmp_path), str(tmp_path / "main.cpp"), "-o",
                    str(tmp_path / "kernel")],
                   check=True, capture_output=True, timeout=300)
    cases = _kernel_cases()
    blob = []
    for n_live, shift, lanes, queries in cases:
        res, _qs = _torch_lanes(lanes, queries)
        fence = tdi.ProbeArgs(res, n_live, shift).fence.numpy()
        blob.append(np.array([lanes.shape[1], n_live, queries.shape[1],
                              tdi.PROBE_WINDOW, shift, fence.shape[0]],
                             dtype=np.int32).tobytes()
                    + lanes.tobytes() + fence.tobytes() + queries.tobytes())
    (tmp_path / "in.bin").write_bytes(b"".join(blob))
    subprocess.run([str(tmp_path / "kernel"), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True, timeout=300)
    raw = np.fromfile(tmp_path / "out.bin", dtype=np.uint8)
    equal, off = [], 0
    for n_live, shift, lanes, queries in cases:
        q = queries.shape[1]
        out = raw[off:off + 11 * q]
        off += 11 * q
        res, qs = _torch_lanes(lanes, queries)
        want = tdi.probe_plain(*res, n_live, *qs)
        equal.append(all(np.array_equal(g, w.numpy()) for g, w in zip(
            tdi.split_host(out, q), want)))
    assert off == raw.size
    if mutation is None:
        assert all(equal), equal
    else:
        assert not all(equal), f"the {mutation} mutation went unnoticed"


@pytest.mark.cuda
def test_probe_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card at every
    planted size, then on every case of the host-compiler test at its
    fence shift (runs on a machine with a card; skips elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n_live in SIZES:
        lanes, queries = planted_lanes(
            np.random.default_rng(RNG_SEED + n_live), n_live)
        res, qs = _torch_lanes(lanes, queries, "cuda")
        launches = tdi.PROBE_LAUNCHES
        got = tdi.probe(*res, n_live, *qs)
        assert tdi.PROBE_LAUNCHES == launches + 1
        want = tdi.probe_plain(*res, n_live, *qs)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
    for n_live, shift, lanes, queries in _kernel_cases():
        res, qs = _torch_lanes(lanes, queries, "cuda")
        got = tdi.split_results(tdi.launch(tdi.ProbeArgs(res, n_live, shift),
                                           torch.stack(qs)), qs[0].shape[0])
        for g, w in zip(got, tdi.probe_plain(*res, n_live, *qs)):
            assert torch.equal(g.cpu(), w.cpu())
