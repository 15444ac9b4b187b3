"""The port's batched digests (txids) against the JAX package's, and hashlib.

Inputs are made from a numpy seed and go through both packages:

* the padding and bucketing: the port's one-pass ``pack_bucket`` against
  the JAX package's per-row padding, and ``sha256_blocks_plain`` against
  JAX ``_sha256_blocks_jnp`` and hashlib at 1-8 blocks;
* ``sha256_batch(device="cpu")`` against JAX ``sha256_batch_jnp`` on mixed
  lengths with the padding edges (0, 55, 56, 63, 64, 119, 120 and 1,000
  bytes), digests in input order;
* ``txid_batch`` on its host, device (here the plain version) and auto
  backends with the ``min_batch`` gate, its integrity sample (a corrupted
  lane gives hashlib's digests and counts ``txid.sample_mismatch``), and a
  failing kernel entry, which raises instead of falling back;
* ``_fused_digest_prep`` with ``txid_backend`` device and host, against
  the JAX package's;
* the ragged batch: ``pack_ragged`` (one word buffer, a (block offset,
  n_blocks) table, longest first) and ``sha256_ragged_plain`` against
  JAX ``sha256_batch_jnp`` and hashlib on a seeded mix of 1- to
  154-block messages (a sync page's shapes: short txs, 21-block txs,
  one 154-block fan tx), in input order; ``_digest_array`` making one
  launch a batch whatever its lengths (``BLOCKS_LAUNCHES``, with the
  ragged entry point standing in for the card);
* ``csrc/sha256_blocks.cu`` compiled by the host's g++ under a small shim,
  run as one thread per block, against the plain version: each bucket
  with a uniform table, then the mixed lengths and the 1- to 154-block
  mix as one ragged launch each;
* the CUDA kernel itself on a card (``cuda`` marker; skips here).

The tolerance is exact: byte-equal digests.
"""

import hashlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import upow_tpu.core.tx as jtx
import upow_tpu.crypto.sha256 as jsha
import upow_tpu.verify.block as jblock
import upow_tpu_torch.core as tcore
import upow_tpu_torch.core.curve as tcurve
import upow_tpu_torch.core.tx as ttx
import upow_tpu_torch.verify.block as tblock
from test_torch_sha256 import _SHIM
from upow_tpu_torch import trace
from upow_tpu_torch.crypto import sha256 as tsha

RNG = np.random.default_rng(0x7D1D)
EDGES = [0, 1, 55, 56, 63, 64, 119, 120, 1000]


def _messages(lengths):
    return [RNG.bytes(int(n)) for n in lengths]


def _mixed():
    """The edge lengths and random ones up to 600 bytes, shuffled so the
    buckets interleave."""
    msgs = _messages(EDGES + RNG.integers(0, 600, size=120).tolist())
    order = RNG.permutation(len(msgs))
    return [msgs[i] for i in order]


def _ragged_mix():
    """A seeded mix shaped like a sync page: the padding edges and short
    txs of 1-4 blocks, three 21-block txs and one 154-block fan tx,
    shuffled so the longest is not first in input order."""
    rng = np.random.default_rng(0x7D1E)
    lengths = ([0, 1, 55, 56, 63, 64, 119, 120]
               + rng.integers(0, 4 * 64 - 9, size=48).tolist()
               + [1286, 1290, 1300, 9800])
    msgs = [rng.bytes(int(n)) for n in lengths]
    return [msgs[i] for i in rng.permutation(len(msgs))]


def _jax_padded_rows(msgs, n_blocks):
    """The JAX package's per-row padding (sha256_batch_jnp)."""
    rows = np.zeros((len(msgs), n_blocks * 16), dtype=np.uint32)
    for r, m in enumerate(msgs):
        padded = (m + b"\x80" + b"\x00" * ((55 - len(m)) % 64)
                  + (8 * len(m)).to_bytes(8, "big"))
        rows[r] = np.frombuffer(padded, dtype=">u4").astype(np.uint32)
    return rows


@pytest.mark.parametrize("n_blocks", range(1, 9))
def test_blocks_plain_matches_jax_and_hashlib(n_blocks):
    lo, hi = 64 * (n_blocks - 1) - 8, 64 * n_blocks - 9
    lengths = sorted({max(lo, 0), hi, *RNG.integers(max(lo, 0), hi + 1,
                                                    size=5).tolist()})
    msgs = _messages(lengths)
    assert {tsha.n_blocks_of(len(m)) for m in msgs} == {n_blocks}
    words = tsha.pack_bucket(msgs, n_blocks)
    np.testing.assert_array_equal(words, _jax_padded_rows(msgs, n_blocks))
    got = tsha.sha256_blocks_plain(torch.from_numpy(words.view(np.int32)),
                                   n_blocks)
    assert got.dtype == torch.int32 and got.shape == (len(msgs), 8)
    got = got.numpy().view(np.uint32)
    want = np.asarray(jsha._sha256_blocks_jnp(words, n_blocks))
    np.testing.assert_array_equal(got, want)
    for row, m in zip(got, msgs):
        assert row.astype(">u4").tobytes() == hashlib.sha256(m).digest()
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    launches = tsha.BLOCKS_LAUNCHES
    np.testing.assert_array_equal(
        tsha.sha256_blocks(words, n_blocks, device="cpu").numpy()
        .view(np.uint32), want)
    assert tsha.BLOCKS_LAUNCHES == launches


def test_blocks_reject_bad_shapes():
    with pytest.raises(ValueError):
        tsha.sha256_blocks_plain(torch.zeros((2, 17), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        tsha.pack_bucket([b"x" * 56], 1)  # needs two blocks
    empty = tsha.sha256_blocks_plain(torch.zeros((0, 32), dtype=torch.int32),
                                     2)
    assert empty.shape == (0, 8)


def test_sha256_batch_matches_jax_in_input_order():
    msgs = _mixed()
    got = tsha.sha256_batch(msgs, device="cpu")
    assert got == jsha.sha256_batch_jnp(msgs)
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    assert tsha.sha256_batch([], device="cpu") == []


def test_ragged_plain_matches_jax_and_hashlib():
    """One ragged batch of 1- to 154-block messages: the buffer holds
    each message's JAX padding at its table row's offset, longest first,
    and the plain version's digests, put back in input order, equal
    JAX ``sha256_batch_jnp``'s and hashlib's."""
    msgs = _ragged_mix()
    words, table, order = tsha.pack_ragged(msgs)
    counts = tsha.n_blocks_of(np.array([len(m) for m in msgs]))
    assert sorted({int(c) for c in counts}) == [1, 2, 3, 4, 21, 154]
    assert sorted(order.tolist()) == list(range(len(msgs)))
    assert table[:, 1].tolist() == sorted(counts.tolist(), reverse=True)
    assert table[0, 1] == 154 and table[:, 0].tolist() == (
        np.cumsum(table[:, 1]) - table[:, 1]).tolist()
    assert words.size == 16 * int(table[:, 1].sum())
    for (off, nb), i in zip(table.tolist(), order.tolist()):
        np.testing.assert_array_equal(words[16 * off:16 * (off + nb)],
                                      _jax_padded_rows([msgs[i]], nb)[0])
    got = tsha.sha256_ragged_plain(torch.from_numpy(words.view(np.int32)),
                                   torch.from_numpy(table))
    assert got.dtype == torch.int32 and got.shape == (len(msgs), 8)
    in_order = np.empty((len(msgs), 8), dtype=np.uint32)
    in_order[order] = got.numpy().view(np.uint32)
    digests = [row.astype(">u4").tobytes() for row in in_order]
    assert digests == [hashlib.sha256(m).digest() for m in msgs]
    assert digests == jsha.sha256_batch_jnp(msgs)
    # the wrapper on the CPU is the plain version and launches nothing
    launches = tsha.BLOCKS_LAUNCHES
    assert torch.equal(tsha.sha256_ragged(words, table, "cpu"), got)
    assert tsha.BLOCKS_LAUNCHES == launches


def test_ragged_table_is_checked():
    words = np.zeros(3 * 16, dtype=np.uint32)
    for bad in ([[0, 0]], [[-1, 1]], [[2, 2]], [[0, 1, 0]]):
        with pytest.raises(ValueError):
            tsha.sha256_ragged(words, np.array(bad, dtype=np.int32), "cpu")
    ok = np.array([[0, 3], [1, 1]], dtype=np.int32)
    assert tsha.sha256_ragged(words, ok, "cpu").shape == (2, 8)
    empty = tsha.pack_ragged([])
    assert empty[0].size == 0 and empty[1].shape == (0, 2)
    assert tsha.sha256_ragged(*empty[:2], "cpu").shape == (0, 8)


def test_digest_array_makes_one_launch_a_batch(monkeypatch):
    """``_digest_array`` hands each batch to the ragged entry point once,
    whatever its lengths: one bucket, many, the 1- to 154-block mix,
    through ``sha256_batch`` and ``txid_batch``.  The entry point is
    replaced by one that counts a launch where the card's does (a batch
    with rows) and runs the plain version."""
    calls = []

    def one_launch(words, table, device=None):
        calls.append(table.shape[0])
        if table.shape[0]:
            with tsha._COUNT_LOCK:
                tsha.BLOCKS_LAUNCHES += 1
        return tsha.sha256_ragged_plain(
            torch.from_numpy(words.view(np.int32)), torch.from_numpy(table))

    monkeypatch.setattr(tsha, "sha256_ragged", one_launch)
    batches = [_messages([100] * 5), _mixed(), _ragged_mix(),
               _messages([9800])]
    for msgs in batches:
        launches = tsha.BLOCKS_LAUNCHES
        assert tsha.sha256_batch(msgs, device="cpu") == \
            [hashlib.sha256(m).digest() for m in msgs]
        assert tsha.BLOCKS_LAUNCHES == launches + 1
        assert tsha.txid_batch(msgs, backend="device", min_batch=1,
                               device="cpu") == \
            [hashlib.sha256(m).hexdigest() for m in msgs]
        assert tsha.BLOCKS_LAUNCHES == launches + 2
    assert calls == [len(m) for m in batches for _ in range(2)]
    assert tsha.sha256_batch([], device="cpu") == []


@pytest.mark.parametrize("backend", ["host", "device", "auto"])
def test_txid_batch_backends_and_gate(monkeypatch, backend):
    """Every backend returns hashlib's hex digests.  ``device`` runs the
    plain version (a CPU device) once per batch, whatever its buckets;
    ``auto`` and ``host`` never do on the CPU, and below ``min_batch``
    nothing does."""
    msgs = _mixed()
    calls = []
    real = tsha.sha256_ragged_plain

    def spy(words, table):
        calls.append(int(table.shape[0]))
        return real(words, table)

    monkeypatch.setattr(tsha, "sha256_ragged_plain", spy)
    # auto takes hashlib on the CPU even at a batch its rule sends to a card
    monkeypatch.setattr(tsha, "TXID_AUTO_DEVICE_MIN", 1)
    want = [hashlib.sha256(m).hexdigest() for m in msgs]
    jwant = jsha.txid_batch(msgs, backend="host")
    assert want == jwant
    got = tsha.txid_batch(msgs, backend=backend, min_batch=16, device="cpu")
    assert got == want
    assert len({tsha.n_blocks_of(len(m)) for m in msgs}) >= 8
    if backend == "device":
        assert calls == [len(msgs)]
    else:
        assert calls == []
    calls.clear()
    assert tsha.txid_batch(msgs[:15], backend=backend, min_batch=16,
                           device="cpu") == want[:15]
    assert calls == []
    with pytest.raises(ValueError):
        tsha.txid_batch(msgs, backend="tpu", min_batch=1, device="cpu")


def test_auto_crossover_answers_host_on_the_cpu():
    """``auto`` is a size rule, the same answer in every process: the
    card from TXID_AUTO_DEVICE_MIN payloads, hashlib below it and on the
    CPU at any size."""
    cut = tsha.TXID_AUTO_DEVICE_MIN
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert tsha.txid_auto_backend(cut - 1, card) == "host"
    assert tsha.txid_auto_backend(cut, card) == "device"
    assert tsha.txid_auto_backend(10 * cut, card) == "device"
    assert tsha.txid_auto_backend(10 * cut, cpu) == "host"
    msgs = _messages([100] * 4)
    assert tsha.txid_batch(msgs * (cut // 4), backend="auto", min_batch=1,
                           device="cpu") == \
        [hashlib.sha256(m).hexdigest() for m in msgs] * (cut // 4)


def test_txid_integrity_sample_falls_back(monkeypatch):
    """A device batch with one wrong digest is discarded whole (JAX
    ``tests/test_crypto_sha256.py``'s case): hashlib's digests come back
    and ``txid.sample_mismatch`` counts it."""
    msgs = _messages([100] * 6)
    real = tsha._digest_array

    def corrupt(messages, device=None):
        out = real(messages, device)
        out[0] = 0
        return out

    monkeypatch.setattr(tsha, "_digest_array", corrupt)
    trace.reset()
    got = tsha.txid_batch(msgs, backend="device", min_batch=1, device="cpu")
    assert got == [hashlib.sha256(m).hexdigest() for m in msgs]
    assert trace.counters()["txid.sample_mismatch"] == 1
    # the JAX package's sample makes the same call on the same fault
    monkeypatch.setattr(jsha, "sha256_batch_jnp", lambda ms: [
        b"\x00" * 32] + [hashlib.sha256(m).digest() for m in ms[1:]])
    assert jsha.txid_batch(msgs, backend="device", min_batch=1) == got


def test_failing_kernel_raises_instead_of_falling_back(monkeypatch):
    """No fallback: a kernel that fails to build or launch raises out of
    txid_batch and the digest prep, where the JAX package hashes on the
    host."""
    def broken(words, table, device=None):
        raise RuntimeError("sha256_blocks launch failed: CUDA error 700")

    monkeypatch.setattr(tsha, "sha256_ragged", broken)
    msgs = _mixed()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tsha.txid_batch(msgs, backend="device", min_batch=1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tblock._fused_digest_prep(_txs(ttx, 4), "device", 1, "cpu")
    # the host backend never reaches the kernel
    assert tsha.txid_batch(msgs, backend="host") == \
        [hashlib.sha256(m).hexdigest() for m in msgs]


def _txs(pkg_tx, n):
    """``n`` signed one-input txs (the port's keys and codecs), decoded
    by ``pkg_tx``'s ``tx_from_hex``: the same wire bytes in either
    package."""
    d, pub = tcurve.keygen(rng=0x71D)
    addr = tcore.point_to_string(pub)
    rng = np.random.default_rng(0x71D)
    out = []
    for k in range(n):
        tx = ttx.Tx([ttx.TxInput(rng.bytes(32).hex(), k % 3)],
                    [ttx.TxOutput(addr, 1000 + k)] * (1 + k % 4))
        tx.sign([d], lambda _i: pub)
        out.append(pkg_tx.tx_from_hex(tx.hex(), check_signatures=False))
    return out


@pytest.mark.parametrize("backend", ["device", "host"])
def test_fused_digest_prep_matches_jax(backend):
    """The digest pairs and the txid seeds equal the JAX package's
    ``_fused_digest_prep`` (hashlib there), with the port's batch on its
    device backend (the plain version) and on hashlib."""
    tports, tjax = _txs(ttx, 120), _txs(jtx, 120)
    tports[3].hash()  # a memo already set: no txid payload for it
    tjax[3].hash()
    got = tblock._fused_digest_prep(tports, backend, 256, "cpu")
    want = jblock._fused_digest_prep(tjax, "host", 256)
    assert [got[id(t)] for t in tports] == [want[id(t)] for t in tjax]
    assert [t._hash for t in tports] == [t._hash for t in tjax]
    assert all(t._hash == hashlib.sha256(bytes.fromhex(t.hex())).hexdigest()
               for t in tports)


_MAIN = r"""
#include <cstdio>
#include <vector>
#include "kernel.inc"
// argv[1]: per case, (rows, uniform_blocks, n_words) as three words, then
// n_words message words, then, when uniform_blocks is 0, rows (block
// offset, n_blocks) pairs; argv[2]: per case, rows * 8 digest words.
// Each case runs as a grid of 3 one-thread blocks, one after the other,
// so the grid-stride loop covers every row.
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  FILE* g = fopen(argv[2], "wb");
  uint32_t head[3];
  while (fread(head, 4, 3, f) == 3) {
    const int rows = (int)head[0], uniform = (int)head[1];
    std::vector<uint4> words(head[2] / 4);
    std::vector<int2> table(uniform ? 0 : rows);
    std::vector<uint4> out((size_t)rows * 2);
    if (fread(words.data(), 16, words.size(), f) != words.size()) return 1;
    if (fread(table.data(), 8, table.size(), f) != table.size()) return 1;
    gridDim.x = 3;
    blockDim.x = 1;
    threadIdx.x = 0;
    for (unsigned b = 0; b < gridDim.x; ++b) {
      blockIdx.x = b;
      sha256_blocks_kernel(words.data(), uniform ? nullptr : table.data(),
                           uniform, out.data(), rows);
    }
    fwrite(out.data(), 16, out.size(), g);
  }
  fclose(f);
  fclose(g);
  return 0;
}
"""

_VECTOR_SHIM = r"""
#define __restrict__
struct uint4 { uint32_t x, y, z, w; };
struct int2 { int x, y; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return uint4{x, y, z, w};
}
"""


def test_kernel_source_matches_plain_under_host_compiler(tmp_path):
    """csrc/sha256_blocks.cu, device code compiled as host C++, against
    the plain PyTorch version: every bucket of the mixed lengths with a
    uniform table, then the mixed lengths and the 1- to 154-block mix
    as one ragged launch each."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    csrc = Path(tsha.__file__).parent.parent / "csrc"
    src = (csrc / "sha256_blocks.cu").read_text()
    # the launch path is host code around CUDA's launch syntax; the kernel
    # is called directly
    src = src[:src.index("// --- the host side")]
    (tmp_path / "cuda_runtime.h").write_text(_SHIM + _VECTOR_SHIM)
    shutil.copy(csrc / "sha256_common.cuh", tmp_path)
    (tmp_path / "kernel.inc").write_text(src)
    (tmp_path / "main.cpp").write_text(_MAIN)
    subprocess.run([gxx, "-std=c++17", "-O2", "-I", str(tmp_path),
                    str(tmp_path / "main.cpp"), "-o", str(tmp_path / "kernel")],
                   check=True, capture_output=True, timeout=300)
    msgs = _mixed()
    cases = []   # (rows, uniform blocks, words, table or None)
    for n_blocks in sorted({tsha.n_blocks_of(len(m)) for m in msgs}):
        bucket = [m for m in msgs if tsha.n_blocks_of(len(m)) == n_blocks]
        words = tsha.pack_bucket(bucket, n_blocks)
        cases.append((words.shape[0], n_blocks, words.ravel(), None))
    for batch in (msgs, _ragged_mix()):
        words, table, _order = tsha.pack_ragged(batch)
        cases.append((table.shape[0], 0, words, table))
    blob = b"".join(np.array([rows, nb, words.size], dtype=np.uint32)
                    .tobytes() + words.tobytes()
                    + (b"" if table is None else table.tobytes())
                    for rows, nb, words, table in cases)
    (tmp_path / "in.bin").write_bytes(blob)
    subprocess.run([str(tmp_path / "kernel"), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True, timeout=300)
    got = np.fromfile(tmp_path / "out.bin", dtype=np.uint32)
    want = []
    for rows, nb, words, table in cases:
        w = torch.from_numpy(words.view(np.int32))
        plain = tsha.sha256_blocks_plain(w.view(rows, nb * 16), nb) \
            if table is None else \
            tsha.sha256_ragged_plain(w, torch.from_numpy(table))
        want.append(plain.numpy().view(np.uint32).ravel())
    np.testing.assert_array_equal(got, np.concatenate(want))
    assert len(cases) >= 10  # every bucket from 1 to 16 blocks that occurs
    assert cases[-1][3][0, 1] == 154   # the fan tx first in its launch


@pytest.mark.cuda
def test_blocks_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version and hashlib on every
    bucket, then one ragged launch of the mixed lengths and of the 1- to
    154-block mix (runs on a machine with a card; skips elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    msgs = _mixed()
    for n_blocks in sorted({tsha.n_blocks_of(len(m)) for m in msgs}):
        bucket = [m for m in msgs if tsha.n_blocks_of(len(m)) == n_blocks]
        words = tsha.pack_bucket(bucket, n_blocks)
        launches = tsha.BLOCKS_LAUNCHES
        got = tsha.sha256_blocks(words, n_blocks, device="cuda")
        assert tsha.BLOCKS_LAUNCHES == launches + 1
        plain = tsha.sha256_blocks_plain(
            torch.from_numpy(words.view(np.int32)), n_blocks)
        assert torch.equal(got.cpu(), plain)
    for batch in (msgs, _ragged_mix()):
        words, table, _order = tsha.pack_ragged(batch)
        launches = tsha.BLOCKS_LAUNCHES
        got = tsha.sha256_ragged(words, table, "cuda")
        assert tsha.BLOCKS_LAUNCHES == launches + 1
        assert torch.equal(got.cpu(), tsha.sha256_ragged_plain(
            torch.from_numpy(words.view(np.int32)), torch.from_numpy(table)))
        assert tsha.sha256_batch(batch, device="cuda") == \
            [hashlib.sha256(m).digest() for m in batch]
        assert tsha.BLOCKS_LAUNCHES == launches + 2
