"""The port's native C++ host library (``upow_tpu_torch/native/``) against
the JAX package's (``upow_tpu/native/``), byte for byte, on the CPU.

Both libraries are built by g++ from their own copies of the source.
Inputs come from a numpy seed:

* ``sha256`` over every length from 0 to 300 bytes, against the JAX
  library and hashlib;
* ``pow_search`` against a brute force with hashlib and the
  reference's PoW rule, and against the JAX library, on integer and
  fractional difficulties, a miss, a hit at the range's first nonce and
  ranges at the top of the nonce space;
* ``p256_verify_batch`` against the JAX library and the pure-Python
  oracle, on valid, corrupted and hex-form signatures and on the range
  edges (r or s of 0, 1, n - 1, n, n + 1 and 2^256 - 1, an all-ones
  digest, a key off the curve);
* the miner: ``--device cpu`` selects the ``native`` backend, and
  ``engine.mine`` on it finds the JAX package's nonce;
* the host signature path: ``txverify``'s host batch is the native
  batch, and the pure-Python oracle where the library cannot be built
  (``native.unavailable`` counted).
"""

import hashlib
from decimal import Decimal

import numpy as np
import pytest

from upow_tpu import native as jnative
from upow_tpu.mine import engine as jengine
from upow_tpu.mine import miner as jminer
from upow_tpu.verify import txverify as jtxverify
from upow_tpu_torch import native, trace
from upow_tpu_torch.core import curve, point_to_string
from upow_tpu_torch.core.constants import CURVE_N, CURVE_P
from upow_tpu_torch.core.difficulty import check_pow_hash, pow_target
from upow_tpu_torch.mine import engine as tengine
from upow_tpu_torch.mine import miner as tminer
from upow_tpu_torch.verify import txverify

RNG_SEED = 0x7A71


def test_both_libraries_build():
    assert native.load() is not None and jnative.load() is not None
    assert native.LIB.name == "libupow_native.so"
    assert "_build" in native.LIB.parts


@pytest.mark.parametrize("lo", range(0, 301, 50))
def test_sha256_matches_jax_and_hashlib(lo):
    rng = np.random.default_rng(RNG_SEED + lo)
    for n in range(lo, min(lo + 50, 301)):
        msg = rng.bytes(n)
        got = native.sha256(msg)
        assert got == jnative.sha256(msg) == hashlib.sha256(msg).digest(), n


def _brute(prefix: bytes, prev: str, diff, start: int, count: int):
    for n in range(start, start + count):
        digest = hashlib.sha256(prefix + n.to_bytes(4, "little")).hexdigest()
        if check_pow_hash(digest, prev, Decimal(str(diff))):
            return n
    return None


# (difficulty, start, count): an integer and fractional difficulties, a
# miss at a hard one, the top of the nonce space
SEARCHES = [("1", 0, 4096), ("1.5", 100, 4096), ("2", 0, 20000),
            ("2.7", 7, 30000), ("9", 0, 5000),
            ("1", (1 << 32) - 3000, 3000)]


@pytest.mark.parametrize("diff, start, count", SEARCHES)
def test_pow_search_matches_brute_force_and_jax(diff, start, count):
    rng = np.random.default_rng(RNG_SEED)
    prefix = rng.bytes(104)
    prev = rng.bytes(32).hex()
    prefix_hex, _, charset = pow_target(prev, Decimal(diff))
    got = native.pow_search(prefix, prefix_hex, charset, start, count)
    assert got == jnative.pow_search(prefix, prefix_hex, charset, start,
                                     count)
    assert got == _brute(prefix, prev, diff, start, count)


def test_pow_search_hit_at_the_first_nonce():
    rng = np.random.default_rng(RNG_SEED + 1)
    prefix, prev = rng.bytes(104), rng.bytes(32).hex()
    prefix_hex, _, charset = pow_target(prev, Decimal("1"))
    first = _brute(prefix, prev, "1", 0, 4096)
    assert native.pow_search(prefix, prefix_hex, charset, first, 1) == first
    assert native.pow_search(prefix, prefix_hex, charset, first, 0) is None
    with pytest.raises(ValueError, match="nonce range"):
        native.pow_search(prefix, prefix_hex, charset, 1 << 32, 1)


def _signed(n: int, seed: int):
    rng = np.random.default_rng(seed)
    keys = [curve.keygen(rng=seed + i) for i in range(3)]
    out = []
    for i in range(n):
        d, pub = keys[i % 3]
        msg = rng.bytes(48)
        r, s = curve.sign(msg, d)
        out.append((hashlib.sha256(msg).digest(), (r, s), pub))
    return out


def _edge_cases():
    (digest, (r, s), pub), (d2, (r2, s2), pub2) = _signed(2, RNG_SEED + 9)
    edges = [0, 1, CURVE_N - 1, CURVE_N, CURVE_N + 1, (1 << 256) - 1]
    cases = [(digest, (e, s), pub) for e in edges]
    cases += [(digest, (r, e), pub) for e in edges]
    cases += [(b"\xff" * 32, (r, s), pub), (b"\x00" * 32, (r2, s2), pub2),
              (digest, (r, s), (pub[0], (pub[1] + 1) % CURVE_P)),
              (digest, (r, s), pub2), (d2, (r2, s2), pub2)]
    return cases


@pytest.mark.parametrize("kind", ["valid", "corrupted", "edges"])
def test_p256_batch_matches_jax_and_the_oracle(kind):
    cases = _signed(40, RNG_SEED + 3)
    if kind == "corrupted":
        cases = [(dg, (r, s + 1 if i % 2 else s), pub) if i % 3 else
                 (bytes([dg[0] ^ 1]) + dg[1:], (r, s), pub)
                 for i, (dg, (r, s), pub) in enumerate(cases)]
    elif kind == "edges":
        cases = _edge_cases()
    digests = [c[0] for c in cases]
    sigs = [c[1] for c in cases]
    pubs = [c[2] for c in cases]
    got = native.p256_verify_batch(digests, sigs, pubs)
    want = [jtxverify._host_verify_digest(*c) for c in cases]
    assert got == jnative.p256_verify_batch(digests, sigs, pubs) == want
    if kind == "valid":
        assert all(got)
    else:
        assert not all(got)
    for c, v in zip(cases, want):
        assert native.p256_verify(c[0], c[1][0], c[1][1], *c[2]) == v


def test_p256_batch_checks_its_arguments():
    (digest, sig, pub), = _signed(1, RNG_SEED + 4)
    assert native.p256_verify_batch([], [], []) == []
    with pytest.raises(ValueError, match="32 bytes"):
        native.p256_verify_batch([digest[:31]], [sig], [pub])
    with pytest.raises(ValueError, match="differ in length"):
        native.p256_verify_batch([digest], [sig, sig], [pub])


def test_host_signature_path_is_the_native_batch(monkeypatch):
    """``txverify``'s host path: the native batch where it loads (with
    the reference's hex-form retry), the oracle where it does not."""
    cases = _signed(12, RNG_SEED + 5)
    checks = [(dg, hashlib.sha256(b"other").digest(), sig, pub)
              for dg, sig, pub in cases]
    want = jtxverify.run_sig_checks(checks, backend="host", use_cache=False)
    calls = []
    real = native.p256_verify_batch

    def spy(*a):
        calls.append(len(a[0]))
        return real(*a)

    monkeypatch.setattr(native, "p256_verify_batch", spy)
    assert txverify.run_sig_checks(checks, backend="host",
                                   use_cache=False) == want
    assert calls == [12]
    monkeypatch.undo()

    # no g++: load() gives None once, counts it, and the oracle serves
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "LIB", native.BUILD / "missing" / "lib.so")
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    trace.reset()
    assert native.load() is None and native.sha256(b"x") is None
    assert trace.counters()["native.unavailable"] == 1
    assert txverify.run_sig_checks(checks, backend="host",
                                   use_cache=False) == want
    assert tminer.select_backend("cpu") == "torch"


def test_cpu_miner_is_native_and_finds_the_jax_nonce():
    assert tminer.select_backend("cpu") == "native"
    assert jminer.select_backend("cpu") == "native"
    rng = np.random.default_rng(RNG_SEED + 6)
    prev = rng.bytes(32).hex()
    addr = point_to_string(curve.keygen(rng=RNG_SEED)[1])
    fields = dict(previous_hash=prev, address=addr,
                  merkle_root=rng.bytes(32).hex(), timestamp=1_700_000_000,
                  difficulty=Decimal("2.5"))
    tjob = tengine.MiningJob.from_header_fields(**fields)
    jjob = jengine.MiningJob.from_header_fields(**fields)
    assert tjob.prefix == jjob.prefix
    kw = dict(start=50, stride_end=50 + 3 * 8192 + 11, batch=8192)
    got = tengine.mine(tjob, "native", **kw)
    want = jengine.mine(jjob, "native", **kw)
    plain = tengine.mine(tjob, "python", **kw)
    assert got.nonce == want.nonce == plain.nonce is not None
    assert got.hashes_tried == want.hashes_tried == plain.hashes_tried
    assert tjob.check(got.nonce)
