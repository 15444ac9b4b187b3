"""The port's mempool (``upow_tpu_torch.mempool``) against the JAX
package's, driven by one seeded sequence.

Entries are synthetic (random hex bodies, fees and outpoints, some
spending other pooled entries), so the sequence reaches every branch:
adds, duplicates, outpoint conflicts (first writer wins), removals, TTL
expiry on a fake monotonic clock, byte-cap eviction, and the
reference-exact selection and dependency-aware template.  After
every step both pools must hold the same entries in the same priority
order and answer the same selections; TTLSet must agree on every
membership test.
"""

import random
import time

import pytest

from upow_tpu import mempool as jmempool
from upow_tpu_torch import mempool as tmempool


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "monotonic", c)
    return c


def _entries(rng, n):
    """(tx_hash, tx_hex, fees, outpoints) tuples; a fifth of them spend an
    earlier entry's output, a few reuse another's outpoint."""
    out = []
    for i in range(n):
        h = "%064x" % rng.getrandbits(256)
        body = "%x" % rng.getrandbits(4 * rng.randrange(40, 400))
        fees = rng.choice([0, 1, 7, rng.randrange(0, 5000)])
        ops = [("%064x" % rng.getrandbits(256), rng.randrange(4))
               for _ in range(rng.randrange(1, 3))]
        if out and rng.random() < 0.2:
            ops.append((rng.choice(out)[0], 0))
        if out and rng.random() < 0.1:
            ops.append(rng.choice(rng.choice(out)[3]))
        out.append((h, body, fees, tuple(ops)))
    return out


def _state(pool, pkg):
    return ([(e.tx_hash, e.fees) for e in pool.ordered()], len(pool),
            pool.total_bytes_hex, pool.generation,
            pool.select_hex(3000),
            [e.tx_hash for e in pkg.select_reference(pool.ordered(), 3000)],
            [e.tx_hash for e in pkg.assemble_template(pool.ordered(), 3000)])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pool_sequence_matches_jax(clock, seed):
    rng = random.Random(seed)
    entries = _entries(rng, 60)
    pools = {pkg: pkg.Mempool(max_bytes_hex=9000, tx_ttl=50.0)
             for pkg in (jmempool, tmempool)}
    steps = 0
    for i, (h, body, fees, ops) in enumerate(entries):
        clock.t += rng.choice([0.5, 3.0, 11.0])
        results = []
        for pkg, pool in pools.items():
            r = pool.add(pkg.MempoolEntry(tx_hash=h, tx_hex=body, fees=fees,
                                          outpoints=ops))
            # a duplicate add answers like the first time's pool
            results.append((r, pool.add(pkg.MempoolEntry(
                tx_hash=h, tx_hex=body, fees=fees, outpoints=ops))))
            if i % 7 == 3:
                pool.remove([entries[i - 2][0], "00" * 32])
            if i % 11 == 5:
                results.append(pool.expire())
            if i % 5 == 4:
                results.append(pool.evict_over_cap())
            results.append(pool.spender_of(ops[0]))
        half = len(results) // 2
        assert results[:half] == results[half:]
        assert _state(pools[tmempool], tmempool) == \
            _state(pools[jmempool], jmempool)
        steps += 1
    assert steps == 60 and len(pools[tmempool]) > 0
    for pool in pools.values():
        pool.clear()
    assert _state(pools[tmempool], tmempool) == \
        _state(pools[jmempool], jmempool)


def test_template_defers_children_like_jax():
    """A child listed before its parent waits for it; a child whose parent
    misses the cut is dropped; the cap breaks at the first overflow."""
    rng = random.Random(9)
    for trial in range(20):
        raw = _entries(rng, 25)
        cap = rng.randrange(1500, 6000)
        got = {}
        for pkg in (jmempool, tmempool):
            pool = pkg.Mempool()
            for h, body, fees, ops in raw:
                pool.add(pkg.MempoolEntry(tx_hash=h, tx_hex=body, fees=fees,
                                          outpoints=ops))
            got[pkg] = ([e.tx_hash for e in pkg.assemble_template(
                pool.ordered(), cap)], [e.tx_hash for e in pkg.select_reference(
                    pool.ordered(), cap)])
        assert got[tmempool] == got[jmempool], trial


def test_ttl_set_matches_jax(clock):
    rng = random.Random(5)
    sets = {pkg: pkg.TTLSet(maxlen=16, ttl=30.0)
            for pkg in (jmempool, tmempool)}
    keys = ["k%d" % i for i in range(40)]
    for _ in range(400):
        clock.t += rng.choice([0.1, 1.0, 7.0])
        key = rng.choice(keys)
        add = rng.random() < 0.5
        answers = []
        for s in sets.values():
            if add:
                s.append(key)
            answers.append((key in s, len(s)))
        assert answers[0] == answers[1]
