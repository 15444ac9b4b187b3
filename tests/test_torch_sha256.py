"""The port's nonce search against the JAX package's, and hashlib.

Inputs are made from a numpy seed and go through both packages:

* the host half (templates, targets, the packed target, the pure-Python
  compression) must be equal field for field;
* the plain PyTorch search (``pow_search_plain``, CPU) must return the
  same minimum hit nonce (or SENTINEL) as JAX ``pow_search_jnp``, as the
  Pallas kernel run in interpret mode where the batch is a multiple of
  its tile, and as a hashlib brute force;
* ragged counts and a range that ends at 2^32 - 1, which the Pallas path
  cannot run (it asserts ``batch % tile == 0``), against ``pow_search_jnp``;
* the plain hit test against JAX ``_hit_nonce_dynamic`` on the same
  digests;
* ``csrc/sha256_search.cu`` compiled by the host's g++ under a small
  shim, run as one thread per block, against the plain version;
* the CUDA kernel itself on a card (``cuda`` marker; skips here).
"""

import hashlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import upow_tpu.crypto.sha256 as jsha
from upow_tpu.core.difficulty import check_pow_hash
from upow_tpu_torch.core.difficulty import charset_count
from upow_tpu_torch.crypto import sha256 as tsha

SENTINEL = int(tsha.SENTINEL)
RNG = np.random.default_rng(0x5A256)
# (prefix length, difficulty, nonce base, count): v2 and v1 headers,
# integer and fractional charsets, a window off zero, a miss
PREFIXES = {104: RNG.bytes(104), 134: RNG.bytes(134)}
PREV = RNG.bytes(32).hex()
CASES = {
    "v2_int": (104, "1", 0, 4096),
    "v2_charset": (104, "1.3", 0, 4096),
    "v2_two_chars": (104, "2.7", 0, 4096),
    "v1_nonce_split": (134, "1", 0, 4096),
    "v1_charset": (134, "2.3", 0, 4096),
    "base_offset": (104, "1", 1 << 20, 4096),
    "miss": (104, "8", 0, 4096),
}


def _job(plen, diff):
    prefix = PREFIXES[plen]
    return prefix, tsha.make_template(prefix), \
        tsha.pack_target(tsha.target_spec(PREV, diff))


def _brute(prefix, diff, base, count, prev=PREV):
    for n in range(base, base + count):
        digest = hashlib.sha256(prefix + n.to_bytes(4, "little")).hexdigest()
        if check_pow_hash(digest, prev, diff):
            return n
    return SENTINEL


def _jnp(plen, diff, base, count, prev=PREV):
    prefix = PREFIXES[plen]
    return int(jsha.pow_search_jnp(jsha.make_template(prefix),
                                   jsha.target_spec(prev, diff),
                                   nonce_base=base, batch=count))


@pytest.mark.parametrize("size", [0, 55, 56, 64, 108, 138, 200])
def test_sha256_py_matches_jax_and_hashlib(size):
    msg = RNG.bytes(size)
    assert tsha.sha256_py(msg) == jsha.sha256_py(msg) == \
        hashlib.sha256(msg).digest()


@pytest.mark.parametrize("plen", [104, 134])
@pytest.mark.parametrize("diff", ["1", "1.3", "6", "6.3", "9.9", "16"])
def test_template_and_target_match_jax(plen, diff):
    prefix = PREFIXES[plen]
    got, want = tsha.make_template(prefix), jsha.make_template(prefix)
    assert np.array_equal(got.midstate, want.midstate)
    assert np.array_equal(got.tail_words, want.tail_words)
    assert got.midstate.dtype == got.tail_words.dtype == np.uint32
    assert got.nonce_spec == want.nonce_spec
    words = sorted({w for w, _s in got.nonce_spec})
    assert words == ([10] if plen == 104 else [1, 2])
    spec_t, spec_j = tsha.target_spec(PREV, diff), jsha.target_spec(PREV, diff)
    assert tuple(int(x) for x in spec_t) == tuple(int(x) for x in spec_j)
    assert np.array_equal(tsha.pack_target(spec_t), jsha.pack_target(spec_j))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jnp_and_bruteforce(case):
    plen, diff, base, count = CASES[case]
    prefix, template, target = _job(plen, diff)
    got = tsha.pow_search_plain(template, target, base, count)
    assert got.dtype == torch.int64 and got.shape == ()
    want = _jnp(plen, diff, base, count)
    assert int(got) == want == _brute(prefix, diff, base, count)
    assert (want == SENTINEL) == (case == "miss")
    # the wrapper takes the plain version for the CPU, and only there
    assert int(tsha.pow_search(template, target, base, count,
                               device="cpu")) == want


@pytest.mark.parametrize("diff", ["1", "1.4"])
def test_plain_matches_pallas_interpret(diff):
    # interpret mode runs per-op Python: two tiles of 1,024 lanes
    _prefix, template, target = _job(104, diff)
    want = int(jsha.pow_search_pallas(
        jsha.make_template(PREFIXES[104]), jsha.target_spec(PREV, diff),
        nonce_base=0, batch=2048, tile_rows=8, interpret=True))
    assert int(tsha.pow_search_plain(template, target, 0, 2048)) == want


@pytest.mark.parametrize("base,count", [
    (0, 1), (5, 127), (77, 1000),
    ((1 << 32) - 1 - 3000, 3000),   # ends exactly at 2^32 - 1
])
def test_ragged_counts_match_jnp(base, count):
    prefix, template, target = _job(134, "1.1")
    got = int(tsha.pow_search_plain(template, target, base, count))
    assert got == _jnp(134, "1.1", base, count)
    if got != SENTINEL:
        assert base <= got < base + count
        assert got == _brute(prefix, "1.1", base, got - base + 1)


def test_range_leaving_the_nonce_space_raises():
    _prefix, template, target = _job(104, "1")
    with pytest.raises(ValueError):
        tsha.pow_search_plain(template, target, (1 << 32) - 10, 11)
    with pytest.raises(ValueError):
        tsha.kernel_args(template, np.zeros(6, np.uint32), 0, 1)


def _digests(target, n, rng):
    """(3, n) uint32 digests, about half crafted to pass the prefix test
    with a random nibble, the rest random."""
    d = rng.integers(0, 1 << 32, size=(3, n), dtype=np.uint64).astype(np.uint32)
    craft = rng.random(n) < 0.5
    for k, (m, v) in enumerate(((target[0], target[1]),
                                (target[2], target[3]))):
        d[k, craft] = (d[k, craft] & ~m) | v
    return d


@pytest.mark.parametrize("diff", ["1", "1.3", "5.9", "8", "9.5", "12.1", "16"])
def test_hit_test_matches_hit_nonce_dynamic(diff):
    import jax.numpy as jnp

    rng = np.random.default_rng(int(float(diff) * 10))
    target = tsha.pack_target(tsha.target_spec(PREV, diff))
    n = 4096
    digest = _digests(target, n, rng)
    nonces = rng.permutation(1 << 20)[:n].astype(np.uint32)
    valid = rng.random(n) < 0.9
    for mask in (None, valid):
        want = int(jsha._hit_nonce_dynamic(
            [jnp.asarray(x) for x in digest], jnp.asarray(nonces),
            jnp.asarray(target), None if mask is None else jnp.asarray(mask)))
        got = int(tsha.hit_min_plain(
            [torch.from_numpy(x.astype(np.int64)) for x in digest],
            torch.from_numpy(nonces.astype(np.int64)), target,
            None if mask is None else torch.from_numpy(mask)))
        assert got == want
    assert want != SENTINEL  # the crafted lanes do hit


def test_ops_per_nonce_counts_from_the_nonce_word():
    v2 = tsha.make_template(PREFIXES[104])
    v1 = tsha.make_template(PREFIXES[134])
    # difficulty 10: prefix words 0 and 1, no nibble test
    words01 = tsha.pack_target(tsha.target_spec(PREV, "10"))
    alu, add = tsha.ops_per_nonce(v2, words01)
    # v2 by hand.  Rounds: 0-9 constant; 10 two adds (a and e are w10 plus
    # a constant); 11-13 thirteen (h constant); 14-63 fourteen, less round
    # 63's unread e.  Schedule words: 17 and 24 one add; 19, 21, 23 and
    # 27-31 five (s0 constant); 26, 33, 35 and 37 six; 25 nine; 32, 34, 36
    # and 38-63 ten.  One PRMT, two digest adds, two test terms of two.
    rounds = 2 + 3 * 13 + 50 * 14 - 1
    schedule = 2 * 1 + 8 * 5 + 4 * 6 + 9 + 29 * 10
    assert alu + add == rounds + schedule + 1 + 2 + 2 * 2 == 1112
    # SHF/LOP3 of the rounds from 11 (10 each) and of the schedule, the
    # PRMT, the test
    assert alu == 53 * 10 + (8 * 4 + 4 * 4 + 8 + 29 * 8) + 1 + 4 == 823
    # a nibble in digest word 2 adds its word's add and its test
    word2 = tsha.pack_target(tsha.target_spec(PREV, "16.5"))
    assert tsha.ops_per_nonce(v2, word2) == (alu + 2, add + 1)
    # v1: the nonce is in w1 and w2, so only round 0 is constant; still
    # less than every operation of the compression (14 a round, 10 a word)
    v1_alu, v1_add = tsha.ops_per_nonce(v1, words01)
    assert alu + add < v1_alu + v1_add < 64 * 14 + 48 * 10


# --- the kernel's fold and launch path ------------------------------------

def _tail_schedule(template, nonce=0):
    """The 64 message words of the tail block with ``nonce`` placed as
    ``pow_search_plain`` places it, as ``_compress_py`` expands them."""
    w = [int(x) for x in template.tail_words]
    for j, (widx, shift) in enumerate(template.nonce_spec):
        w[widx] |= ((nonce >> (8 * j)) & 0xFF) << shift
    for i in range(16, 64):
        s0 = tsha._rotr_py(w[i - 15], 7) ^ tsha._rotr_py(w[i - 15], 18) \
            ^ (w[i - 15] >> 3)
        s1 = tsha._rotr_py(w[i - 2], 17) ^ tsha._rotr_py(w[i - 2], 19) \
            ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & 0xFFFFFFFF)
    return w


def _kernel_schedule(template, path, reached, nonce):
    """The 64 message words as the kernel's ``path`` builds them: each
    word's folded constant part plus its nonce part, the nonce placed by
    one PRMT (the aligned path) or by ``nonce_shifts`` (the generic one),
    and a reached word's nonce part from the recurrence's reached terms."""
    word_c = tsha.fold_template(template, path)["word_c"]
    swapped = int.from_bytes(nonce.to_bytes(4, "little"), "big")
    if path == tsha.ALIGNED_PATH:
        v = [swapped if k == tsha.ALIGNED_WORD else 0 for k in range(16)]
    else:
        v = [((swapped << 32) >> shift) & 0xFFFFFFFF
             for shift in tsha.nonce_shifts(template)]
    w = [(c + x) & 0xFFFFFFFF for c, x in zip(word_c, v)]
    for j in range(16, 64):
        x = 0
        if j in reached:
            x = (v[j - 16] if j - 16 in reached else 0) \
                + (tsha._sigma0(w[j - 15]) if j - 15 in reached else 0) \
                + (v[j - 7] if j - 7 in reached else 0) \
                + (tsha._sigma1(w[j - 2]) if j - 2 in reached else 0)
        v.append(x & 0xFFFFFFFF)
        w.append((word_c[j] + x) & 0xFFFFFFFF)
    return w


def _rounds(state, w, n):
    """``n`` rounds of ``_compress_py`` from ``state`` over ``w``."""
    a, b, c, d, e, f, g, h = state
    for i in range(n):
        s1 = tsha._rotr_py(e, 6) ^ tsha._rotr_py(e, 11) ^ tsha._rotr_py(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + int(tsha._K[i]) + w[i]) & 0xFFFFFFFF
        s0 = tsha._rotr_py(a, 2) ^ tsha._rotr_py(a, 13) ^ tsha._rotr_py(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (t1 + s0 + maj) & 0xFFFFFFFF, a, b, c, \
            (d + t1) & 0xFFFFFFFF, e, f, g
    return [a, b, c, d, e, f, g, h]


@pytest.mark.parametrize("plen,path,first,nonce_words", [
    (104, 0, 10, {10}), (134, 1, 0, set(range(16)))])
def test_fold_equals_the_first_rounds_and_the_nonce_free_words(
        plen, path, first, nonce_words):
    """The v2 header takes the aligned path from word 10; the v1 header,
    whose nonce straddles words 1 and 2, the generic path from round 0,
    where every tail word may hold nonce bytes."""
    template = tsha.make_template(PREFIXES[plen])
    assert tsha.search_path(template) == path
    fold = tsha.fold_template(template, path)
    w = _tail_schedule(template)
    mid = [int(x) for x in template.midstate]
    # the state after the rounds before the first nonce word
    assert fold["state"] == _rounds(mid, w, first)
    # round ``first`` with the nonce 0: a and e are the folded ones
    after = _rounds(mid, w, first + 1)
    assert [after[0], after[4]] == [fold["round_a"] & 0xFFFFFFFF,
                                    fold["round_e"] & 0xFFFFFFFF]
    assert after[1:4] + after[5:] == fold["state"][:3] + fold["state"][4:7]
    # every message word the nonce does not reach is folded whole
    reached = set(nonce_words)
    for j in range(16, 64):
        if reached & {j - 16, j - 15, j - 7, j - 2}:
            reached.add(j)
    free = [j for j in range(64) if j not in reached]
    assert [fold["word_c"][j] for j in free] == [w[j] for j in free]
    # v2: words 0-9, 11-15, 16, 18, 20 and 22; the generic path: none
    assert len(free) == (19 if plen == 104 else 0)
    assert fold["mid"] == mid[:3]
    # and every word, constant part plus nonce part, is the plain one
    for nonce in (0, 1, 0x80, 0x1234_5678, 0xFFFF_FFFF):
        assert _kernel_schedule(template, path, reached, nonce) \
            == _tail_schedule(template, nonce)


def test_search_path_refuses_a_scattered_nonce():
    """Both paths take the nonce's four bytes in a row, least first, as
    every header holds them; a template that scatters them raises."""
    template = tsha.make_template(PREFIXES[104])
    spec = template.nonce_spec
    for bad in (spec[::-1], spec[:3] + ((12, 24),)):
        with pytest.raises(ValueError):
            tsha.search_path(template._replace(nonce_spec=bad))


def test_kernel_args_fold_once_for_equal_templates(monkeypatch):
    """The folded block is cached by the template's content and the
    target: an equal template built anew, as ``parallel.mesh`` builds one
    each round, folds nothing again; another target folds once more."""
    monkeypatch.setattr(tsha, "_BLOCKS", {})
    folds = []
    real = tsha.fold_template
    monkeypatch.setattr(tsha, "fold_template",
                        lambda *a: folds.append(a) or real(*a))
    _prefix, template, target = _job(104, "9.9")
    first = tsha.kernel_args(template, target, 0, 1 << 24)
    for base in (1 << 24, 2 << 24):
        again = tsha.SearchTemplate(
            np.array(template.midstate, dtype=np.uint32),
            np.array(template.tail_words, dtype=np.uint32),
            tuple((int(w), int(s)) for w, s in template.nonce_spec))
        block = tsha.kernel_args(again, target.copy(), base, 1 << 24)
        assert np.array_equal(block[:-2], first[:-2])
    assert len(folds) == 1
    tsha.kernel_args(template, tsha.pack_target(tsha.target_spec(PREV, "9")),
                     0, 1)
    assert len(folds) == 2


def test_kernel_args_differ_only_in_base_and_count():
    _prefix, template, target = _job(104, "9.9")
    one = tsha.kernel_args(template, target, 0, 1 << 24)
    two = tsha.kernel_args(template, target, 1 << 24, 12345)
    assert one.dtype == np.uint32 and one.size == tsha.ARG_WORDS
    assert np.flatnonzero(one != two).tolist() == [tsha.ARG_WORDS - 2,
                                                   tsha.ARG_WORDS - 1]
    assert two[-2:].tolist() == [1 << 24, 12345]
    one[:] = 0  # each call hands out a block of its own
    assert np.array_equal(tsha.kernel_args(template, target, 1 << 24, 12345),
                          two)
    # the tail must hold 0 under the nonce, as make_template leaves it
    bad = template._replace(tail_words=template.tail_words | np.uint32(1))
    with pytest.raises(ValueError):
        tsha.kernel_args(bad, target, 0, 1)


def test_launch_counts_follow_the_layout(monkeypatch):
    """pow_search's path and per-path counts, with the card's calls
    stubbed: one launch a call, on the path the layout picks."""
    launched = []

    class Lib:
        @staticmethod
        def sha256_search_launch(args, words, path, out, index, stream):
            launched.append((words, path))
            return 0

    monkeypatch.setattr(tsha, "resolve", lambda device: torch.device("meta"))
    monkeypatch.setattr(tsha, "_kernel_lib", lambda: Lib)
    monkeypatch.setattr(tsha, "current_index", lambda: -1)
    monkeypatch.setattr(tsha, "raw_stream", lambda index: 0)
    target = tsha.pack_target(tsha.target_spec(PREV, "9.9"))
    templates = {plen: tsha.make_template(PREFIXES[104][:plen] if plen < 104
                                          else PREFIXES[plen])
                 for plen in (104, 134, 100, 101)}
    for plen, path, aligned, generic in ((104, 0, 2, 0), (134, 1, 0, 2),
                                         (100, 1, 0, 2), (101, 1, 0, 2)):
        before = (tsha.LAUNCHES, tsha.ALIGNED_LAUNCHES, tsha.GENERIC_LAUNCHES)
        del launched[:]
        for base in (0, 1 << 24):
            tsha.pow_search(templates[plen], target, base, 1 << 24, device="cuda")
        assert launched == [(tsha.ARG_WORDS, path)] * 2
        assert (tsha.LAUNCHES, tsha.ALIGNED_LAUNCHES, tsha.GENERIC_LAUNCHES) \
            == (before[0] + 2, before[1] + aligned, before[2] + generic)


# --- the CUDA source under the host compiler -------------------------------

_SHIM = r"""
#pragma once
#include <cstdint>
#include <cstring>
typedef int cudaError_t;
typedef void* cudaStream_t;
#define __host__
#define __device__
#define __global__
#define __constant__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3_ { unsigned x; };
inline dim3_ blockIdx, threadIdx, blockDim, gridDim;
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31;
  return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
inline uint32_t __reduce_min_sync(uint32_t, uint32_t v) { return v; }
inline uint32_t atomicMin(uint32_t* p, uint32_t v) {
  uint32_t old = *p;
  if (v < old) *p = v;
  return old;
}
inline void __syncthreads() {}
"""

_MAIN = r"""
#include <cstdio>
#include <vector>
#include "kernel.inc"
// argv[1]: cases of a path index (kSearchPaths) and ARG_WORDS words each;
// argv[2]: one word per case.  Each case runs the path's kernel as a grid
// of 3 one-thread blocks, one after the other, so the grid-stride loop and
// the min across blocks are both exercised.
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<uint32_t> out;
  uint32_t path;
  SearchArgs a;
  while (fread(&path, 4, 1, f) == 1 && fread(&a, sizeof a, 1, f) == 1) {
    uint32_t best = 0xFFFFFFFFu;
    gridDim.x = 3;
    blockDim.x = 1;
    threadIdx.x = 0;
    for (unsigned b = 0; b < gridDim.x; ++b) {
      blockIdx.x = b;
      kSearchPaths[path](a, &best);
    }
    out.push_back(best);
  }
  fclose(f);
  FILE* g = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), g);
  fclose(g);
  return 0;
}
"""


def _kernel_cases():
    """(template, target, base, count) for the source and card tests."""
    return [case for case, _first in _labelled_cases()]


def _labelled_cases():
    """(case, whether the range's first lane is its answer, or None where
    the case is not built about its first lane): the plain-test cases,
    ragged counts, the 2^32 - 1 edge, a target made dense so the range's
    first lane is its minimum, the charset edge, and the two-word cases."""
    cases = []
    for plen, diff, base, count in CASES.values():
        _prefix, template, target = _job(plen, diff)
        cases.append(((template, target, base, count), None))
    _prefix, template, target = _job(134, "1.1")
    for base, count in ((0, 1), (9, 127), ((1 << 32) - 1 - 2000, 2000)):
        cases.append(((template, target, base, count), None))
    prefix, template, _target = _job(104, "1")
    base = 1 << 24
    first = hashlib.sha256(prefix + base.to_bytes(4, "little")).hexdigest()
    dense_prev = PREV[:-1] + first[0]
    cases.append(((template, tsha.pack_target(tsha.target_spec(dense_prev, "1")),
                   base, 3000), True))
    prev, diff, base = _charset_edge(prefix, 1 << 25)
    cases.append(((template, tsha.pack_target(tsha.target_spec(prev, diff)),
                   base, 3000), False))
    # prefixes of no header: the nonce word-aligned at word 9, and from
    # byte 1 of word 9 into word 10
    for plen, diff in ((100, "1"), (101, "1.3")):
        template = tsha.make_template(PREFIXES[104][:plen])
        cases.append(((template, tsha.pack_target(tsha.target_spec(PREV, diff)),
                       7, 3000), None))
    return cases + [(case, hits) for _name, case, hits in _two_word_cases()]


def _two_word_cases():
    """(name, case, whether the range's first lane hits): targets whose
    prefix reaches into digest word 1, each built from a chosen lane's
    digest as the dense case's is, so that the lane hits or misses at a
    chosen compare, on a v2 and a v1 template:

    * ``hit9``, ``hit10``: the lane hits at 9.1 and 10.1 (a nonzero
      word-1 mask, the nibble in word 1);
    * ``word1_miss``: the lane matches word 0 and the first char of
      word 1 at 10.1, and fails the second;
    * ``edge9``: the lane matches 9 chars and its nibble, in word 1,
      EQUALS the charset size;
    * ``hit16``, ``edge16``: the same with the nibble in word 2, at 16.x.
    """
    out = []
    for plen, base in ((104, 3 << 24), (134, 5 << 24)):
        prefix, template, _target = _job(plen, "1")
        for name, k in (("hit9", 9), ("hit10", 10), ("word1_miss", 10),
                        ("edge9", 9), ("hit16", 16), ("edge16", 16)):
            lane = base
            while True:
                h = hashlib.sha256(prefix + lane.to_bytes(4, "little")).hexdigest()
                nib = int(h[k], 16)
                if name.startswith("edge") and nib in FRAC_OF_CHARSET:
                    suffix, diff = h[:k], f"{k}{FRAC_OF_CHARSET[nib]}"
                    break
                if not name.startswith("edge") and nib < 15:
                    suffix, diff = h[:k], f"{k}.1"  # charset 15
                    if name == "word1_miss":
                        suffix = h[:k - 1] + f"{(int(h[k - 1], 16) + 1) % 16:x}"
                    break
                lane += 1
            target = tsha.pack_target(tsha.target_spec(PREV[:-k] + suffix, diff))
            out.append((f"v{2 if plen == 104 else 1}_{name}",
                        (template, target, lane, 3000), name.startswith("hit")))
    return out


def _check_first_lanes(answers):
    """Each labelled case's answer is its first lane exactly where the
    label says so."""
    for (case, first), answer in zip(_labelled_cases(), answers):
        if first is not None:
            assert (answer == case[2]) == first, (case[1], case[2], answer)


# charset size -> the fractional part of the difficulty that gives it
FRAC_OF_CHARSET = {charset_count(f"1.{d}"): f".{d}" for d in range(1, 10)}


def _charset_edge(prefix, base):
    """(previous hash, difficulty, base) where lane ``base`` matches the
    one-char prefix and its next nibble EQUALS the charset size, so it is
    no hit (the nibble must be below it)."""
    while True:
        h = hashlib.sha256(prefix + base.to_bytes(4, "little")).hexdigest()
        if int(h[1], 16) in FRAC_OF_CHARSET:
            return PREV[:-1] + h[0], "1" + FRAC_OF_CHARSET[int(h[1], 16)], base
        base += 1


def test_kernel_source_matches_plain_under_host_compiler(tmp_path):
    """csrc/sha256_search.cu, device code compiled as host C++, against
    the plain PyTorch version on every case."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    csrc = Path(tsha.__file__).parent.parent / "csrc"
    src = (csrc / "sha256_search.cu").read_text()
    # the launch wrapper is CUDA-only syntax; the kernel is called directly
    src = src[:src.index('extern "C" int sha256_search_launch')]
    (tmp_path / "cuda_runtime.h").write_text(_SHIM)
    shutil.copy(csrc / "sha256_common.cuh", tmp_path)
    (tmp_path / "kernel.inc").write_text(src)
    (tmp_path / "main.cpp").write_text(_MAIN)
    subprocess.run([gxx, "-std=c++17", "-O2", "-I", str(tmp_path),
                    str(tmp_path / "main.cpp"), "-o", str(tmp_path / "kernel")],
                   check=True, capture_output=True, timeout=300)
    cases = _kernel_cases()
    # each case on the path the launch wrapper would pick
    paths = [tsha.search_path(c[0]) for c in cases]
    blob = b"".join(np.uint32(p).tobytes() + tsha.kernel_args(*c).tobytes()
                    for p, c in zip(paths, cases))
    (tmp_path / "in.bin").write_bytes(blob)
    subprocess.run([str(tmp_path / "kernel"), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True, timeout=300)
    got = np.fromfile(tmp_path / "out.bin", dtype=np.uint32).tolist()
    want = [int(tsha.pow_search_plain(*c)) for c in cases]
    assert got == want
    _check_first_lanes(want)
    assert SENTINEL in want
    # both paths ran a case with a hit
    hit_paths = {p for p, w in zip(paths, want) if w != SENTINEL}
    assert hit_paths == {tsha.ALIGNED_PATH, tsha.GENERIC_PATH}


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on every case (runs on
    a machine with a card; skips elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    answers = []
    for template, target, base, count in _kernel_cases():
        launches = tsha.LAUNCHES
        got = tsha.pow_search(template, target, base, count, device="cuda")
        assert int(got) == int(tsha.pow_search_plain(template, target, base,
                                                     count))
        assert tsha.LAUNCHES == launches + 1
        answers.append(int(got))
    _check_first_lanes(answers)
