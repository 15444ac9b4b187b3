"""SHA-256 on the card: the proof-of-work search and batched digests.

The uPow header puts the 4-byte nonce at the very end (core/header.py), so
a mining template factors as

    sha256(header) = compress(tail_block(nonce), midstate(prefix_blocks))

where ``midstate`` covers every complete 64-byte block of the prefix (host,
once per template) and only ONE compression runs per nonce on the card.

The host half (the constants, the pure-Python compression, templates and
targets) is a copy of the JAX package's ``crypto/sha256.py``: it fixes the
wire format.  The search is new:

* :func:`pow_search_plain` — the plain PyTorch version (int64 tensors
  masked to 32 bits), the same function as the JAX package's
  ``_pow_search_jnp`` with the dynamic target of ``_hit_nonce_dynamic``.
* :func:`pow_search` — the wrapper: a CUDA device launches the kernel
  ``csrc/sha256_search.cu``, the CPU runs the plain version.

Both return a 0-d int64 tensor whose ``int()`` is the least nonce in
``[nonce_base, nonce_base + count)`` that meets the target, or
:data:`SENTINEL`.  Neither waits for the card: ``int()`` does.

The batched digests of whole messages (txids and signing digests, the
JAX package's ``_sha256_blocks_jnp``, ``sha256_batch_jnp`` and
``txid_batch``) follow the same pattern, one kernel launch a batch
whatever its lengths:

* :func:`pack_ragged` pads every message into one word buffer with a
  ``(block offset, n_blocks)`` table, longest first;
* :func:`sha256_ragged_plain` — the plain PyTorch version of the ragged
  batch, and :func:`sha256_blocks_plain` of one length bucket;
* :func:`sha256_ragged` — the wrapper: on a card it stages the words and
  the table in one pinned buffer, copies them in one copy and launches
  ``csrc/sha256_blocks.cu`` once; on the CPU it runs the plain version;
  :func:`sha256_blocks` launches the same kernel on one bucket (a
  uniform table);
* :func:`sha256_batch` digests messages in input order, and
  :func:`txid_batch` chooses between hashlib and the device under the
  JAX package's ``host | device | auto`` names (``auto`` a size rule
  here) and keeps its integrity sample.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import random
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import profiling, trace
from ..device import DeviceLike, current_index, raw_stream, resolve
from ..telemetry import device as _ktel

log = logging.getLogger("upow_tpu_torch.crypto")

# --- constants -----------------------------------------------------------

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_H0 = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)

SENTINEL = np.uint32(0xFFFFFFFF)  # "no hit" marker; nonce space is capped below it

MASK32 = 0xFFFFFFFF
# Lanes of one plain-version pass: 32 MB per int64 temporary.
PLAIN_CHUNK = 1 << 22

# Kernel launches (plain integers, read by chip_smoke.py): the nonce
# search's, split by its path (ALIGNED_LAUNCHES: the nonce filling tail
# word 10, as the v2 header's does; GENERIC_LAUNCHES: any other offset),
# and the batched digests'.
# Miners and the node's executor dispatch from worker threads, so updates
# take the lock.
LAUNCHES = 0
ALIGNED_LAUNCHES = 0
GENERIC_LAUNCHES = 0
BLOCKS_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def reset_counts() -> None:
    global LAUNCHES, ALIGNED_LAUNCHES, GENERIC_LAUNCHES, BLOCKS_LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES = 0
        ALIGNED_LAUNCHES = 0
        GENERIC_LAUNCHES = 0
        BLOCKS_LAUNCHES = 0


# --- pure-Python compression (host midstate) -----------------------------

def _rotr_py(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


def _sigma0(x: int) -> int:
    return _rotr_py(x, 7) ^ _rotr_py(x, 18) ^ (x >> 3)


def _sigma1(x: int) -> int:
    return _rotr_py(x, 17) ^ _rotr_py(x, 19) ^ (x >> 10)


def _round_py(state: Sequence[int], kw: int) -> Tuple[int, ...]:
    """One SHA-256 round on the host, ``kw`` = K[i] + w[i]."""
    a, b, c, d, e, f, g, h = state
    s1 = _rotr_py(e, 6) ^ _rotr_py(e, 11) ^ _rotr_py(e, 25)
    ch = (e & f) ^ (~e & g)
    t1 = (h + s1 + ch + kw) & MASK32
    s0 = _rotr_py(a, 2) ^ _rotr_py(a, 13) ^ _rotr_py(a, 22)
    maj = (a & b) ^ (a & c) ^ (b & c)
    return ((t1 + s0 + maj) & MASK32, a, b, c, (d + t1) & MASK32, e, f, g)


def _compress_py(state: Sequence[int], block: bytes) -> Tuple[int, ...]:
    """One SHA-256 compression on the host (64-byte block)."""
    w = [int(x) for x in np.frombuffer(block, dtype=">u4")]
    for i in range(16, 64):
        w.append((w[i - 16] + _sigma0(w[i - 15]) + w[i - 7]
                  + _sigma1(w[i - 2])) & MASK32)
    out = tuple(state)
    for i in range(64):
        out = _round_py(out, int(_K[i]) + w[i])
    return tuple((x + y) & MASK32 for x, y in zip(state, out))


def sha256_py(message: bytes) -> bytes:
    """Full pure-Python sha256 (test oracle for the compression)."""
    state = tuple(int(x) for x in _H0)
    padded = message + b"\x80" + b"\x00" * ((55 - len(message)) % 64) + (8 * len(message)).to_bytes(8, "big")
    for off in range(0, len(padded), 64):
        state = _compress_py(state, padded[off:off + 64])
    return b"".join(s.to_bytes(4, "big") for s in state)


# --- template preparation (host) -----------------------------------------

class SearchTemplate(NamedTuple):
    """Everything the search needs for one mining template.

    midstate      : (8,)  uint32 — state after the full prefix blocks
    tail_words    : (16,) uint32 — final block with nonce bytes zeroed,
                    padding + length already applied
    nonce_spec    : 4×(word_index, left_shift) — where each little-endian
                    nonce byte lands in the tail words (v2 108-byte
                    header → all four bytes in w10; v1 138-byte header →
                    split across w1/w2)
    """

    midstate: np.ndarray
    tail_words: np.ndarray
    nonce_spec: Tuple[Tuple[int, int], ...]


def make_template(prefix: bytes) -> SearchTemplate:
    """Build a search template from the header prefix (header minus nonce).

    ``prefix`` is ``BlockHeader.prefix_bytes()`` — 104 bytes for v2, 134
    for v1 (core/header.py).  The full message is ``prefix + nonce(4, LE)``.
    """
    total_len = len(prefix) + 4
    n_full = len(prefix) // 64
    # in-block message (rem + nonce) must leave room for 0x80 AND the
    # 8-byte length field: rem + 4 + 1 <= 56, i.e. in-block total <= 55
    # (at exactly 56 the 0x80 would be overwritten by the length field)
    if total_len - n_full * 64 > 55:
        raise ValueError("tail would span two blocks — unsupported header size")
    state = tuple(int(x) for x in _H0)
    for i in range(n_full):
        state = _compress_py(state, prefix[i * 64:(i + 1) * 64])

    tail = bytearray(64)
    rem = prefix[n_full * 64:]
    tail[: len(rem)] = rem
    nonce_off = len(rem)  # nonce occupies tail[nonce_off : nonce_off+4]
    tail[nonce_off + 4] = 0x80
    tail[56:64] = (8 * total_len).to_bytes(8, "big")

    # little-endian nonce byte j = (nonce >> 8j) & 0xFF lands at tail byte
    # nonce_off + j, i.e. word (nonce_off+j)//4, big-endian byte slot
    # (nonce_off+j)%4 → left shift 8*(3 - slot).
    nonce_spec = tuple(
        ((nonce_off + j) // 4, 8 * (3 - (nonce_off + j) % 4)) for j in range(4)
    )
    tail_words = np.frombuffer(bytes(tail), dtype=">u4").astype(np.uint32)
    return SearchTemplate(np.array(state, dtype=np.uint32), tail_words, nonce_spec)


class TargetSpec(NamedTuple):
    """PoW acceptance test compiled to u32 compares (manager.py:130-151).

    hit ⇔ (h0 & mask0)==val0 ∧ (h1 & mask1)==val1 ∧ next-nibble < charset
    (charset check skipped when charset == 16).
    """

    mask0: np.uint32
    val0: np.uint32
    mask1: np.uint32
    val1: np.uint32
    nibble_word: int      # which digest word holds the fractional nibble
    nibble_shift: int     # right-shift to land it in the low 4 bits
    charset: int          # allowed-charset size; 16 disables the check


def target_spec(previous_hash: str, difficulty) -> TargetSpec:
    from ..core.difficulty import pow_target

    prefix, k, charset = pow_target(previous_hash, difficulty)
    if k > 16:
        raise ValueError(f"difficulty prefix of {k} hex chars exceeds 2 digest words")
    p0, p1 = prefix[:8], prefix[8:]
    mask0 = ((1 << 4 * len(p0)) - 1) << (32 - 4 * len(p0)) if p0 else 0
    val0 = int(p0, 16) << (32 - 4 * len(p0)) if p0 else 0
    mask1 = ((1 << 4 * len(p1)) - 1) << (32 - 4 * len(p1)) if p1 else 0
    val1 = int(p1, 16) << (32 - 4 * len(p1)) if p1 else 0
    return TargetSpec(
        np.uint32(mask0), np.uint32(val0), np.uint32(mask1), np.uint32(val1),
        nibble_word=k // 8, nibble_shift=28 - 4 * (k % 8), charset=charset,
    )


def pack_target(spec: TargetSpec) -> np.ndarray:
    """Pack a :class:`TargetSpec` into the (7,) u32 vector the search
    takes as data — [mask0, val0, mask1, val1, nibble_word, nibble_shift,
    charset] — so one kernel build serves every chain tip and
    difficulty."""
    return np.array(
        [spec.mask0, spec.val0, spec.mask1, spec.val1,
         spec.nibble_word, spec.nibble_shift, spec.charset],
        dtype=np.uint32,
    )


# --- the plain version ---------------------------------------------------
#
# PyTorch has little uint32 arithmetic and ``>>`` on int32 is arithmetic,
# which breaks rotates, so every word is an int64 holding a value below
# 2^32, masked after each add and each left shift.  A word that does not
# depend on the nonce stays a Python int, so rounds before the first
# nonce word cost nothing per lane.

def _rotr(x, n: int):
    return (x >> n) | ((x << (32 - n)) & MASK32)


def _compress_plain(midstate: Sequence, w: list) -> list:
    """One compression over 16 message words (ints or int64 tensors) from
    ``midstate`` (ints or int64 tensors); returns the 8 digest words."""
    w = list(w)
    a, b, c, d, e, f, g, h = midstate
    for i in range(64):
        if i >= 16:
            w15, w2 = w[i - 15], w[i - 2]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            w.append((w[i - 16] + s0 + w[i - 7] + s1) & MASK32)
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + int(_K[i]) + w[i]) & MASK32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (t1 + s0 + maj) & MASK32, a, b, c, \
            (d + t1) & MASK32, e, f, g
    return [((m if isinstance(m, torch.Tensor) else int(m)) + x) & MASK32
            for m, x in zip(midstate, (a, b, c, d, e, f, g, h))]


def _build_w(tail_words, nonces: torch.Tensor, nonce_spec) -> list:
    """Scatter the little-endian nonce bytes into the 16 tail words."""
    w = [int(x) for x in tail_words]
    for j, (widx, shift) in enumerate(nonce_spec):
        w[widx] = w[widx] | (((nonces >> (8 * j)) & 0xFF) << shift)
    return w


def hit_min_plain(digest: Sequence[torch.Tensor], nonces: torch.Tensor,
                  target, valid=None) -> torch.Tensor:
    """The least nonce whose digest meets ``target`` (the 7-word
    :func:`pack_target` vector), or SENTINEL — the JAX package's
    ``_hit_nonce_dynamic``.  ``valid`` masks lanes out of the range."""
    t = [int(x) for x in np.asarray(target, dtype=np.uint32)]
    ok = ((digest[0] & t[0]) == t[1]) & ((digest[1] & t[2]) == t[3])
    # nibble_word = k // 8 for k <= 16 hex chars, so only words 0..2 can
    # ever hold the fractional nibble; charset >= 16 disables the check
    nib = (torch.as_tensor(digest[t[4]]) >> t[5]) & 0xF
    ok = ok & ((t[6] >= 16) | (nib < t[6]))
    if valid is not None:
        ok = ok & valid
    return torch.where(ok, nonces, int(SENTINEL)).min()


def pow_search_plain(template: SearchTemplate, target, nonce_base: int,
                     count: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """Search ``[nonce_base, nonce_base + count)`` with int64 tensors on
    ``device``; returns the least hit nonce or SENTINEL as a 0-d int64
    tensor.  The tests and chip_smoke.py call it; the miner never does."""
    dev = resolve(device)
    _check_range(nonce_base, count)
    best = torch.tensor(int(SENTINEL), dtype=torch.int64, device=dev)
    for lo in range(0, count, PLAIN_CHUNK):
        width = min(PLAIN_CHUNK, count - lo)
        nonces = nonce_base + lo + torch.arange(width, dtype=torch.int64,
                                                device=dev)
        w = _build_w(template.tail_words, nonces, template.nonce_spec)
        digest = _compress_plain([int(x) for x in template.midstate], w)
        best = torch.minimum(best, hit_min_plain(digest, nonces, target))
    return best


def _check_range(nonce_base: int, count: int) -> None:
    if not 0 <= count <= MASK32 or nonce_base < 0 \
            or nonce_base + count > 1 << 32:
        raise ValueError(f"nonce range [{nonce_base}, {nonce_base}+{count})"
                         " leaves the 32-bit nonce space")


# --- the kernel ----------------------------------------------------------
#
# A nonce fills four consecutive bytes of the tail (v2 header: all of word
# 10; v1: from byte 2 of word 1 into word 2), so the rounds before its
# first word, and every message word it does not reach, are the same for
# every nonce.  The host folds them once per template and target
# (fold_template, cached by kernel_args), and the kernel computes only
# what reads the nonce.  It has two paths, chosen from the template's
# nonce_spec (search_path): the nonce filling tail word ALIGNED_WORD, and
# any other offset, which starts at round 0.

#: the tail word the aligned path's nonce fills (the v2 header's)
ALIGNED_WORD = 10
#: the kernel's paths by index, as csrc/sha256_search.cu's kSearchPaths
ALIGNED_PATH, GENERIC_PATH = 0, 1

# The kernel's by-value argument block, in 32-bit words; mirrored by
# struct SearchArgs in csrc/sha256_search.cu.
ARG_WORDS = 8 + 3 + 1 + 2 + 3 + 64 + 64 + 16 + 7 + 2


def _nonce_offset(template: SearchTemplate) -> int:
    """The tail byte that holds the nonce's first (least) byte; the other
    three must follow it, as every header places them."""
    word, shift = template.nonce_spec[0]
    offset = 4 * int(word) + 3 - int(shift) // 8
    if [(int(w), int(s)) for w, s in template.nonce_spec] != [
            ((offset + j) // 4, 8 * (3 - (offset + j) % 4)) for j in range(4)]:
        raise ValueError("the kernel takes a nonce of four consecutive "
                         f"bytes, not {template.nonce_spec}")
    return offset


def search_path(template: SearchTemplate) -> int:
    """The kernel path for ``template``'s nonce: :data:`ALIGNED_PATH`
    where it fills tail word :data:`ALIGNED_WORD`, else
    :data:`GENERIC_PATH`."""
    return ALIGNED_PATH if _nonce_offset(template) == 4 * ALIGNED_WORD \
        else GENERIC_PATH


def _path_words(path: int) -> Tuple[int, set]:
    """(the path's first round, the tail words it takes to hold nonce
    bytes)."""
    if path == ALIGNED_PATH:
        return ALIGNED_WORD, {ALIGNED_WORD}
    return 0, set(range(16))


def fold_template(template: SearchTemplate, path: int) -> dict:
    """What ``path`` of the kernel takes as constants for ``template``
    (struct SearchArgs's fields, before nonce_shift): with S the path's
    first round and a word "reached" where the path lets the nonce reach
    it,

    * ``word_c``: each message word less its nonce part (the word itself
      where the nonce does not reach it): the tail words with the nonce
      bytes zero, then w[j] = w[j-16] + s0(w[j-15]) + w[j-7] + s1(w[j-2])
      over the words and the sigmas of words the nonce does not reach;
    * ``state``: a..h after rounds 0..S-1, which read no nonce byte;
    * ``round_a``, ``round_e``: a and e after round S less the nonce part
      of word S (round S with word_c[S] for its word: h + S1(e) +
      Ch(e, f, g) + K[S] is its constant part);
    * ``round_k``: for round i > S, K[i] + word_c[i], and for i <= S + 3
      the h that is still the folded state's; ``round_d``: those three
      rounds' round_k plus their d, also the folded state's;
    * ``mid``: the midstate's words 0..2, for the digest words."""
    first, words = _path_words(path)
    reached = [j in words for j in range(16)]
    word_c = [int(x) for x in template.tail_words]
    for j in range(16, 64):
        reached.append(reached[j - 16] or reached[j - 15] or reached[j - 7]
                       or reached[j - 2])
        c = word_c[j - 16] + word_c[j - 7]
        if not reached[j - 15]:
            c += _sigma0(word_c[j - 15])
        if not reached[j - 2]:
            c += _sigma1(word_c[j - 2])
        word_c.append(c & MASK32)
    state = tuple(int(x) for x in template.midstate)
    for i in range(first):
        state = _round_py(state, int(_K[i]) + word_c[i])
    # the nonce part of word S enters a and e of round S as a plain term
    after = _round_py(state, int(_K[first]) + word_c[first])
    round_k = [0] * 64
    for i in range(first + 1, 64):
        round_k[i] = int(_K[i]) + word_c[i]
        if i <= first + 3:
            round_k[i] += state[7 - (i - first)]
    return {
        "state": list(state),
        "mid": [int(x) for x in template.midstate[:3]],
        "round_a": after[0],
        "round_e": after[4],
        "round_d": [round_k[first + 1 + k] + state[2 - k] for k in range(3)],
        "round_k": round_k,
        "word_c": word_c,
    }


def nonce_shifts(template: SearchTemplate) -> list:
    """For each tail word k, the right shift by which the generic path
    takes its nonce part from the byte-swapped nonce n (its least byte
    first): word k's part is the low word of (n << 32) >> shift, so 32
    where the nonce fills the word, 32 + 8d where it starts d bytes into
    it or d bytes before it (d < 0), and 0 where it misses the word."""
    offset = _nonce_offset(template)
    return [32 + 8 * (offset - 4 * k) if -4 < offset - 4 * k < 4 else 0
            for k in range(16)]


def _fold_block(template: SearchTemplate, target: np.ndarray,
                path: int) -> np.ndarray:
    """The argument block of ``path`` with ``base`` and ``count`` 0."""
    fold = fold_template(template, path)
    # the 1 is SearchArgs.one, the factor of the kernel's sums
    words = fold["state"] + fold["mid"] + [1, fold["round_a"], fold["round_e"]] \
        + fold["round_d"] + fold["round_k"] + fold["word_c"] \
        + nonce_shifts(template) + [int(x) for x in target]
    return np.array([int(x) & MASK32 for x in words] + [0, 0],
                    dtype=np.uint32)


# (midstate, tail, nonce_spec, target), as bytes -> (path, block): a
# miner's rounds reuse one template and target, and the mesh's rebuild
# an equal template each round, so each round copies its block and
# writes base and count, and nothing is folded again.
_BLOCKS: dict = {}
_BLOCKS_KEPT = 16
_BLOCKS_LOCK = threading.Lock()


def _search_args(template: SearchTemplate, target, nonce_base: int,
                 count: int) -> Tuple[int, np.ndarray]:
    """(path, argument block) for one launch; the folded part is cached
    a template and target."""
    target = np.asarray(target, dtype=np.uint32)
    key = (np.asarray(template.midstate, dtype=np.uint32).tobytes(),
           np.asarray(template.tail_words, dtype=np.uint32).tobytes(),
           tuple(template.nonce_spec), target.tobytes())
    hit = _BLOCKS.get(key)
    if hit is None:
        if target.shape != (7,) or int(target[4]) > 2:
            raise ValueError(f"expected a pack_target vector, got {target}")
        # the kernel adds each nonce byte into its word, where the plain
        # version ORs it: equal while the tail holds 0 there, as
        # make_template leaves it
        if any((int(template.tail_words[w]) >> s) & 0xFF
               for w, s in template.nonce_spec):
            raise ValueError("the template's tail is not 0 under the nonce")
        path = search_path(template)
        hit = (path, _fold_block(template, target, path))
        with _BLOCKS_LOCK:
            if len(_BLOCKS) >= _BLOCKS_KEPT:
                _BLOCKS.pop(next(iter(_BLOCKS)))
            _BLOCKS[key] = hit
    args = hit[1].copy()
    args[-2] = nonce_base
    args[-1] = count
    return hit[0], args


def kernel_args(template: SearchTemplate, target, nonce_base: int,
                count: int) -> np.ndarray:
    """The kernel's argument block, for the path :func:`search_path`
    picks: the folded template (:func:`fold_template`), the generic
    path's shifts (:func:`nonce_shifts`, 16), the target (7), base, count.
    Two rounds of one template and target differ only in base and
    count."""
    return _search_args(template, target, nonce_base, count)[1]


_LIBS: dict = {}
_LIB_LOCK = threading.Lock()
# each library's launch entry and its ctypes argument types
_ENTRIES = {
    "sha256_search": ("sha256_search_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]),
    "sha256_blocks": ("sha256_blocks_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}


def _kernel_lib(name: str = "sha256_search"):
    """Build (at first use) and load ``csrc/<name>.cu``."""
    with _LIB_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            from .. import _build

            lib = _build.load(name)
            entry, argtypes = _ENTRIES[name]
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


#: per thread, the call :func:`pow_search` makes just before it launches
#: the kernel, if one is set (:class:`before_launch`)
_before_launch = threading.local()


class before_launch:
    """Inside ``with before_launch(fn):``, :func:`pow_search` on this
    thread calls ``fn`` just before it launches the kernel, after the
    result's fill: the mining engine records a timing event on the
    stream there, by which it times the card's gaps between rounds.
    One instance may be entered again and again, as the engine does
    every round."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], None]):
        self.fn = fn

    def __enter__(self) -> None:
        _before_launch.fn = self.fn

    def __exit__(self, *exc) -> None:
        _before_launch.fn = None


def pow_search(template: SearchTemplate, target, nonce_base: int, count: int,
               device: DeviceLike = None) -> torch.Tensor:
    """Search ``[nonce_base, nonce_base + count)`` for the least nonce
    that meets ``target`` (the :func:`pack_target` vector).

    On the card (the default) this launches the kernel on the current
    stream and returns at once: the 0-d int64 result is a fresh tensor
    filled with SENTINEL before every launch, so no hit leaks from one
    round into the next, and ``int()`` of it waits.  ``device="cpu"``
    runs :func:`pow_search_plain`.  Without a card, and without
    ``"cpu"``, it raises."""
    global LAUNCHES, ALIGNED_LAUNCHES, GENERIC_LAUNCHES
    dev = resolve(device)
    if dev.type == "cpu":
        return pow_search_plain(template, target, nonce_base, count, dev)
    _check_range(nonce_base, count)
    path, args = _search_args(template, target, nonce_base, count)
    # the kernel min-reduces into the low 32 bits (little-endian) of this
    # int64, whose high word stays 0: int() is the unsigned nonce
    out = torch.full((), int(SENTINEL), dtype=torch.int64, device=dev)
    if count == 0:
        return out
    lib = _kernel_lib()
    index = out.get_device()
    launch_args = (args.ctypes.data, args.size, path, out.data_ptr(), index,
                   raw_stream(index))
    hook = getattr(_before_launch, "fn", None)
    if hook is not None:
        hook()
    if current_index() == index:
        rc = lib.sha256_search_launch(*launch_args)
    else:
        with torch.cuda.device(index):
            rc = lib.sha256_search_launch(*launch_args)
    if rc != 0:
        raise RuntimeError(f"sha256_search launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1
        if path == ALIGNED_PATH:
            ALIGNED_LAUNCHES += 1
        else:
            GENERIC_LAUNCHES += 1
    if profiling.COST_ANALYSIS:
        profiling.analyze_cost("sha256_search", search_work_counts,
                               template, target, count)
    return out


def search_work_counts(template: SearchTemplate, target, count: int) -> dict:
    """The least integer operations ``count`` nonces of this template
    need (:func:`ops_per_nonce`), the figures B2's bound divides."""
    alu, add = ops_per_nonce(template, target)
    return {"alu_ops_needed": alu * count, "add_ops_needed": add * count}


# --- batched digests of whole messages (txids) ---------------------------
#
# A message of length L is padded as the JAX package pads it, to
# n_blocks = (L + 8) // 64 + 1 blocks: the bytes, 0x80, (55 - L) % 64
# zero bytes and the bit length as 8 big-endian bytes.  A batch is one
# word buffer of its padded messages back to back, longest first, and a
# table of one (block offset, n_blocks) row a message: one kernel launch
# (or one plain pass a length bucket) over it.  Messages of one block
# count alone can also go as (rows, n_blocks * 16) words, a uniform
# table.

def sha256_blocks_plain(words: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(batch, n_blocks * 16) padded big-endian message words (any integer
    dtype holding the 32-bit pattern) -> (batch, 8) int32 digest words,
    the JAX package's ``_sha256_blocks_jnp``.  int64 arithmetic masked to
    32 bits, as in :func:`pow_search_plain`."""
    _check_words(words, n_blocks)
    w = words.to(torch.int64) & MASK32
    state = [int(x) for x in _H0]
    for b in range(n_blocks):
        state = _compress_plain(state, [w[:, b * 16 + i] for i in range(16)])
    if not w.shape[0]:
        return torch.empty((0, 8), dtype=torch.int32, device=w.device)
    # int64 -> int32 keeps the low 32 bits: the same bit pattern
    return torch.stack(state, dim=1).to(torch.int32)


def sha256_ragged_plain(words: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """The ragged batch's plain version: ``words`` (W,) padded big-endian
    message words back to back (any integer dtype holding the 32-bit
    pattern), ``table`` (rows, 2) int32 of (block offset, n_blocks) ->
    (rows, 8) int32 digest words in table order.  One pass a block index
    up to the longest message, as the kernel's threads chain: block b of
    every message that has one, compressed together, int64 arithmetic
    masked to 32 bits as in :func:`sha256_blocks_plain`."""
    _check_table(int(words.shape[0]), table.cpu().numpy())
    rows, dev = int(table.shape[0]), words.device
    w = words.to(torch.int64) & MASK32
    offsets, counts = table[:, 0].long(), table[:, 1].long()
    state = [torch.full((rows,), int(h), dtype=torch.int64, device=dev)
             for h in _H0]
    cols = torch.arange(16, device=dev)
    for b in range(int(counts.max()) if rows else 0):
        live = torch.nonzero(counts > b).flatten()
        block = w[((offsets[live] + b) * 16)[:, None] + cols[None, :]]
        new = _compress_plain([s[live] for s in state],
                              [block[:, i] for i in range(16)])
        for s, n in zip(state, new):
            s[live] = n
    if not rows:
        return torch.empty((0, 8), dtype=torch.int32, device=dev)
    # int64 -> int32 keeps the low 32 bits: the same bit pattern
    return torch.stack(state, dim=1).to(torch.int32)


def _check_words(words: torch.Tensor, n_blocks: int) -> None:
    if n_blocks < 1 or words.dim() != 2 or words.shape[1] != n_blocks * 16:
        raise ValueError(f"expected (batch, {n_blocks * 16}) words for "
                         f"{n_blocks} blocks, got {tuple(words.shape)}")


def _check_table(n_words: int, table: np.ndarray) -> None:
    """Every row of a (rows, 2) table names whole blocks inside a buffer
    of ``n_words`` words, or ValueError: the kernel reads where the
    table points."""
    if table.ndim != 2 or table.shape[1] != 2:
        raise ValueError(f"expected a (rows, 2) table, got {table.shape}")
    if not table.shape[0]:
        return
    offsets, counts = table[:, 0].astype(np.int64), table[:, 1]
    if int(offsets.min()) < 0 or int(counts.min()) < 1 \
            or int((offsets + counts).max()) * 16 > n_words:
        raise ValueError(f"a table row lies outside {n_words} words")


class _Staging:
    """One pinned host buffer a card, reused from batch to batch, with
    the event of the last copy out of it: a refill waits for that copy
    (the host never overwrites words the card has not read)."""

    _lock = threading.Lock()
    _by_device: dict = {}

    def __init__(self):
        self.host = torch.empty(0, dtype=torch.int32)
        self.event: Optional[torch.cuda.Event] = None

    @classmethod
    def fill(cls, device: torch.device, parts: Sequence[np.ndarray]
             ) -> torch.Tensor:
        """The int32 ``parts`` back to back on ``device``: written into
        the card's pinned buffer (grown as needed) and copied in one
        asynchronous host-to-device copy on the current stream."""
        n = sum(int(p.size) for p in parts)
        with cls._lock:
            stage = cls._by_device.setdefault(device.index, cls())
            if stage.event is not None:
                stage.event.synchronize()
            if stage.host.shape[0] < n:
                stage.host = torch.empty(max(n, 2 * stage.host.shape[0]),
                                         dtype=torch.int32, pin_memory=True)
            host = stage.host.numpy()
            at = 0
            for part in parts:
                host[at:at + part.size] = part.ravel()
                at += part.size
            on_card = torch.empty(n, dtype=torch.int32, device=device)
            on_card.copy_(stage.host[:n], non_blocking=True)
            stage.event = torch.cuda.Event()
            stage.event.record(torch.cuda.current_stream(device))
        return on_card


def _launch(words: torch.Tensor, table_ptr: Optional[int], n_blocks: int,
            rows: int) -> torch.Tensor:
    """One launch of ``csrc/sha256_blocks.cu`` on the current stream over
    the card's ``words`` (16-byte aligned): ``rows`` digests from the
    table at ``table_ptr`` (a device pointer) or, when it is None, from a
    uniform batch of ``n_blocks`` blocks a row.  Returns (rows, 8) int32,
    not yet complete; raises on a failed build, load or launch."""
    global BLOCKS_LAUNCHES
    out = torch.empty((rows, 8), dtype=torch.int32, device=words.device)
    if rows == 0:
        return out
    lib = _kernel_lib("sha256_blocks")
    dev = words.get_device()
    args = (words.data_ptr(), table_ptr, n_blocks, out.data_ptr(), rows, dev,
            raw_stream(dev))
    if current_index() == dev:
        rc = lib.sha256_blocks_launch(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.sha256_blocks_launch(*args)
    if rc != 0:
        raise RuntimeError(f"sha256_blocks launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        BLOCKS_LAUNCHES += 1
    return out


def sha256_blocks(words, n_blocks: int,
                  device: DeviceLike = None) -> torch.Tensor:
    """(batch, n_blocks * 16) padded big-endian message words -> (batch, 8)
    int32 digest words: one length bucket.

    ``words`` is a tensor, which runs where it lies, or a numpy uint32
    array, which is copied to ``device`` (the card unless ``"cpu"``).  A
    CUDA tensor makes one launch of ``csrc/sha256_blocks.cu`` with a
    uniform table on the current stream and returns at once; a CPU
    tensor runs :func:`sha256_blocks_plain`.  No fallback between the
    two: a failed build, load or launch raises."""
    if isinstance(words, np.ndarray):
        words = torch.from_numpy(
            np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
        ).to(resolve(device))
    _check_words(words, n_blocks)
    if words.device.type == "cpu":
        return sha256_blocks_plain(words, n_blocks)
    if words.device.type != "cuda" or words.dtype != torch.int32:
        raise ValueError(f"expected int32 words on a CUDA device, got "
                         f"{words.dtype} on {words.device}")
    words = words.contiguous()
    if words.data_ptr() % 16:  # the kernel reads 16 bytes at a time
        words = words.clone()
    return _launch(words, None, n_blocks, words.shape[0])


def sha256_ragged(words: np.ndarray, table: np.ndarray,
                  device: DeviceLike = None) -> torch.Tensor:
    """The ragged batch: ``words`` (W,) uint32 padded messages back to
    back and ``table`` (rows, 2) int32 of (block offset, n_blocks), both
    on the host (:func:`pack_ragged`) -> (rows, 8) int32 digest words in
    table order on ``device`` (the card unless ``"cpu"``).

    On a card: the words and the table go into the card's reused pinned
    staging buffer, one asynchronous copy, and one launch of
    ``csrc/sha256_blocks.cu`` on the current stream; the result is not
    yet complete when this returns.  On the CPU:
    :func:`sha256_ragged_plain`.  The table is checked against the words
    on the host first; a failed build, load or launch raises."""
    dev = resolve(device)
    words = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    table = np.ascontiguousarray(table, dtype=np.int32)
    _check_table(words.size, table)
    if dev.type == "cpu":
        return sha256_ragged_plain(torch.from_numpy(words),
                                   torch.from_numpy(table))
    rows = table.shape[0]
    if rows == 0:
        return torch.empty((0, 8), dtype=torch.int32, device=dev)
    on_card = _Staging.fill(dev, (words, table))
    # words first: the allocation is aligned, and the table follows whole
    # blocks of 64 bytes
    return _launch(on_card, on_card.data_ptr() + 4 * words.size, 0, rows)


def blocks_kernel_attributes(device: DeviceLike = None) -> dict:
    """Threads a block, registers and local-memory bytes a thread of the
    batched-digest kernel on a card (``cudaFuncGetAttributes``)."""
    dev = resolve(device)
    lib = _kernel_lib("sha256_blocks")
    vals = (ctypes.c_int * 3)()
    lib.sha256_blocks_attributes.argtypes = [ctypes.c_void_p]
    lib.sha256_blocks_attributes.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = lib.sha256_blocks_attributes(ctypes.addressof(vals))
    if rc != 0:
        raise RuntimeError(f"sha256_blocks_attributes: CUDA error {rc}")
    return dict(zip(("threads", "registers", "local_bytes"), vals))


def n_blocks_of(length):
    """Padded 64-byte blocks of a message of ``length`` bytes (an int or
    a numpy array of them)."""
    return (length + 8) // 64 + 1


def pack_bucket(messages: Sequence[bytes], n_blocks: int) -> np.ndarray:
    """Pad messages of one bucket into (rows, n_blocks * 16) uint32 words
    in bulk: the messages of each length (a bucket holds at most 64)
    joined and copied into a zeroed buffer as one 2-D block, then the
    0x80 bytes and the bit lengths, then one byte swap of the buffer."""
    rows, width = len(messages), n_blocks * 64
    lens = np.fromiter(map(len, messages), dtype=np.int64, count=rows)
    if rows and int(lens.max()) + 9 > width:
        raise ValueError(f"a message of {int(lens.max())} bytes does not "
                         f"fit {n_blocks} blocks")
    buf = np.zeros((rows, width), dtype=np.uint8)
    for length in np.unique(lens).tolist():
        idx = np.nonzero(lens == length)[0]
        if length:
            joined = b"".join([messages[i] for i in idx.tolist()])
            buf[idx, :length] = np.frombuffer(joined, dtype=np.uint8) \
                .reshape(len(idx), length)
        buf[idx, length] = 0x80
    buf[:, width - 8:] = (lens * 8).astype(">u8").view(np.uint8).reshape(
        rows, 8)
    return buf.view(">u4").astype(np.uint32)


def pack_ragged(messages: Sequence[bytes]) -> tuple:
    """Pad every message of a batch into one buffer, longest first:
    ``(words, table, order)`` with ``words`` (W,) uint32, ``table``
    (rows, 2) int32 of (block offset, n_blocks) and ``order`` the input
    index of each table row.  Each length bucket is packed by
    :func:`pack_bucket` into its own contiguous run of rows."""
    n = len(messages)
    lens = np.fromiter(map(len, messages), dtype=np.int64, count=n)
    counts = n_blocks_of(lens)
    order = np.argsort(-counts, kind="stable")
    sorted_counts = counts[order]
    offsets = np.cumsum(sorted_counts) - sorted_counts
    words = np.empty(int(sorted_counts.sum()) * 16, dtype=np.uint32)
    at = 0
    for n_blocks in sorted(np.unique(counts).tolist(), reverse=True):
        idxs = order[at:at + int((counts == n_blocks).sum())]
        lo = int(offsets[at]) * 16
        words[lo:lo + len(idxs) * n_blocks * 16] = pack_bucket(
            [messages[i] for i in idxs.tolist()], n_blocks).ravel()
        at += len(idxs)
    table = np.stack([offsets, sorted_counts], axis=1).astype(np.int32)
    return words, table, order


def _digest_array(messages: Sequence[bytes],
                  device: DeviceLike = None) -> np.ndarray:
    """(len(messages), 32) uint8 digests in input order: the batch packed
    by :func:`pack_ragged`, one :func:`sha256_ragged` (one launch on a
    card), one read-back."""
    dev = resolve(device)
    t0 = time.perf_counter()
    words, table, order = pack_ragged(messages)
    digests = sha256_ragged(words, table, dev).cpu().numpy().view(np.uint32)
    out = np.empty((len(messages), 32), dtype=np.uint8)
    out[order] = digests.astype(">u4").view(np.uint8).reshape(-1, 32)
    _ktel.record_batch("sha256_txid",
                       real=sum(map(len, messages)), padded=words.size * 4,
                       seconds=time.perf_counter() - t0,
                       compile_key=("sha256_blocks",)
                       if dev.type == "cuda" else None)
    if profiling.COST_ANALYSIS:
        profiling.analyze_cost("sha256_txid", blocks_work_counts,
                               words.size // 16, len(messages))
    return out


def blocks_work_counts(n_blocks: int, n_messages: int) -> dict:
    """The least integer operations and bytes of one ragged batch of
    ``n_blocks`` compressions over ``n_messages`` messages, the figures
    B5's bound divides: :data:`BLOCK_ALU_OPS` and :data:`BLOCK_ADD_OPS`
    a block, its words read once and each digest written once."""
    return {"alu_ops_needed": n_blocks * BLOCK_ALU_OPS,
            "add_ops_needed": n_blocks * BLOCK_ADD_OPS,
            "bytes_needed": n_blocks * 64 + n_messages * 40}


def sha256_batch(messages: Sequence[bytes],
                 device: DeviceLike = None) -> List[bytes]:
    """sha256 of every message, in input order (the JAX package's
    ``sha256_batch_jnp``): one ragged batch on ``device`` (the card
    unless ``"cpu"``), one launch on a card."""
    raw = _digest_array(messages, device).tobytes()
    return [raw[i:i + 32] for i in range(0, len(raw), 32)]


# ``auto`` takes the device for a batch of at least this many payloads
# on a card, hashlib below it and always on the CPU.  The device's whole
# path (pack, copy, launches, read-back, hex) against hashlib on the
# accept's payload mix, in three runs of the ``txid_crossover`` line of
# chip_smoke.py on an H100 at 700 W: faster at 16,384 payloads in all
# three (by 2-11 %), at 24,480 in two, at 6,144 and 12,288 in one each,
# at 8,192 and at 4,096 or fewer in none
TXID_AUTO_DEVICE_MIN = 16384
_TXID_SAMPLE_SALT = 0  # per-call roam counter of the integrity sample
_TXID_LOCK = threading.Lock()
TXID_SAMPLES = 8


def _host_txids(payloads: Sequence[bytes]) -> List[str]:
    return [hashlib.sha256(p).hexdigest() for p in payloads]


def txid_auto_backend(n_payloads: int, device: torch.device) -> str:
    """What ``auto`` runs for a batch of ``n_payloads`` on ``device``."""
    if device.type == "cpu" or n_payloads < TXID_AUTO_DEVICE_MIN:
        return "host"
    return "device"


def txid_batch(payloads: Sequence[bytes], backend: str = "auto",
               min_batch: int = 256, device: DeviceLike = None) -> List[str]:
    """Hex sha256 digests of ``payloads`` (the txids of a sync page, or
    the txids and signing digests of a block's verify micro-batch), in
    input order.

    ``backend`` is one of the JAX package's three:

    * ``host``: hashlib, one payload at a time;
    * ``device``: :func:`sha256_batch` on ``device`` (the card unless
      ``"cpu"``, where it runs the plain version);
    * ``auto``: :func:`txid_auto_backend`, the device for a batch of at
      least :data:`TXID_AUTO_DEVICE_MIN` payloads on a card, else
      hashlib.  The JAX package times both once per process instead.

    Fewer than ``min_batch`` payloads always take hashlib.  Device
    digests feed consensus, so a roaming sample of
    :data:`TXID_SAMPLES` lanes is checked against hashlib on every device
    batch; a mismatch returns hashlib's digests for the whole batch,
    counts ``txid.sample_mismatch`` and logs a warning.  Unlike the JAX
    package, a device failure raises: there is no fallback that hides a
    broken kernel.
    """
    global _TXID_SAMPLE_SALT
    if not payloads:
        return []
    if backend == "host" or len(payloads) < min_batch:
        return _host_txids(payloads)
    if backend not in ("device", "auto"):
        raise ValueError(f"unknown txid backend {backend!r}")
    dev = resolve(device)
    if backend == "auto" and txid_auto_backend(len(payloads), dev) == "host":
        return _host_txids(payloads)
    hexes = _digest_array(payloads, dev).tobytes().hex()
    out = [hexes[i:i + 64] for i in range(0, len(hexes), 64)]
    # the sample roams: seeded from the payloads and a per-call counter,
    # so a retry of the same page checks other lanes
    with _TXID_LOCK:
        _TXID_SAMPLE_SALT += 1
        salt = _TXID_SAMPLE_SALT
    seed = int.from_bytes(hashlib.sha256(
        payloads[0] + payloads[-1] + len(payloads).to_bytes(4, "big")
        + salt.to_bytes(8, "big")).digest()[:8], "big")
    for i in random.Random(seed).sample(range(len(out)),
                                        min(len(out), TXID_SAMPLES)):
        if hashlib.sha256(payloads[i]).hexdigest() != out[i]:
            trace.inc("txid.sample_mismatch")
            log.warning("device txid digest mismatch at sample %d; hashlib "
                        "digests for this batch of %d", i, len(payloads))
            return _host_txids(payloads)
    return out


# The least 32-bit integer instructions one compression over 16 unknown
# words needs: each of the 48 schedule words two sigma functions of 2
# rotates, a shift and a LOP3 (8 ALU) and 2 IADD3s for its 4 terms; each
# of the 64 rounds the two Sigma functions (3 rotates and a LOP3 each),
# ch and maj (a LOP3 each), 2 IADD3s for t1's 5 terms and one each for
# the new a and e (10 ALU, 4 adds); then 8 adds into the state.
BLOCK_ALU_OPS = 48 * 8 + 64 * 10
BLOCK_ADD_OPS = 48 * 2 + 64 * 4 + 8


# --- the bound -----------------------------------------------------------
#
# The least 32-bit integer instructions one nonce needs, counted on the
# template's own dataflow.  A word that does not depend on the nonce is a
# Python int, folded once per template; a word that does is a node, and
# only the nodes that the target test reads count.  An "alu" node is an
# SHF (a rotate or a shift), a LOP3 (any logic of up to 3 inputs) or a
# PRMT (the nonce's bytes into a message word); these issue on the ALU
# pipe alone.  An "add" node is an IADD3 (3 terms), which the card may
# also issue as IMAD on the FMA pipe.

class _Node(NamedTuple):
    index: int


class _Dataflow:
    def __init__(self):
        self.operands: list = []   # node -> the nodes it reads
        self.pipe: list = []       # node -> "alu" | "add"
        self.offset: dict = {}     # node -> (v, c) where it is v + c

    def node(self, pipe: str, *args) -> _Node:
        self.operands.append([a for a in args if isinstance(a, _Node)])
        self.pipe.append(pipe)
        return _Node(len(self.pipe) - 1)

    def rotr(self, x, n: int):
        return _rotr_py(x, n) if isinstance(x, int) else self.node("alu", x)

    def shr(self, x, n: int):
        return x >> n if isinstance(x, int) else self.node("alu", x)

    def logic(self, fn, *xs):
        """One LOP3, unless every input is a constant."""
        if all(isinstance(x, int) for x in xs):
            return fn(*xs) & MASK32
        return self.node("alu", *xs)

    def add(self, *terms):
        """The sum mod 2^32 in IADD3s, with the constant terms folded into
        one.  A term that is itself v + c is read as v, with c folded in,
        wherever that takes no more IADD3s (a constant term is there
        anyway, or the count of terms is even), so it may go unread."""
        nodes = [t for t in terms if isinstance(t, _Node)]
        const = sum(t for t in terms if isinstance(t, int)) & MASK32
        if const or len(nodes) % 2 == 0:
            for i, t in enumerate(nodes):
                if t in self.offset:
                    nodes[i], c = self.offset[t]
                    const = (const + c) & MASK32
        if not nodes:
            return const
        operands = nodes + ([const] if const else [])
        while len(operands) > 1:
            operands = [self.node("add", *operands[:3])] + operands[3:]
        if len(nodes) == 1 and const:
            self.offset[operands[0]] = (nodes[0], const)
        return operands[0]

    def count(self, outputs) -> Tuple[int, int]:
        """(alu, add) nodes that ``outputs`` read."""
        live, todo = set(), [o for o in outputs if isinstance(o, _Node)]
        while todo:
            n = todo.pop()
            if n.index not in live:
                live.add(n.index)
                todo += self.operands[n.index]
        alu = sum(self.pipe[i] == "alu" for i in live)
        return alu, len(live) - alu


def ops_per_nonce(template: SearchTemplate, target) -> Tuple[int, int]:
    """(alu, add): the least 32-bit integer instructions one nonce needs
    with this template and target (the :func:`pack_target` vector) —
    one PRMT per message word that holds nonce bytes, every operation of
    the schedule and the rounds that reads the nonce, and the digest
    words that the target test reads, each with its add and the test's
    LOP3 and compare."""
    df = _Dataflow()
    xor3 = lambda p, q, r: p ^ q ^ r  # noqa: E731
    w = [int(x) for x in template.tail_words]
    for widx in sorted({widx for widx, _shift in template.nonce_spec}):
        w[widx] = df.node("alu")
    for i in range(16, 64):
        x, y = w[i - 15], w[i - 2]
        s0 = df.logic(xor3, df.rotr(x, 7), df.rotr(x, 18), df.shr(x, 3))
        s1 = df.logic(xor3, df.rotr(y, 17), df.rotr(y, 19), df.shr(y, 10))
        w.append(df.add(w[i - 16], s0, w[i - 7], s1))
    mid = [int(x) for x in template.midstate]
    a, b, c, d, e, f, g, h = mid
    for i in range(64):
        S1 = df.logic(xor3, df.rotr(e, 6), df.rotr(e, 11), df.rotr(e, 25))
        ch = df.logic(lambda p, q, r: (p & q) ^ (~p & r), e, f, g)
        t1 = df.add(h, S1, ch, int(_K[i]), w[i])
        S0 = df.logic(xor3, df.rotr(a, 2), df.rotr(a, 13), df.rotr(a, 22))
        maj = df.logic(lambda p, q, r: (p & q) ^ (p & r) ^ (q & r), a, b, c)
        a, b, c, d, e, f, g, h = df.add(t1, S0, maj), a, b, c, \
            df.add(d, t1), e, f, g
    # the test's terms: prefix words 0 and 1 where masked, and the nibble
    # (in word 0, 1 or 2) unless the charset is 16
    t = [int(x) for x in np.asarray(target, dtype=np.uint32)]
    terms = [k for k, on in ((0, t[0]), (1, t[2]), (t[4], t[6] < 16)) if on]
    alu, add = df.count([df.add(mid[k], (a, b, c)[k])
                         for k in sorted(set(terms))])
    return alu + 2 * len(terms), add
