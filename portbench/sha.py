"""SHA-256 nonce search in plain PyTorch, and the count of its work.

``search`` is the reference for a mining round: the least nonce in a
range whose header hash meets the PoW rule, computed with int64 tensors
on whatever device it is given (the card, after the window; the CPU in
tests).  The generator mines its chain with it too.

``ops_per_nonce`` is the roofline's operation count: the least 32-bit
integer instructions one nonce needs on this template and target,
counted on the template's own dataflow.  It is a copy of the program's
``crypto/sha256.py`` bound, kept here so that the yardstick stays the
same whatever implements the search.
"""

from __future__ import annotations

from decimal import Decimal
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import uformat

MASK32 = 0xFFFFFFFF
_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_K = [
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
]
SENTINEL = MASK32  # the searchers' no-hit value; nonce 2^32 - 1 is never searched


def _rotr(x, n: int):
    return (x >> n) | ((x << (32 - n)) & MASK32)


def _compress(state: Sequence, w: list) -> list:
    """One compression of 16 message words (ints or int64 tensors)."""
    w = list(w)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        if i >= 16:
            x, y = w[i - 15], w[i - 2]
            s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
            s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
            w.append((w[i - 16] + s0 + w[i - 7] + s1) & MASK32)
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((~e & MASK32) & g)
        t1 = (h + s1 + ch + _K[i] + w[i]) & MASK32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = ((t1 + s0 + maj) & MASK32, a, b, c,
                                  (d + t1) & MASK32, e, f, g)
    return [(s + x) & MASK32 for s, x in zip(state, (a, b, c, d, e, f, g, h))]


class Template(NamedTuple):
    midstate: Tuple[int, ...]
    tail: Tuple[int, ...]                 # the last block, nonce bytes zero
    nonce_spec: Tuple[Tuple[int, int], ...]  # (word, left shift) per byte


def template(prefix: bytes) -> Template:
    """The header prefix's midstate and padded last block (the nonce is
    the header's last 4 bytes, little-endian)."""
    total = len(prefix) + 4
    n_full = len(prefix) // 64
    if total - n_full * 64 > 55:
        raise ValueError("the nonce's block would need a second block")
    state = list(_H0)
    for i in range(n_full):
        block = prefix[i * 64:(i + 1) * 64]
        state = _compress(state, [int.from_bytes(block[j:j + 4], "big")
                                  for j in range(0, 64, 4)])
    tail = bytearray(64)
    rem = prefix[n_full * 64:]
    tail[:len(rem)] = rem
    tail[len(rem) + 4] = 0x80
    tail[56:] = (8 * total).to_bytes(8, "big")
    spec = tuple(((len(rem) + j) // 4, 8 * (3 - (len(rem) + j) % 4))
                 for j in range(4))
    words = tuple(int.from_bytes(tail[j:j + 4], "big") for j in range(0, 64, 4))
    return Template(tuple(state), words, spec)


def target(prev_hash: str, difficulty) -> Tuple[int, ...]:
    """The PoW rule as u32 compares: (mask0, val0, mask1, val1,
    nibble word, nibble shift, charset)."""
    difficulty = Decimal(str(difficulty))
    k = int(difficulty)
    prefix = prev_hash[-k:] if k else prev_hash
    if len(prefix) > 16:
        raise ValueError("more than two digest words of prefix")
    p0, p1 = prefix[:8], prefix[8:]

    def mask(p):
        return ((1 << 4 * len(p)) - 1) << (32 - 4 * len(p)) if p else 0

    def val(p):
        return int(p, 16) << (32 - 4 * len(p)) if p else 0

    return (mask(p0), val(p0), mask(p1), val(p1), k // 8, 28 - 4 * (k % 8),
            uformat.charset(difficulty))


def search(prefix: bytes, prev_hash: str, difficulty, start: int, count: int,
           device, chunk: int = 1 << 22) -> Optional[int]:
    """The least nonce in [start, start + count) whose header hash meets
    the rule, or None."""
    tpl = template(prefix)
    t = target(prev_hash, difficulty)
    best = None
    for lo in range(start, start + count, chunk):
        width = min(chunk, start + count - lo)
        nonces = torch.arange(lo, lo + width, dtype=torch.int64, device=device)
        w = list(tpl.tail)
        for j, (widx, shift) in enumerate(tpl.nonce_spec):
            w[widx] = w[widx] | (((nonces >> (8 * j)) & 0xFF) << shift)
        dig = _compress(list(tpl.midstate), w)
        ok = ((dig[0] & t[0]) == t[1]) & ((dig[1] & t[2]) == t[3])
        if t[6] < 16:
            ok = ok & (((dig[t[4]] >> t[5]) & 0xF) < t[6])
        hits = nonces[ok]
        if hits.numel():
            best = int(hits.min())
            break
    return best


def mine(prefix: bytes, prev_hash: str, difficulty, device,
         chunk: int = 1 << 22) -> int:
    """The least nonce of the whole space that meets the rule."""
    for lo in range(0, SENTINEL, chunk):
        hit = search(prefix, prev_hash, difficulty, lo,
                     min(chunk, SENTINEL - lo), device, chunk)
        if hit is not None:
            return hit
    raise RuntimeError("no nonce meets the rule on this template")


# --- the count of work ------------------------------------------------------

class _Node(NamedTuple):
    index: int


class _Dataflow:
    """Each word that depends on the nonce is a node; a word that does
    not is a Python int, folded once a template.  An "alu" node is an
    SHF, LOP3 or PRMT (ALU pipe only); an "add" node an IADD3, which may
    also issue on the FMA pipe as IMAD."""

    def __init__(self):
        self.operands: list = []
        self.pipe: list = []
        self.offset: dict = {}

    def node(self, pipe: str, *args) -> _Node:
        self.operands.append([a for a in args if isinstance(a, _Node)])
        self.pipe.append(pipe)
        return _Node(len(self.pipe) - 1)

    def rotr(self, x, n):
        return _rotr(x, n) if isinstance(x, int) else self.node("alu", x)

    def shr(self, x, n):
        return x >> n if isinstance(x, int) else self.node("alu", x)

    def logic(self, fn, *xs):
        if all(isinstance(x, int) for x in xs):
            return fn(*xs) & MASK32
        return self.node("alu", *xs)

    def add(self, *terms):
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
        live, todo = set(), [o for o in outputs if isinstance(o, _Node)]
        while todo:
            n = todo.pop()
            if n.index not in live:
                live.add(n.index)
                todo += self.operands[n.index]
        alu = sum(self.pipe[i] == "alu" for i in live)
        return alu, len(live) - alu


def ops_per_nonce(prefix: bytes, prev_hash: str, difficulty) -> Tuple[int, int]:
    """(alu, add): a PRMT per message word holding nonce bytes, every
    operation of the schedule and rounds that reads the nonce, and the
    digest words the target test reads, each with its add and the test's
    LOP3 and compare."""
    tpl = template(prefix)
    t = target(prev_hash, difficulty)
    df = _Dataflow()

    def xor3(p, q, r):
        return p ^ q ^ r

    w: List = list(tpl.tail)
    for widx in sorted({widx for widx, _s in tpl.nonce_spec}):
        w[widx] = df.node("alu")
    for i in range(16, 64):
        x, y = w[i - 15], w[i - 2]
        s0 = df.logic(xor3, df.rotr(x, 7), df.rotr(x, 18), df.shr(x, 3))
        s1 = df.logic(xor3, df.rotr(y, 17), df.rotr(y, 19), df.shr(y, 10))
        w.append(df.add(w[i - 16], s0, w[i - 7], s1))
    mid = list(tpl.midstate)
    a, b, c, d, e, f, g, h = mid
    for i in range(64):
        S1 = df.logic(xor3, df.rotr(e, 6), df.rotr(e, 11), df.rotr(e, 25))
        ch = df.logic(lambda p, q, r: (p & q) ^ (~p & r), e, f, g)
        t1 = df.add(h, S1, ch, _K[i], w[i])
        S0 = df.logic(xor3, df.rotr(a, 2), df.rotr(a, 13), df.rotr(a, 22))
        maj = df.logic(lambda p, q, r: (p & q) ^ (p & r) ^ (q & r), a, b, c)
        a, b, c, d, e, f, g, h = df.add(t1, S0, maj), a, b, c, \
            df.add(d, t1), e, f, g
    terms = [k for k, on in ((0, t[0]), (1, t[2]), (t[4], t[6] < 16)) if on]
    alu, add = df.count([df.add(mid[k], (a, b, c)[k])
                         for k in sorted(set(terms))])
    return alu + 2 * len(terms), add


def clocks_per_nonce(prefix: bytes, prev_hash: str, difficulty) -> float:
    """SM clocks one nonce needs at the least: 64 ALU-pipe operations and
    at most 128 integer operations an SM a clock (compute capability
    9.0), whichever binds."""
    alu, add = ops_per_nonce(prefix, prev_hash, difficulty)
    return max(alu / 64, (alu + add) / 128)
