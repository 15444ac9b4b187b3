"""uPow's wire formats and consensus arithmetic, written plainly.

This is the yardstick's own copy of what the generator writes and what
the reference checks: P-256 keys and signing, compressed base58 addresses,
the one-input transaction, the coinbase, the v2 header, the flat merkle
hash and the PoW rule (upowai/upow `transaction.py`, `helpers.py`,
`manager.py:130-151,352-419`).  It imports nothing of the program.

All integers on the wire are little-endian; amounts are integers in
units of 1e-8 coins.
"""

from __future__ import annotations

import hashlib
from decimal import Decimal
from math import ceil
from typing import List, Optional, Sequence, Tuple

P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
G = (0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
     0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5)

SMALLEST = 100_000_000
MAX_BLOCK_SIZE_HEX = 4096 * 1024          # constants.py:8
START_DIFFICULTY = Decimal("6.0")         # manager.py:29
GENESIS_PREV_HASH = (18_884_643).to_bytes(32, "little").hex()  # miner.py:37-40


# --- P-256 in affine and Jacobian coordinates ----------------------------

def _jac_double(p):
    """Jacobian doubling for a = -3 (dbl-2001-b)."""
    x, y, z = p
    if y == 0:
        return (0, 1, 0)
    zz = z * z % P
    m = 3 * (x - zz) * (x + zz) % P
    yy = y * y % P
    s = 4 * x * yy % P
    x3 = (m * m - 2 * s) % P
    y3 = (m * (s - x3) - 8 * yy * yy) % P
    return (x3, y3, 2 * y * z % P)


def _jac_add_affine(p, q):
    """Jacobian p plus affine q."""
    x1, y1, z1 = p
    if z1 == 0:
        return (q[0], q[1], 1)
    z1z1 = z1 * z1 % P
    u2 = q[0] * z1z1 % P
    s2 = q[1] * z1 * z1z1 % P
    h = (u2 - x1) % P
    r = (s2 - y1) % P
    if h == 0:
        return _jac_double(p) if r == 0 else (0, 1, 0)
    hh = h * h % P
    hhh = h * hh % P
    v = x1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - y1 * hhh) % P
    return (x3, y3, z1 * h % P)


def _to_affine(p) -> Optional[Tuple[int, int]]:
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


class FixedBase:
    """k·G by an 8-bit comb: 32 tables of 255 affine multiples of
    256^i·G, so one product is at most 32 mixed additions."""

    def __init__(self):
        self.tables = []
        base = G
        for _ in range(32):
            row, acc = [], (0, 1, 0)
            for _d in range(255):
                acc = _jac_add_affine(acc, base)
                row.append(acc)
            self.tables.append(_batch_affine(row))
            base = _to_affine(_jac_double(row[127]))  # 256·base

    def mul_jacobian(self, k: int):
        acc, i = (0, 1, 0), 0
        while k:
            d = k & 0xFF
            if d:
                acc = _jac_add_affine(acc, self.tables[i][d - 1])
            k >>= 8
            i += 1
        return acc

    def mul_many(self, scalars: Sequence[int]) -> List[Tuple[int, int]]:
        """Affine k·G for every k, with one field inversion for all."""
        return _batch_affine([self.mul_jacobian(k % N) for k in scalars])


def _batch_affine(points) -> List[Tuple[int, int]]:
    """Jacobian to affine with Montgomery's trick (one inversion)."""
    prefix, acc = [], 1
    for _x, _y, z in points:
        prefix.append(acc)
        acc = acc * z % P
    inv = pow(acc, -1, P)
    out = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        x, y, z = points[i]
        zi = inv * prefix[i] % P
        inv = inv * z % P
        zi2 = zi * zi % P
        out[i] = (x * zi2 % P, y * zi2 * zi % P)
    return out


def digest_int(message: bytes) -> int:
    """The ECDSA message integer: sha256 read big-endian (bits2int of a
    256-bit digest against a 256-bit order)."""
    return int.from_bytes(hashlib.sha256(message).digest(), "big")


# --- addresses -----------------------------------------------------------

_B58 = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def b58encode(data: bytes) -> str:
    n = int.from_bytes(data, "big")
    out = []
    while n:
        n, r = divmod(n, 58)
        out.append(_B58[r])
    pad = len(data) - len(data.lstrip(b"\0"))
    return "1" * pad + "".join(reversed(out))


def b58decode(s: str) -> bytes:
    n = 0
    for c in s:
        n = n * 58 + _B58.index(c)
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return b"\0" * (len(s) - len(s.lstrip("1"))) + body


def address_bytes(pub: Tuple[int, int]) -> bytes:
    """The 33-byte compressed form: 42 (even y) or 43 (odd y), then x."""
    return bytes([43 if pub[1] % 2 else 42]) + pub[0].to_bytes(32, "little")


def address(pub: Tuple[int, int]) -> str:
    return b58encode(address_bytes(pub))


# --- transactions ---------------------------------------------------------

def output_bytes(addr_raw: bytes, amount: int) -> bytes:
    n = (amount.bit_length() + 7) // 8
    return addr_raw + bytes([n]) + amount.to_bytes(n, "little") + b"\0"


def tx_body(inputs: Sequence[Tuple[str, int]],
            outputs: Sequence[Tuple[bytes, int]]) -> bytes:
    """The signing form of a version-3 regular transaction: version,
    inputs (hash, index, type 0) and outputs (compressed address,
    amount, type 0), with no message."""
    out = bytearray([3, len(inputs)])
    for h, i in inputs:
        out += bytes.fromhex(h) + bytes([i, 0])
    out.append(len(outputs))
    for raw, amount in outputs:
        out += output_bytes(raw, amount)
    return bytes(out)


def tx_full(body: bytes, sigs: Sequence[Tuple[int, int]]) -> bytes:
    """The wire form: the body, the empty-message specifier, then each
    distinct signature as r || s, 32 bytes little-endian each."""
    out = bytearray(body) + b"\0"
    seen = []
    for r, s in sigs:
        raw = r.to_bytes(32, "little") + s.to_bytes(32, "little")
        if raw not in seen:
            seen.append(raw)
            out += raw
    return bytes(out)


def coinbase_tx(block_hash: str, addr_raw: bytes, amount: int) -> bytes:
    """Version 2 for a compressed address, input (block hash, 0), one
    output, specifier 36 (coinbase_transaction.py:22-44)."""
    return (bytes([2, 1]) + bytes.fromhex(block_hash) + b"\0\0" + bytes([1])
            + output_bytes(addr_raw, amount) + bytes([36]))


def parse_tx(raw: bytes) -> dict:
    """Inputs, outputs and signatures of a version-2/3 transaction with
    compressed addresses and no message (what the generator writes)."""
    pos = 2
    n_in = raw[1]
    inputs = []
    for _ in range(n_in):
        inputs.append((raw[pos:pos + 32].hex(), raw[pos + 32]))
        pos += 34
    n_out = raw[pos]
    pos += 1
    outputs = []
    for _ in range(n_out):
        addr_raw = raw[pos:pos + 33]
        n = raw[pos + 33]
        amount = int.from_bytes(raw[pos + 34:pos + 34 + n], "little")
        outputs.append((addr_raw, amount))
        pos += 35 + n
    body_end = pos
    specifier = raw[pos]
    pos += 1
    sigs = []
    while pos + 64 <= len(raw):
        sigs.append((int.from_bytes(raw[pos:pos + 32], "little"),
                     int.from_bytes(raw[pos + 32:pos + 64], "little")))
        pos += 64
    return {"inputs": inputs, "outputs": outputs, "sigs": sigs,
            "body": raw[:body_end], "coinbase": specifier == 36}


def txid(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()


# --- blocks ----------------------------------------------------------------

def header_prefix(prev_hash: str, addr_raw: bytes, merkle: str, ts: int,
                  difficulty: Decimal) -> bytes:
    """The 104-byte v2 header before its nonce."""
    return (bytes([2]) + bytes.fromhex(prev_hash) + addr_raw
            + bytes.fromhex(merkle) + ts.to_bytes(4, "little")
            + int(Decimal(difficulty) * 10).to_bytes(2, "little"))


def split_header(content: str) -> dict:
    raw = bytes.fromhex(content)
    if len(raw) != 108 or raw[0] != 2:
        raise ValueError("not a v2 header")
    return {"prev": raw[1:33].hex(), "address_raw": raw[33:66],
            "merkle": raw[66:98].hex(),
            "timestamp": int.from_bytes(raw[98:102], "little"),
            "difficulty": Decimal(int.from_bytes(raw[102:104], "little"))
            / 10,
            "nonce": int.from_bytes(raw[104:108], "little")}


def merkle_root(tx_raws: Sequence[bytes]) -> str:
    """sha256 over the txids, ordered by the transactions' bytes
    (manager.py:365-378)."""
    leaves = sorted((raw.hex(), hashlib.sha256(raw).digest())
                    for raw in tx_raws)
    return hashlib.sha256(b"".join(d for _h, d in leaves)).hexdigest()


def miner_merkle(hashes: Sequence[str]) -> str:
    """The miner's root over the pending hashes, in the node's order
    (miner.py:15-18)."""
    return hashlib.sha256(b"".join(bytes.fromhex(h) for h in hashes)).hexdigest()


def charset(difficulty: Decimal) -> int:
    frac = Decimal(difficulty) % 1
    return ceil(16 * (1 - frac)) if frac > 0 else 16


def pow_ok(block_hash: str, prev_hash: str, difficulty: Decimal) -> bool:
    """manager.py:130-151: the hash starts with the last int(difficulty)
    hex digits of the previous hash, and for a fractional difficulty the
    next digit lies among the first ceil(16 (1 - frac)) of the charset."""
    k = int(Decimal(difficulty))
    if not block_hash.startswith(prev_hash[-k:]):
        return False
    count = charset(difficulty)
    return count >= 16 or int(block_hash[k], 16) < count


def block_reward(height: int) -> int:
    """6 coins a block up to the first halving at 1,576,800
    (manager.py:154-168), which the generated chains never reach."""
    if height > 1_576_800:
        raise ValueError("past the first halving")
    return 6 * SMALLEST
