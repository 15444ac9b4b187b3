"""The generated chains, made from ``--seed`` by the yardstick's own code.

``solo_chain``: the history a solo miner's node holds.  Blocks 1-100 at
the protocol's start difficulty and the rest at the configuration's,
each with its coinbase to the miner's address (block 1's address is the
one the emission gate lets mine); blocks 2 and 3 fan block 1's coinbase
out into the outputs the wallets spend.  Its PoW is not searched: the history
is assumed (the configuration says so), and the node reads it without
checking it again.

``rig_chain``: the chain a catching-up node downloads.  A fan-out prefix
(block 1's coinbase, a fan transaction of 255 outputs, 255 transactions
of 32 outputs each: 8,160 spendable outputs) and then full blocks of
8,160 one-input, one-output transactions, each spending the output of
the same slot in the block before, signed by the slot's wallet.  Every
block's PoW is searched for real, at the protocol's start difficulty.

Signatures draw their nonces from a seeded pool whose points are
computed once, in one batch; every signature is a valid ECDSA signature
over its own message, so the verifier's work is unchanged.
"""

from __future__ import annotations

import json
import random
import sqlite3
from dataclasses import dataclass, field
from decimal import Decimal
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from . import sha, uformat

#: the first block's timestamp; every later block is 60 s after the one
#: before (manager.py:26's BLOCK_TIME), so the tip lies in the past
BASE_TIME = 1_700_000_000


@dataclass
class Key:
    d: int
    pub: Tuple[int, int]

    @property
    def raw(self) -> bytes:
        return uformat.address_bytes(self.pub)

    @property
    def address(self) -> str:
        return uformat.address(self.pub)


@dataclass
class Block:
    height: int
    hash: str
    content: str
    address: str
    nonce: int
    difficulty: Decimal
    reward: int            # block reward plus fees, smallest units
    timestamp: int
    txs: List[bytes] = field(default_factory=list)   # coinbase first

    def json(self) -> dict:
        """The block as a port node serves it in ``get_blocks``."""
        return {"block": {
            "id": self.height, "hash": self.hash, "content": self.content,
            "address": self.address, "random": self.nonce,
            "difficulty": float(self.difficulty),
            "reward": str(Decimal(self.reward) / uformat.SMALLEST),
            "timestamp": self.timestamp},
            "transactions": [t.hex() for t in self.txs]}


def keys(rng: random.Random, n: int) -> List[Key]:
    fb = _fixed_base()
    ds = [rng.getrandbits(256) % (uformat.N - 1) + 1 for _ in range(n)]
    return [Key(d, p) for d, p in zip(ds, fb.mul_many(ds))]


_FB: Optional[uformat.FixedBase] = None


def _fixed_base() -> uformat.FixedBase:
    global _FB
    if _FB is None:
        _FB = uformat.FixedBase()
    return _FB


class Signer:
    """ECDSA with nonces drawn by message from a pool of ``size``."""

    def __init__(self, rng: random.Random, size: int = 1024):
        ks = [rng.getrandbits(256) % (uformat.N - 1) + 1 for _ in range(size)]
        self.pool = [(k, pt[0] % uformat.N)
                     for k, pt in zip(ks, _fixed_base().mul_many(ks))]
        self.kinv = [pow(k, -1, uformat.N) for k, _r in self.pool]

    def sign(self, body: bytes, d: int) -> Tuple[int, int]:
        z = uformat.digest_int(body)
        j = z % len(self.pool)
        r = self.pool[j][1]
        return r, self.kinv[j] * (z + r * d) % uformat.N


def _block(height: int, prev: str, miner: Key, txs: List[bytes],
           difficulty: Decimal, ts: int, nonce: Optional[int], device,
           fees: int = 0, chunk: int = 1 << 22) -> Block:
    """A block over ``txs`` (no coinbase); ``nonce=None`` searches one."""
    merkle = uformat.merkle_root(txs)
    prefix = uformat.header_prefix(prev, miner.raw, merkle, ts, difficulty)
    if nonce is None:
        nonce = sha.mine(prefix, prev, difficulty, device, chunk)
    content = (prefix + nonce.to_bytes(4, "little")).hex()
    h = uformat.txid(bytes.fromhex(content))
    reward = uformat.block_reward(height) + fees
    coinbase = uformat.coinbase_tx(h, miner.raw, reward)
    return Block(height, h, content, miner.address, nonce, difficulty,
                 reward, ts, [coinbase] + txs)


@dataclass
class Solo:
    blocks: List[Block]
    miner: Key
    wallets: List[Key]
    signer: "Signer"
    slots: List[Tuple[str, int, int, int]]   # (txid, index, amount, wallet)


def solo_chain(seed: int, height: int, difficulty: Decimal, n_fan: int,
               per_fan: int, n_wallets: int) -> Solo:
    """Block 1 pays the miner; block 2 fans its coinbase out into
    ``n_fan`` outputs; block 3 splits each into ``per_fan`` outputs of
    the wallets (the spendable outputs of the wallets' traffic); the
    rest are coinbase-only."""
    rng = random.Random(seed)
    miner = keys(rng, 1)[0]
    wallets = keys(rng, n_wallets)
    signer = Signer(rng)
    prev, blocks = uformat.GENESIS_PREV_HASH, []
    base = BASE_TIME + rng.randrange(1 << 20) * 60
    slots: List[Tuple[str, int, int, int]] = []
    for h in range(1, height + 1):
        txs = []
        if h == 2:
            reward = blocks[0].reward
            each = reward // n_fan
            body = uformat.tx_body(
                [(uformat.txid(blocks[0].txs[0]), 0)],
                [(miner.raw, each)] * (n_fan - 1)
                + [(miner.raw, reward - each * (n_fan - 1))])
            fan = uformat.tx_full(body, [signer.sign(body, miner.d)])
            txs = [fan]
        elif h == 3:
            fan = blocks[1].txs[1]
            fan_id = uformat.txid(fan)
            for i, (_a, amount) in enumerate(uformat.parse_tx(fan)["outputs"]):
                part = amount // per_fan
                outs = [(i * per_fan + j) % n_wallets for j in range(per_fan)]
                amounts = [part] * (per_fan - 1) + [amount - part * (per_fan - 1)]
                body = uformat.tx_body([(fan_id, i)], [
                    (wallets[w].raw, a) for w, a in zip(outs, amounts)])
                tx = uformat.tx_full(body, [signer.sign(body, miner.d)])
                txs.append(tx)
                tid = uformat.txid(tx)
                slots += [(tid, j, a, w)
                          for j, (w, a) in enumerate(zip(outs, amounts))]
        diff = uformat.START_DIFFICULTY if h <= 100 else difficulty
        b = _block(h, prev, miner, txs, diff, base + 60 * h,
                   rng.getrandbits(32) & 0x7FFFFFFF, None)
        blocks.append(b)
        prev = b.hash
    return Solo(blocks, miner, wallets, signer, slots)


def _spend(signer: Signer, key: Key, outpoint: Tuple[str, int],
           to: bytes, amount: int) -> bytes:
    body = uformat.tx_body([outpoint], [(to, amount)])
    return uformat.tx_full(body, [signer.sign(body, key.d)])


def rig_chain(seed: int, full_blocks: int, per_fan: int, n_fan: int,
              n_wallets: int, device, chunk: int = 1 << 22,
              difficulty: Decimal = uformat.START_DIFFICULTY
              ) -> Tuple[List[Block], int]:
    """The prefix (3 blocks) and ``full_blocks`` blocks of
    ``n_fan * per_fan`` transactions, mined at ``difficulty``.  Returns
    (blocks, prefix height)."""
    rng = random.Random(seed)
    miner, fan_key = keys(rng, 2)
    wallets = keys(rng, n_wallets)
    signer = Signer(rng)
    base = BASE_TIME + rng.randrange(1 << 20) * 60
    diff = Decimal(difficulty)
    blocks: List[Block] = []

    def add(txs, fees=0):
        prev = blocks[-1].hash if blocks else uformat.GENESIS_PREV_HASH
        h = len(blocks) + 1
        blocks.append(_block(h, prev, miner if h > 1 else fan_key, txs, diff,
                             base + 60 * h, None, device, fees, chunk))

    add([])                                    # block 1 pays the fan key
    reward = blocks[0].reward
    each = reward // n_fan
    body = uformat.tx_body(
        [(uformat.txid(blocks[0].txs[0]), 0)],
        [(fan_key.raw, each)] * (n_fan - 1)
        + [(fan_key.raw, reward - each * (n_fan - 1))])
    fan = uformat.tx_full(body, [signer.sign(body, fan_key.d)])
    add([fan])
    fan_id = uformat.txid(fan)
    # level 0: 255 transactions of per_fan outputs; slot s's wallet is
    # wallets[(s + level) % n_wallets], so each block changes hands
    mids, slots = [], []
    for i in range(n_fan):
        amount = each if i < n_fan - 1 else reward - each * (n_fan - 1)
        part = amount // per_fan
        outs = []
        for j in range(per_fan):
            s = i * per_fan + j
            outs.append((wallets[s % n_wallets].raw,
                         part if j < per_fan - 1 else amount - part * (per_fan - 1)))
        body = uformat.tx_body([(fan_id, i)], outs)
        tx = uformat.tx_full(body, [signer.sign(body, fan_key.d)])
        mids.append(tx)
        tid = uformat.txid(tx)
        slots += [(tid, j, amt) for j, (_a, amt) in enumerate(outs)]
    add(mids)
    prefix = len(blocks)
    for level in range(1, full_blocks + 1):
        txs, nxt = [], []
        for s, (tid, idx, amount) in enumerate(slots):
            owner = wallets[(s + level - 1) % n_wallets]
            to = wallets[(s + level) % n_wallets]
            tx = _spend(signer, owner, (tid, idx), to.raw, amount)
            txs.append(tx)
            nxt.append((uformat.txid(tx), 0, amount))
        add(txs)
        slots = nxt
    return blocks, prefix


# --- the node's chain file ----------------------------------------------

SCHEMA = """
CREATE TABLE IF NOT EXISTS blocks (
    id INTEGER PRIMARY KEY, hash TEXT UNIQUE NOT NULL, content TEXT NOT NULL,
    address TEXT NOT NULL, random INTEGER NOT NULL, difficulty TEXT NOT NULL,
    reward INTEGER NOT NULL, timestamp INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS transactions (
    block_hash TEXT NOT NULL, tx_hash TEXT UNIQUE NOT NULL,
    tx_hex TEXT NOT NULL, inputs_addresses TEXT NOT NULL,
    outputs_addresses TEXT NOT NULL, outputs_amounts TEXT NOT NULL,
    fees INTEGER NOT NULL);
CREATE INDEX IF NOT EXISTS tx_block_hash_idx ON transactions (block_hash);
CREATE TABLE IF NOT EXISTS unspent_outputs (
    tx_hash TEXT NOT NULL, idx INTEGER NOT NULL, address TEXT,
    amount INTEGER NOT NULL, is_stake INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (tx_hash, idx));
CREATE INDEX IF NOT EXISTS unspent_address_idx ON unspent_outputs (address);
"""


def write_db(path: Path, blocks: List[Block]) -> None:
    """The blocks, their transactions and the UTXO set they leave, in the
    reference's schema (the node creates its other tables itself)."""
    path.unlink(missing_ok=True)
    db = sqlite3.connect(path)
    db.executescript(SCHEMA)
    owner: Dict[Tuple[str, int], Tuple[str, int]] = {}
    for b in blocks:
        db.execute("INSERT INTO blocks VALUES (?,?,?,?,?,?,?,?)",
                   (b.height, b.hash, b.content, b.address, b.nonce,
                    str(b.difficulty), b.reward, b.timestamp))
        rows = []
        for raw in b.txs:
            tx = uformat.parse_tx(raw)
            tid = uformat.txid(raw)
            spent = [] if tx["coinbase"] else [owner.pop(i) for i in tx["inputs"]]
            outs = [(uformat.b58encode(a), amt) for a, amt in tx["outputs"]]
            for i, o in enumerate(outs):
                owner[(tid, i)] = o
            fees = 0 if tx["coinbase"] else sum(a for _o, a in spent) - sum(
                a for _o, a in outs)
            rows.append((b.hash, tid, raw.hex(),
                         json.dumps([o for o, _a in spent]),
                         json.dumps([o for o, _a in outs]),
                         json.dumps([a for _o, a in outs]), fees))
        db.executemany("INSERT INTO transactions VALUES (?,?,?,?,?,?,?)", rows)
    db.executemany("INSERT INTO unspent_outputs VALUES (?,?,?,?,0)",
                   [(h, i, a, amt) for (h, i), (a, amt) in owner.items()])
    db.commit()
    db.close()
