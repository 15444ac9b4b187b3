"""The plain reference that decides ``correct``.

It imports nothing of the program and takes nothing the program made:
it works from the generated chain, the miner's printed lines and the
node's replies, and recomputes what each should have been.
"""

from __future__ import annotations

import hashlib
import random
from decimal import Decimal
from itertools import combinations
from math import ceil, log
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from . import minerlog, sha, uformat

BLOCK_TIME = 60
BLOCKS_COUNT = 100


def _to_difficulty(hashrate) -> Decimal:
    """manager.py:67-80."""
    difficulty = int(log(hashrate, 16))
    ratio = hashrate / 16 ** difficulty
    for i in range(10):
        coeff = 16 / ceil(16 * (1 - i / 10))
        if coeff > ratio:
            return Decimal(difficulty) + (i - 1) / Decimal(10)
        if coeff == ratio:
            return Decimal(difficulty) + i / Decimal(10)
    return Decimal(difficulty) + Decimal("0.9")


def _to_hashrate(difficulty: Decimal) -> Decimal:
    """manager.py:44-46."""
    frac = difficulty % 1
    return Decimal(16 ** int(difficulty) * (16 / ceil(16 * (1 - frac))))


def next_difficulty(tip: Optional[dict], window_start_ts: Optional[int]) -> Decimal:
    """The difficulty of the block after ``tip`` (manager.py:83-121):
    the start difficulty below height 100, the tip's own between
    retargets, and at each hundredth block the retarget."""
    if tip is None or tip["id"] < BLOCKS_COUNT:
        return uformat.START_DIFFICULTY
    if tip["id"] % BLOCKS_COUNT:
        return Decimal(str(tip["difficulty"]))
    per_block = (tip["timestamp"] - window_start_ts) / BLOCKS_COUNT
    ratio = BLOCK_TIME / per_block
    if tip["id"] >= 180_000:
        ratio = min(ratio, 2)
    new = _to_difficulty(_to_hashrate(Decimal(str(tip["difficulty"]))) * Decimal(ratio))
    if new < uformat.START_DIFFICULTY and tip["id"] >= 590_600:
        return uformat.START_DIFFICULTY
    return new


class Check:
    """One number compared with its limit."""

    def __init__(self, name: str, limit: float):
        self.name, self.limit, self.value = name, limit, 0
        self.notes: List[str] = []

    def add(self, note: str) -> None:
        self.value += 1
        if len(self.notes) < 5:
            self.notes.append(note)

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


#: a pool with more transactions in flight at a template's fetch than
#: this leaves that template's merkle root unjudged (2^14 subsets)
MAX_IN_FLIGHT = 14


def recheck_difficulty(batch: int) -> Decimal:
    """The difficulty at which a round of ``batch`` nonces holds about
    two hits: ``k`` digits of prefix and a charset of 2, where ``16^(k+1)``
    is the round (5.9 for 2^24, 4.9 for 2^20).  The round's least hit
    then lies anywhere in it, so a search that leaves part of the round
    out answers wrong in about a round in four."""
    k = max(1, (batch.bit_length() - 1) // 4 - 1)
    return Decimal(k) + Decimal("0.9")


def plan_rechecks(log: minerlog.MinerLog, t0: float, t1: float, batch: int,
                  n: int, seed: int) -> dict:
    """The rounds the miner mines again once the window has closed: a
    seeded sample of ``n`` distinct rounds of the window's templates
    (header prefix, previous hash, start, count), at
    :func:`recheck_difficulty`."""
    rounds = {}
    for tpl in log.templates:
        if not t0 <= tpl.t <= t1:
            continue
        prev = uformat.split_header(tpl.prefix.hex() + "00" * 4)["prev"]
        for start, count, _answer in minerlog.claimed_rounds(tpl, batch):
            rounds.setdefault((tpl.prefix.hex(), start),
                              [tpl.prefix.hex(), prev, start, count])
    keys = sorted(rounds)
    picked = random.Random(seed).sample(keys, min(n, len(keys)))
    return {"difficulty": str(recheck_difficulty(batch)),
            "rounds": [rounds[k] for k in sorted(picked)]}


def judge_rechecks(plan: dict, answers: Dict[int, str], device,
                   checks: Dict[str, Check]) -> None:
    """Each round mined again after the window against the reference's
    least nonce at the plan's difficulty; a round the miner did not
    answer counts as wrong."""
    checks.setdefault("recheck_mismatches", Check("recheck_mismatches", 0))
    diff = Decimal(plan["difficulty"])
    for i, (prefix, prev, start, count) in enumerate(plan["rounds"]):
        got = sha.search(bytes.fromhex(prefix), prev, diff, start, count,
                         device, chunk=1 << 21)
        want = "none" if got is None else str(got)
        if answers.get(i) != want:
            checks["recheck_mismatches"].add(
                f"round {start}+{count} at {diff}: miner {answers.get(i)}, "
                f"reference {want}")


def _pool_match(merkle: str, certain: List[str], in_flight: List[str]):
    """The set of the pool's transactions whose root is ``merkle``: all
    of ``certain`` and some of ``in_flight``; None where none is, and
    ``certain`` itself where too many are in flight to try."""
    if len(in_flight) > MAX_IN_FLIGHT:
        return certain, False
    for k in range(len(in_flight) + 1):
        for extra in combinations(in_flight, k):
            txs = sorted(certain + list(extra))
            if uformat.miner_merkle([hashlib.sha256(bytes.fromhex(t)).hexdigest()
                                     for t in txs]) == merkle:
                return txs, True
    return None, True


def judge_miner(log: minerlog.MinerLog, t0: float, t1: float,
                tip: dict, miner_address: str,
                pool: Optional[Callable[[minerlog.Template, Set[str]],
                                        Tuple[List[str], List[str]]]],
                final_tip: Optional[dict], batch: int, device,
                checks: Dict[str, Check], by_height: Dict[int, dict],
                difficulty: Optional[Decimal] = None,
                extend: bool = True) -> int:
    """Hold the miner's templates, rounds and pushes, and the node's
    verdicts, against the reference.  Returns the templates started in
    the window.

    ``tip`` is the chain's tip when the run began (id, hash, timestamp,
    difficulty) and ``by_height`` the chain's blocks.  ``pool`` gives,
    for a template and the transactions already mined, the node's pool
    at the template's fetch: the transactions certainly in it and those
    in flight (sent, not yet answered); None for a pool that stays
    empty.  A pool that sets the difficulty itself passes it as
    ``difficulty``; with ``extend`` false the tip does not move on an
    accepted block (the pool's chain is another's)."""
    for name in ("template_mismatches", "target_mismatches",
                 "push_mismatches", "round_mismatches", "tip_mismatches"):
        checks.setdefault(name, Check(name, 0))
    addr_raw = uformat.b58decode(miner_address)
    tip = dict(tip)
    mined: Set[str] = set()
    unjudged = 0
    for tpl in log.templates:
        window = by_height.get(tip["id"] - BLOCKS_COUNT + 1)
        diff = difficulty if difficulty is not None else next_difficulty(
            tip, window["timestamp"] if window else None)
        try:
            head = uformat.split_header(tpl.prefix.hex() + "00" * 4)
        except ValueError as e:
            checks["template_mismatches"].add(f"header: {e}")
            continue
        want = {"prev": tip["hash"], "address_raw": addr_raw,
                "difficulty": diff}
        for key, value in want.items():
            if head[key] != value:
                checks["template_mismatches"].add(
                    f"{key}: {head[key]!r} != {value!r}")
        certain, in_flight = pool(tpl, mined) if pool else ([], [])
        txs, judged = _pool_match(head["merkle"], certain, in_flight)
        unjudged += not judged
        if txs is None:
            checks["template_mismatches"].add(
                f"merkle {head['merkle']}: no set of the pool's "
                f"{len(certain)} + {len(in_flight)} in flight")
        if (tpl.difficulty, tpl.block_no) != (diff, tip["id"] + 1) or (
                judged and txs is not None and tpl.pending != len(txs)):
            checks["template_mismatches"].add(
                f"info {tpl.difficulty} {tpl.block_no} {tpl.pending}")
        if tpl.target is not None and \
                tpl.target != sha.target(tip["hash"], diff):
            checks["target_mismatches"].add(
                f"block {tip['id'] + 1}: kernel target {tpl.target} for "
                f"difficulty {diff}")
        if tpl.nonce is None:
            continue
        # the round that hit: its least nonce at the template's target
        start = (tpl.nonce // batch) * batch
        count = min(start + batch, sha.SENTINEL) - start
        got = sha.search(tpl.prefix, tip["hash"], diff, start, count, device)
        if got != tpl.nonce:
            checks["round_mismatches"].add(
                f"round {start}+{count}: miner {tpl.nonce}, reference {got}")
        content = tpl.prefix + tpl.nonce.to_bytes(4, "little")
        block_hash = hashlib.sha256(content).hexdigest()
        pow_ok = uformat.pow_ok(block_hash, tip["hash"], diff)
        # a block found in the tip's own second is refused by the rule
        # (manager.py's "timestamp younger than previous block")
        valid = (pow_ok and head["prev"] == tip["hash"]
                 and head["timestamp"] > tip["timestamp"])
        if tpl.reply is not None:
            accepted = bool(tpl.reply.get("ok"))
        else:  # the miner was stopped before the node's reply arrived
            accepted = bool(final_tip) and final_tip.get("hash") == block_hash
        if not pow_ok or accepted != valid:
            checks["push_mismatches"].add(
                f"block {tip['id'] + 1}: reference valid={valid}, node "
                f"reply {tpl.reply}")
        if accepted and extend:
            mined.update(txs if txs is not None else certain)
            tip = {"id": tip["id"] + 1, "hash": block_hash,
                   "timestamp": head["timestamp"], "difficulty": diff}
            by_height[tip["id"]] = tip
    if final_tip is None or final_tip.get("hash") != tip["hash"] \
            or final_tip.get("id") != tip["id"]:
        checks["tip_mismatches"].add(f"node tip {final_tip} != {tip}")
    if unjudged:
        checks["template_mismatches"].notes.append(
            f"{unjudged} templates' roots unjudged: over {MAX_IN_FLIGHT} "
            f"transactions in flight at their fetch")
    return sum(t0 <= tpl.t <= t1 for tpl in log.templates)


def judge_sync(blocks, prefix: int, c: dict, replies, tamper_at: int,
               served_tampered: Sequence[int], checks: Dict[str, Check]) -> int:
    """Hold node C's chain after its sync against the reference's replay
    of the blocks it committed: every block the generated one, every
    block's transactions by their hashlib txids, the UTXO set the replay
    leaves, the tampered block refused with the rule's error, and no
    honest block refused.  Returns the refusals of honest blocks."""
    for name in ("chain_mismatches", "txid_mismatches", "utxo_mismatches",
                 "tamper_mismatches", "honest_refusals"):
        checks.setdefault(name, Check(name, 0))
    height = max(c["blocks"], default=0)
    utxo: Dict[Tuple[str, int], tuple] = {}
    for b in blocks[:height]:
        if c["blocks"].get(b.height) != b.hash:
            checks["chain_mismatches"].add(
                f"block {b.height}: {c['blocks'].get(b.height)} != {b.hash}")
        ids = set()
        for raw in b.txs:
            tx = uformat.parse_tx(raw)
            tid = uformat.txid(raw)
            ids.add(tid)
            if not tx["coinbase"]:
                for outpoint in tx["inputs"]:
                    utxo.pop(outpoint, None)
            for i, (addr, amount) in enumerate(tx["outputs"]):
                utxo[(tid, i)] = (tid, i, uformat.b58encode(addr), amount)
        stored = c["txs"].get(b.hash, set())
        if b.height > prefix and stored != ids:
            checks["txid_mismatches"].add(
                f"block {b.height}: {len(stored ^ ids)} txids differ")
    differ = set(utxo.values()) ^ c["utxo"]
    if differ:
        checks["utxo_mismatches"].value += len(differ)
        checks["utxo_mismatches"].notes.append(f"{len(differ)} entries differ")
    # the tampered block: served once, refused with the rule's error
    first = replies[0][1] if replies else {}
    if tamper_at not in served_tampered or first.get("ok") or \
            first.get("error") != "signature verification failed":
        checks["tamper_mismatches"].add(f"first sync reply {first}")
    refusals = [r for _t, r in replies[1:] if not r.get("ok")]
    for r in refusals:
        checks["honest_refusals"].add(f"sync reply {r}")
    return len(refusals)
