"""The miner's printed lines as templates, rounds and hashes.

The miner has no hash counter, so the count is read from what it prints
(``upow_tpu_torch/mine/miner.py``): the shim's ``portbench-template``
line with the fetch's times (and, on the card's path,
``portbench-target``), then ``difficulty: D  block: N  confirming K
transactions``, one ``R MH/s (H hashes)`` line after each round with the
template's running total H, and at the end ``template expired after H
hashes`` or ``found nonce X at R MH/s`` followed by the node's reply to
the push.  After the window the shim prints ``portbench-modules``, one
``portbench-recheck`` line a round it mined again, and
``portbench-closed``.

A round is the template's header prefix and its first nonce.  The v2
header has no extra nonce and its timestamp moves once a second, so a
template swept in less than a second can repeat the last one's header:
its rounds are the same hashes again and win nothing.  The rate counts
each round once, the first time it was mined.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from decimal import Decimal
from typing import Dict, List, Optional, Tuple

_INFO = re.compile(r"^difficulty: (\S+)\s+block: (\d+)\s+confirming (\d+) transactions")
_PROGRESS = re.compile(r"^[\d.]+ MH/s \((\d+) hashes\)$")
_EXPIRED = re.compile(r"^template expired after (\d+) hashes")
_FOUND = re.compile(r"^found nonce (\d+) at")


@dataclass
class Template:
    t: float                       # when its prefix line arrived
    prefix: bytes
    difficulty: Optional[Decimal] = None
    block_no: Optional[int] = None
    pending: Optional[int] = None
    done: int = 0                  # hashes of its printed rounds
    expired_after: Optional[int] = None
    nonce: Optional[int] = None
    reply: Optional[dict] = None
    target: Optional[Tuple[int, ...]] = None   # what the kernel was handed
    fetch: Optional[Tuple[float, float]] = None  # its get_mining_info


@dataclass
class MinerLog:
    templates: List[Template]
    errors: List[Tuple[float, str]]
    # (time, hashes finished, the round: header prefix and first nonce)
    hash_events: List[Tuple[float, int, Tuple[bytes, int]]]
    modules: Optional[List[str]] = None    # forbidden, at the window's close
    rechecks: Dict[int, str] = field(default_factory=dict)
    closed: bool = False


def parse(lines: List[Tuple[float, str]], batch: int) -> MinerLog:
    templates: List[Template] = []
    errors: List[Tuple[float, str]] = []
    events: List[Tuple[float, int, Tuple[bytes, int]]] = []
    cur: Optional[Template] = None
    log = MinerLog(templates, errors, events)
    for t, line in lines:
        if line.startswith("portbench-template "):
            parts = line.split()
            cur = Template(t, bytes.fromhex(parts[1]))
            if len(parts) == 4:
                cur.fetch = (float(parts[2]), float(parts[3]))
            templates.append(cur)
            continue
        if line.startswith("portbench-modules "):
            log.modules = json.loads(line.split(" ", 1)[1])
            continue
        if line.startswith("portbench-recheck "):
            _, i, answer = line.split(" ", 2)
            log.rechecks[int(i)] = answer
            continue
        if line == "portbench-closed":
            log.closed = True
            continue
        if line.startswith(("node unreachable", "push_block failed")):
            errors.append((t, line))
            continue
        if cur is None:
            continue
        if line.startswith("portbench-target "):
            cur.target = tuple(int(v) for v in line.split()[1:])
            continue
        m = _INFO.match(line)
        if m:
            cur.difficulty = Decimal(m.group(1))
            cur.block_no, cur.pending = int(m.group(2)), int(m.group(3))
            continue
        m = _PROGRESS.match(line)
        if m:
            done = int(m.group(1))
            events.append((t, done - cur.done, (cur.prefix, cur.done)))
            cur.done = done
            continue
        m = _EXPIRED.match(line)
        if m:
            cur.expired_after = int(m.group(1))
            continue
        m = _FOUND.match(line)
        if m:
            # the round that hit was counted but never printed
            cur.nonce = int(m.group(1))
            events.append((t, batch, (cur.prefix, cur.done)))
            continue
        if line.startswith("{") and cur.nonce is not None and cur.reply is None:
            try:
                cur.reply = ast.literal_eval(line)
            except (ValueError, SyntaxError):
                pass
    return log


def hashes_between(log: MinerLog, t0: float, t1: float) -> int:
    """The hashes of the rounds finished in (t0, t1] that no earlier
    round of the run had mined."""
    seen, total = set(), 0
    for t, n, key in log.hash_events:
        if key not in seen and t0 < t <= t1:
            total += n
        seen.add(key)
    return total


def claimed_rounds(tpl: Template, batch: int) -> List[Tuple[int, int, Optional[int]]]:
    """(start, count, the miner's answer) for each round the template's
    lines vouch for: every round of an expired sweep answered no hit;
    a found nonce answers its own round, and no hit in each before it."""
    if tpl.nonce is not None:
        done = (tpl.nonce // batch) * batch
        rounds = [(s, batch, None) for s in range(0, done, batch)]
        end = min(done + batch, 0xFFFFFFFF)
        return rounds + [(done, end - done, tpl.nonce)]
    if tpl.expired_after is None:
        return []
    out, s = [], 0
    while s < tpl.expired_after:
        n = min(batch, tpl.expired_after - s)
        out.append((s, n, None))
        s += n
    return out
