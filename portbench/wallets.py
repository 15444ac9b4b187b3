"""Wallets sending ``push_tx`` to a node in an open loop.

The schedule is made from the seed in set-up: one-input, one-output
transactions, each spending a distinct output of the chain's fan-out
and paying another wallet, due at Poisson arrivals of the mix's rate.
A share of them is invalid: half carry a changed signature, half spend
again the input of a transaction due at least ``double_spend_gap_s``
earlier.  Senders on at most ``connections`` open connections send each
request when it is due, and each is timed from when it was due, so a
stall delays the requests behind it; how late the senders ran is kept
beside.
"""

from __future__ import annotations

import http.client
import json
import math
import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from . import uformat
from .chain import Solo
from .reference import Check

ACCEPTED = "Transaction has been accepted"
NOT_ADDED = "Transaction has not been added"


@dataclass
class Request:
    due: float                   # seconds after the schedule's start
    tx_hex: str
    kind: str                    # "valid", "bad_signature", "double_spend"
    outpoint: tuple
    sent: Optional[float] = None  # monotonic
    done: Optional[float] = None
    reply: Optional[dict] = None
    wallet: int = 0
    amount: int = 0


def schedule(solo: Solo, mix: dict, seconds: float, seed: int) -> List[Request]:
    rng = random.Random(seed ^ 0x5EED)
    rate = float(mix["rate"])
    t, out = 0.0, []
    slots = list(solo.slots)
    rng.shuffle(slots)
    spent: List[Request] = []
    while True:
        t += rng.expovariate(rate)
        if t >= seconds:
            break
        roll = rng.random()
        kind = ("bad_signature" if roll < mix["bad_signature"] else
                "double_spend" if roll < mix["bad_signature"] + mix["double_spend"]
                else "valid")
        older = [r for r in spent[-4096:] if r.due <= t - mix["double_spend_gap_s"]]
        if kind == "double_spend" and not older:
            kind = "valid"
        if kind == "double_spend":
            first = rng.choice(older)
            (tid, idx), w = first.outpoint, first.wallet
            amount = first.amount
        else:
            if not slots:
                raise ValueError("the chain has too few outputs for this mix")
            tid, idx, amount, w = slots.pop()
        owner = solo.wallets[w]
        to = solo.wallets[rng.randrange(len(solo.wallets))]
        # a double spend leaves a fee of one unit, so it is always
        # another transaction than the one it conflicts with
        pay = amount - 1 if kind == "double_spend" else amount
        body = uformat.tx_body([(tid, idx)], [(to.raw, pay)])
        r, s = solo.signer.sign(body, owner.d)
        if kind == "bad_signature":
            s = (s + 1) % uformat.N
        req = Request(t, uformat.tx_full(body, [(r, s)]).hex(), kind,
                      (tid, idx), wallet=w, amount=amount)
        out.append(req)
        if kind == "valid":
            spent.append(req)
    return out


class Sender:
    """Open-loop senders: ``connections`` threads, each with one kept
    connection, take the requests in due order and send each when due."""

    def __init__(self, url: str, requests: List[Request], connections: int):
        host, port = url.split("//")[1].strip("/").split(":")
        self.addr = (host, int(port))
        self.requests = requests
        self.todo: "queue.Queue[Optional[Request]]" = queue.Queue()
        self.threads = [threading.Thread(target=self._work, daemon=True)
                        for _ in range(connections)]
        self.start_at = 0.0
        self.stop_at = math.inf

    def start(self, start_at: float, stop_at: float) -> None:
        self.start_at, self.stop_at = start_at, stop_at
        for r in self.requests:
            self.todo.put(r)
        for _ in self.threads:
            self.todo.put(None)
        for th in self.threads:
            th.start()

    def _work(self) -> None:
        conn = None
        while True:
            req = self.todo.get()
            if req is None:
                break
            due = self.start_at + req.due
            if due > self.stop_at:
                continue
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            body = json.dumps({"tx_hex": req.tx_hex})
            req.sent = time.monotonic()
            for attempt in range(2):
                try:
                    if conn is None:
                        conn = http.client.HTTPConnection(*self.addr, timeout=120)
                    conn.request("POST", "/push_tx", body,
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    req.reply = json.loads(resp.read() or b"{}")
                    req.done = time.monotonic()
                    if resp.getheader("Connection", "").lower() == "close":
                        conn.close()
                        conn = None
                    break
                except (OSError, http.client.HTTPException, ValueError):
                    if conn is not None:
                        conn.close()
                    conn = None
        if conn is not None:
            conn.close()

    def join(self, deadline: float) -> None:
        for th in self.threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))


def pool_at(requests: List[Request], start: float, end: float,
            mined: Set[str]) -> Tuple[List[str], List[str]]:
    """The node's pool as a fetch between ``start`` and ``end`` (the
    monotonic clock) could have read it: the transactions admitted (their
    reply came) before the fetch began, and those in flight (sent before
    it ended, with no refusal and no reply before it began), less those
    already mined."""
    certain, in_flight = [], []
    for r in requests:
        if r.sent is None or r.sent > end or r.tx_hex in mined:
            continue
        if r.reply is not None and not r.reply.get("ok"):
            continue
        if r.done is not None and r.done < start:
            certain.append(r.tx_hex)
        else:
            in_flight.append(r.tx_hex)
    return certain, in_flight


def latencies(requests: List[Request], start_at: float, t0: float,
              t1: float) -> List[float]:
    """Seconds from due to reply of every request due in [t0, t1]; one
    whose reply never came counts as infinitely late."""
    out = []
    for r in requests:
        due = start_at + r.due
        if t0 <= due <= t1:
            out.append(r.done - due if r.done is not None else math.inf)
    return out


def p95(values: List[float]) -> Optional[float]:
    """The 95th percentile by rank (the value with 95 % of the others at
    or below it), over all values, infinite ones included."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, math.ceil(0.95 * len(ordered)) - 1)]


def judge(requests: List[Request], start_at: float, t1: float,
          checks: Dict[str, Check]) -> None:
    """Every reply against the reference's verdict: a valid transaction
    is accepted, a changed signature is not added, and of a transaction
    and its double spend exactly one is accepted; the refused one gets
    the reference's string.  A request due in the window with no reply
    is missing."""
    for name in ("verdict_mismatches", "missing_replies"):
        checks.setdefault(name, Check(name, 0))
    claims: Dict[tuple, List[Request]] = {}
    for r in requests:
        if r.sent is None:
            continue
        if r.reply is None:
            if start_at + r.due <= t1:
                checks["missing_replies"].add(f"{r.kind} due at {r.due:.3f}")
            continue
        ok = bool(r.reply.get("ok"))
        if r.kind == "bad_signature":
            if ok or r.reply.get("error") != NOT_ADDED:
                checks["verdict_mismatches"].add(f"bad signature: {r.reply}")
            continue
        if ok and r.reply.get("result") != ACCEPTED:
            checks["verdict_mismatches"].add(f"accepted as {r.reply}")
        if not ok and r.reply.get("error") != NOT_ADDED:
            checks["verdict_mismatches"].add(f"refused as {r.reply}")
        claims.setdefault(r.outpoint, []).append(r)
    for outpoint, reqs in claims.items():
        accepted = [r for r in reqs if r.reply.get("ok")]
        if len(accepted) != 1:
            checks["verdict_mismatches"].add(
                f"{len(accepted)} of {len(reqs)} spends of {outpoint[0][:12]}"
                f":{outpoint[1]} accepted")


def lateness(requests: List[Request], start_at: float) -> dict:
    """How late the senders sent: the median, the 95th percentile and the
    most, in ms, over every request sent."""
    late = sorted(r.sent - (start_at + r.due) for r in requests
                  if r.sent is not None)
    if not late:
        return {}
    return {"n": len(late), "p50_ms": 1000 * late[len(late) // 2],
            "p95_ms": 1000 * p95(late), "max_ms": 1000 * late[-1]}
