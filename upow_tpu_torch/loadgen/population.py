"""Seeded wallet-population request schedules (stdlib only).

A population is a set of actor streams, each with its own derived RNG
so the merged schedule is a pure function of the spec:

* **readers** — wallet clients polling balances / UTXO sets / history
  for Zipf-distributed addresses (a few hot accounts absorb most
  reads, the long tail the rest — the shape real explorers see).
* **miners** — ``get_mining_info`` template polling.
* **pushers** — bursts of simultaneous ``push_tx`` submissions, sized
  to exercise the mempool intake's micro-batch coalescing.
* **ws subscribers** — connect / subscribe / ping / close churn
  against the ``/ws`` hub.

Events carry abstract indices (``wallet``, ``payload``, ``conn``) —
the executor (mock or real-node harness) maps them to addresses, tx
payloads and sockets.  Same seed → byte-identical schedule; the
determinism test pins this.
"""

from __future__ import annotations

import bisect
import random
from dataclasses import dataclass, fields
from typing import Dict, List, Tuple

#: event kind -> HTTP endpoint (ws kinds map to the pseudo-endpoint
#: "ws"; summaries group by this name)
ENDPOINTS = {
    "balance": "/get_address_info",
    "utxo": "/get_address_info",
    "history": "/get_address_transactions",
    "mining_info": "/get_mining_info",
    "push_tx": "/push_tx",
    "ws_connect": "ws",
    "ws_ping": "ws",
    "ws_close": "ws",
}


@dataclass(frozen=True)
class LoadEvent:
    at: float                 # virtual seconds from schedule start
    seq: int                  # stable identity / sort tiebreak
    kind: str
    params: Tuple[Tuple[str, object], ...] = ()

    @property
    def endpoint(self) -> str:
        return ENDPOINTS[self.kind]

    def param(self, name: str, default=None):
        for k, v in self.params:
            if k == name:
                return v
        return default


@dataclass
class PopulationSpec:
    """Knobs for one synthetic wallet population."""

    seed: int = 0xC0FFEE
    duration: float = 2.0      # virtual schedule length (seconds)
    n_wallets: int = 256       # address universe the readers draw from
    zipf_s: float = 1.1        # skew: ~1 mild, 2 one-account-dominates
    n_readers: int = 8
    reader_rps: float = 25.0   # per-reader mean poll rate
    n_miners: int = 2
    miner_rps: float = 10.0
    n_ws: int = 4              # websocket subscribers
    ws_churn: int = 2          # connect/close cycles per subscriber
    push_bursts: int = 4
    burst_size: int = 16       # concurrent push_tx per burst

    @classmethod
    def smoke(cls, seed: int = 0xC0FFEE) -> "PopulationSpec":
        """Tiny population for CI: finishes in a few seconds on CPU."""
        return cls(seed=seed, duration=1.0, n_wallets=32, n_readers=3,
                   reader_rps=12.0, n_miners=1, miner_rps=6.0, n_ws=2,
                   ws_churn=1, push_bursts=2, burst_size=8)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


def zipf_cdf(n: int, s: float) -> List[float]:
    """Cumulative distribution of Zipf(s) over ranks 1..n."""
    weights = [1.0 / (rank ** s) for rank in range(1, n + 1)]
    total = sum(weights)
    cdf, acc = [], 0.0
    for w in weights:
        acc += w / total
        cdf.append(acc)
    cdf[-1] = 1.0
    return cdf


def pick_zipf(rng: random.Random, cdf: List[float]) -> int:
    """Rank index (0 = hottest) drawn from a precomputed CDF."""
    return bisect.bisect_left(cdf, rng.random())


def _rng(spec: PopulationSpec, stream: str, idx: int) -> random.Random:
    # one independent RNG per actor stream: inserting a new stream
    # cannot shift the draws of existing ones
    return random.Random(f"{spec.seed}:{stream}:{idx}")


def build_schedule(spec: PopulationSpec) -> List[LoadEvent]:
    """Merged, time-sorted event list for the population."""
    raw: List[Tuple[float, str, Tuple[Tuple[str, object], ...]]] = []
    cdf = zipf_cdf(spec.n_wallets, spec.zipf_s)

    for r in range(spec.n_readers):
        rng = _rng(spec, "reader", r)
        t = rng.random() / max(spec.reader_rps, 1e-9)
        while t < spec.duration:
            roll = rng.random()
            kind = ("balance" if roll < 0.6
                    else "utxo" if roll < 0.85 else "history")
            raw.append((t, kind, (("wallet", pick_zipf(rng, cdf)),)))
            t += rng.expovariate(spec.reader_rps)

    for m in range(spec.n_miners):
        rng = _rng(spec, "miner", m)
        t = rng.random() / max(spec.miner_rps, 1e-9)
        while t < spec.duration:
            raw.append((t, "mining_info", ()))
            t += rng.expovariate(spec.miner_rps)

    payload = 0
    for b in range(spec.push_bursts):
        # bursts land simultaneously (identical timestamp) so the
        # runner fires the whole burst concurrently — that simultaneity
        # is what drives the intake's micro-batch coalescing
        at = spec.duration * (b + 1) / (spec.push_bursts + 1)
        for _ in range(spec.burst_size):
            raw.append((at, "push_tx", (("payload", payload),)))
            payload += 1

    for w in range(spec.n_ws):
        rng = _rng(spec, "ws", w)
        cycle = spec.duration / max(spec.ws_churn, 1)
        for c in range(spec.ws_churn):
            conn = f"{w}.{c}"
            start = c * cycle + rng.random() * cycle * 0.2
            raw.append((start, "ws_connect", (("conn", conn),)))
            raw.append((start + cycle * 0.5, "ws_ping", (("conn", conn),)))
            raw.append((start + cycle * 0.8, "ws_close", (("conn", conn),)))

    raw.sort(key=lambda e: (e[0], e[1], e[2]))
    return [LoadEvent(at=round(at, 6), seq=i, kind=kind, params=params)
            for i, (at, kind, params) in enumerate(raw)]


def schedule_fingerprint(events: List[LoadEvent]) -> str:
    """Stable digest of a schedule (determinism tests / provenance)."""
    import hashlib

    h = hashlib.sha256()
    for ev in events:
        h.update(repr((ev.at, ev.seq, ev.kind, ev.params)).encode())
    return h.hexdigest()


def wallet_universe(spec: PopulationSpec) -> Dict[int, int]:
    """How many distinct key indices the harness must back: wallet
    ranks map onto ``min(n_wallets, 48)`` real keypairs (rank modulo),
    keeping fixture setup cheap while preserving the hot/cold split."""
    n_keys = min(spec.n_wallets, 48)
    return {rank: rank % n_keys for rank in range(spec.n_wallets)}
