"""The simulated network plane: per-link policy, partitions, faults (the
port's copy of the JAX package's ``swarm/links.py``: the same per-link,
per-seed draws).

Every loopback RPC (and WS frame, when a scenario wires one through)
pays a :meth:`LinkMatrix.transfer` toll on its ordered (src, dst) link:

1. the ``swarm.link`` fault site fires (``resilience/faultinject.py``), so
   any installed spec — ``swarm.link:error:p=0.3`` — can kill traffic
   exactly like the rpc.* sites kill real HTTP;
2. a partition or isolation check — blocked links raise
   :class:`LinkDown`;
3. a seeded per-link drop draw — dropped links also raise LinkDown;
4. a latency + jitter sleep.

:class:`LinkDown` subclasses ``ConnectionError`` deliberately: it lands
inside ``peers.TRANSIENT_ERRORS``, so the caller's retry policy runs
and its circuit breaker records the failure — a partitioned peer looks
to the node EXACTLY like a dead TCP endpoint.

Determinism: each ordered link owns a ``random.Random`` seeded from
(master seed, src, dst), so drop/jitter draws depend only on that
link's own call sequence, never on cross-link interleaving.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .. import telemetry
from ..resilience import faultinject


class LinkDown(ConnectionError):
    """A blocked/dropped link — transient to the caller's retry stack."""

    def __init__(self, src: str, dst: str, reason: str):
        super().__init__(f"link {src} -> {dst} {reason}")
        self.src, self.dst, self.reason = src, dst, reason


@dataclass
class LinkPolicy:
    """Per-link shaping; the fast-matrix default is a perfect wire."""

    latency: float = 0.0   # one-way seconds added per transfer
    jitter: float = 0.0    # uniform extra [0, jitter) seconds
    drop: float = 0.0      # probability a transfer raises LinkDown


class LinkMatrix:
    """Ordered-pair link table with partition groups and counters."""

    def __init__(self, seed: int = 0, default: Optional[LinkPolicy] = None):
        self.seed = seed
        self.default = default or LinkPolicy()
        self._policies: Dict[Tuple[str, str], LinkPolicy] = {}
        self._rngs: Dict[Tuple[str, str], random.Random] = {}
        self._known: Set[str] = set()
        self._groups: Dict[str, int] = {}   # url -> partition group
        self._isolated: Set[str] = set()
        self.delivered = 0
        self.dropped = 0
        self.blocked = 0
        self.per_link: Dict[str, Dict[str, int]] = {}

    # ------------------------------------------------------------- setup --
    def register(self, url: str) -> None:
        """Only registered endpoints pay link tolls: the scenario driver
        (an unregistered 'client') must always reach every node."""
        self._known.add(url)

    def set_link(self, src: str, dst: str, policy: LinkPolicy,
                 symmetric: bool = True) -> None:
        self._policies[(src, dst)] = policy
        if symmetric:
            self._policies[(dst, src)] = policy

    def _rng(self, src: str, dst: str) -> random.Random:
        key = (src, dst)
        rng = self._rngs.get(key)
        if rng is None:
            digest = hashlib.sha256(
                f"{self.seed}:{src}->{dst}".encode()).digest()
            rng = random.Random(int.from_bytes(digest[:8], "big"))
            self._rngs[key] = rng
        return rng

    # -------------------------------------------------------- partitions --
    def partition(self, groups: Iterable[Iterable[str]]) -> None:
        """Split the swarm: traffic crossing group boundaries is blocked.
        Unlisted endpoints keep full connectivity to every group."""
        self._groups = {}
        for gid, members in enumerate(groups):
            for url in members:
                self._groups[url] = gid
        telemetry.event("swarm_partition",
                        groups=len(set(self._groups.values())),
                        members=len(self._groups))

    def heal(self) -> None:
        self._groups = {}
        self._isolated.clear()
        telemetry.event("swarm_heal")

    def isolate(self, url: str) -> None:
        """Cut every link touching ``url`` (eclipse victim / dead node)."""
        self._isolated.add(url)
        telemetry.event("swarm_isolate", url=url)

    def restore(self, url: str) -> None:
        self._isolated.discard(url)

    def _crosses_partition(self, src: str, dst: str) -> bool:
        if src in self._isolated or dst in self._isolated:
            return True
        if not self._groups:
            return False
        gsrc, gdst = self._groups.get(src), self._groups.get(dst)
        return gsrc is not None and gdst is not None and gsrc != gdst

    # ---------------------------------------------------------- transfer --
    def _count(self, src: str, dst: str, outcome: str) -> None:
        setattr(self, outcome, getattr(self, outcome) + 1)
        row = self.per_link.setdefault(f"{src}->{dst}", {
            "delivered": 0, "dropped": 0, "blocked": 0})
        row[outcome] += 1

    async def transfer(self, src: str, dst: str) -> None:
        """One message crossing the (src, dst) link; raises LinkDown or
        sleeps out the link latency.  Unregistered endpoints (the
        scenario driver) bypass shaping entirely."""
        if src not in self._known or dst not in self._known:
            return
        injector = faultinject.get_injector()
        if injector is not None:
            await injector.fire("swarm.link", f"{src}->{dst}")
        if self._crosses_partition(src, dst):
            self._count(src, dst, "blocked")
            raise LinkDown(src, dst, "partitioned")
        policy = self._policies.get((src, dst), self.default)
        if policy.drop > 0 and self._rng(src, dst).random() < policy.drop:
            self._count(src, dst, "dropped")
            raise LinkDown(src, dst, "dropped")
        delay = policy.latency
        if policy.jitter > 0:
            delay += self._rng(src, dst).random() * policy.jitter
        if delay > 0:
            await asyncio.sleep(delay)
        self._count(src, dst, "delivered")

    # ------------------------------------------------------------- views --
    def stats(self) -> dict:
        return {"delivered": self.delivered, "dropped": self.dropped,
                "blocked": self.blocked,
                "links_used": len(self.per_link)}

    def partitioned_pairs(self) -> List[str]:
        return sorted(
            f"{a}->{b}" for a in self._known for b in self._known
            if a != b and self._crosses_partition(a, b))
