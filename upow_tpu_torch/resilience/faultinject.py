"""Seeded, deterministic fault injection (the port's copy of the JAX
package's ``resilience/faultinject.py``).

A :class:`FaultInjector` holds rules parsed from a spec string
(``ResilienceConfig.faults`` or ``UPOW_RESILIENCE_FAULTS``)::

    site:kind[:k=v,...][;site:kind...]

    rpc:error:p=0.5,key=9001        every other RPC to a :9001 peer errors
    rpc.push_tx:latency:delay=0.2   every push_tx send stalls 200 ms
    rpc:hang:times=1,delay=30       one RPC hangs 30 s (deadline food)
    device.verify:error:times=3     the first three device verifies error

Sites are prefix-matched (``rpc`` matches ``rpc.get_blocks``) and
``key`` substring-filters the call's key (the peer URL).  ``kind`` is
``error`` (raise :class:`FaultInjected`), ``latency`` (sleep ``delay``,
then go on), ``hang`` (sleep ``delay``, by default far past any
deadline, then raise) or ``corrupt``, which only the sites that pass
payload bytes through :meth:`FaultInjector.fire_mutate` act on: the
payload comes back with one byte flipped, a peer serving damaged data
that only an integrity check can catch.  ``p`` draws
from one seeded ``random.Random``, so a fixed seed replays the exact
schedule; ``times`` caps how often a rule fires (-1: no cap).

Sites: ``rpc.<path>`` (``node/peers.py``, one per RPC attempt),
``device.verify`` (``verify/txverify.py``, inside the boxed device
dispatch, so a ``hang`` there is what the box absorbs),
``device.runtime`` (``device/runtime.py``, once per drained dispatch,
keyed ``sig:<sources>`` for a coalesced signature group or
``call:<kernel>`` for a call, so ``key=`` can pick one subsystem) and
``mempool.intake`` (``mempool/intake.py``, once per intake batch, keyed
by its size), ``snapshot.serve`` (``node/app.py``, once per
``/snapshot/manifest`` and ``/snapshot/chunk`` response, keyed
``manifest`` or ``chunk/<i>``; ``corrupt`` flips served chunk bytes) and
``snapshot.fetch`` (``node/peers.py``, once per snapshot RPC attempt of a
bootstrap, keyed ``<source url>#manifest`` or ``<source url>#chunk/<i>``),
``archive.compact`` (``archive/compactor.py``, at each phase of a cycle,
keyed ``closure``, ``segment/<lo>``, ``publish`` or ``prune``: an error
at ``prune`` is a kill between the archive commit and the hot delete),
``archive.fetch`` (``archive/reader.py`` ``fetch_archive``, keyed
``manifest`` or ``segment/<i>``; ``corrupt`` flips fetched segment
bytes) and ``swarm.link`` (``swarm/links.py``, once per simulated link
transfer, keyed ``<src>-><dst>``).  :meth:`FaultInjector.fire` is the event loop's injection
point and :meth:`FaultInjector.fire_sync` the thread's.
:func:`get_injector` is None unless :func:`install` ran with a
non-empty spec.
"""

from __future__ import annotations

import asyncio
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from .. import trace

log = logging.getLogger("upow_tpu_torch.faultinject")

KINDS = ("error", "latency", "hang", "corrupt")
_FLOW_KINDS = ("error", "latency", "hang")  # what fire() acts on
_HANG_DEFAULT = 3600.0  # beyond any deadline


class FaultInjected(ConnectionError):
    """An injected failure; a ConnectionError, so the retry and breaker
    layers treat it as a transport fault."""

    def __init__(self, site: str, key: str = ""):
        super().__init__(f"injected fault at {site}"
                         + (f" ({key})" if key else ""))
        self.site = site


@dataclass
class Fault:
    site: str                   # prefix match against the fire() site
    kind: str                   # error | latency | hang | corrupt
    p: float = 1.0              # fire probability per matching call
    times: int = -1             # max fires (-1 = unlimited)
    delay: float = 0.0          # latency/hang sleep (hang defaults 3600)
    key: str = ""               # substring filter on the per-call key
    fired: int = 0              # how often it has fired

    def matches(self, site: str, key: str) -> bool:
        if self.times >= 0 and self.fired >= self.times:
            return False
        if not (site == self.site or site.startswith(self.site + ".")):
            return False
        return self.key in key if self.key else True


def parse_spec(spec: str) -> List[Fault]:
    faults = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        bits = part.split(":", 2)
        if len(bits) < 2:
            raise ValueError(f"fault spec {part!r}: want site:kind[:k=v,..]")
        site, kind = bits[0], bits[1]
        if kind not in KINDS:
            raise ValueError(f"fault kind {kind!r} not in {KINDS}")
        kwargs: Dict[str, object] = {}
        if len(bits) == 3 and bits[2]:
            for pair in bits[2].split(","):
                name, _, raw = pair.partition("=")
                if name == "p":
                    kwargs["p"] = float(raw)
                elif name == "times":
                    kwargs["times"] = int(raw)
                elif name == "delay":
                    kwargs["delay"] = float(raw)
                elif name == "key":
                    kwargs["key"] = raw
                else:
                    raise ValueError(f"fault spec {part!r}: unknown "
                                     f"option {name!r}")
        fault = Fault(site=site, kind=kind, **kwargs)
        if fault.kind == "hang" and not fault.delay:
            fault.delay = _HANG_DEFAULT
        faults.append(fault)
    return faults


class FaultInjector:
    """Evaluates fault rules at named sites, deterministically."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.faults = parse_spec(spec)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def _pick(self, site: str, key: str,
              kinds=_FLOW_KINDS) -> Optional[Fault]:
        with self._lock:
            for fault in self.faults:
                if fault.kind not in kinds:
                    continue
                if fault.matches(site, key) and \
                        (fault.p >= 1.0 or self._rng.random() < fault.p):
                    fault.fired += 1
                    return fault
        return None

    async def fire(self, site: str, key: str = "") -> None:
        """Sleep and/or raise as the first matching rule says; nothing
        when no rule matches."""
        fault = self._pick(site, key)
        if fault is None:
            return
        self._count(fault, site, key)
        if fault.kind == "latency":
            await asyncio.sleep(fault.delay)
            return
        if fault.kind == "hang":
            await asyncio.sleep(fault.delay)
        raise FaultInjected(site, key)

    def fire_sync(self, site: str, key: str = "") -> None:
        """:meth:`fire` for a site on a thread (``device.verify`` runs in
        the boxed call's worker thread, where a hang is exactly what the
        box absorbs)."""
        fault = self._pick(site, key)
        if fault is None:
            return
        self._count(fault, site, key)
        if fault.kind == "latency":
            time.sleep(fault.delay)
            return
        if fault.kind == "hang":
            time.sleep(fault.delay)
        raise FaultInjected(site, key)

    def fire_mutate(self, site: str, key: str, data: bytes) -> bytes:
        """Payload injection point: a matching ``corrupt`` rule returns
        the data with one byte flipped (the seeded RNG picks the offset),
        so integrity checks downstream, not transport error handling,
        must catch it."""
        fault = self._pick(site, key, kinds=("corrupt",))
        if fault is None or not data:
            return data
        self._count(fault, site, key)
        with self._lock:
            offset = self._rng.randrange(len(data))
        out = bytearray(data)
        out[offset] ^= 0xFF
        return bytes(out)

    def _count(self, fault: Fault, site: str, key: str) -> None:
        trace.inc("resilience.faults_injected")
        trace.event("fault_injected", site=site, fault=fault.kind,
                    key=key or None, fire=fault.fired)
        log.info("fault injected: %s at %s key=%s (fire #%d)",
                 fault.kind, site, key or "-", fault.fired)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [{"site": f.site, "kind": f.kind, "fired": f.fired,
                     "times": f.times} for f in self.faults]


# one injector per process, None when injection is off
_injector: Optional[FaultInjector] = None


def install(spec: str, seed: int = 0) -> Optional[FaultInjector]:
    """Install a process-wide injector; an empty spec uninstalls."""
    global _injector
    _injector = FaultInjector(spec, seed) if spec else None
    if _injector is not None:
        log.warning("fault injection ACTIVE: %s (seed=%d)", spec, seed)
    return _injector


def uninstall() -> None:
    global _injector
    _injector = None


def get_injector() -> Optional[FaultInjector]:
    return _injector
