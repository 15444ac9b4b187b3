"""The swarm's determinism helpers (the part of the JAX package's
``swarm/scenarios.py`` that needs no ``fleet/``).

Every scenario runs inside :func:`deterministic_world`: the consensus
clock is frozen (advanced only by the mining helper), START_DIFFICULTY
drops to 1.0 so the python searcher solves in microseconds, the global
``random`` is seeded, telemetry rings are cleared and fault injection is
uninstalled afterwards.  Wallet keys derive from ``(seed, tag)``
(:func:`_wallet`), so every address — and therefore every block hash —
is a pure function of the seed.  A scenario's artifact splits into a
``core`` of values that are a function of (scenario, seed) only, whose
:func:`artifact_fingerprint` is the determinism contract, and an
``observed`` part that timing may move.

The scenarios themselves, their registry and runner read ``fleet/``'s
scraper and geo-soak, and come with them into this module (ROADMAP
A13f).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
from decimal import Decimal
from typing import Tuple

from .. import telemetry
from ..resilience import faultinject

#: Frozen consensus-clock epoch every scenario starts from.
GENESIS_EPOCH = 1_753_791_000


def _wallet(seed: int, tag: str) -> Tuple[int, str]:
    """Deterministic (privkey, address) from (seed, tag)."""
    from ..core import curve, point_to_string

    digest = hashlib.sha256(f"swarm:{seed}:{tag}".encode()).digest()
    d, pub = curve.keygen(rng=int.from_bytes(digest[:8], "big") | 1)
    return d, point_to_string(pub)


@contextlib.contextmanager
def deterministic_world(seed: int):
    """Pin every nondeterminism source a scenario touches."""
    import random

    from ..core import clock, difficulty

    prev_difficulty = difficulty.START_DIFFICULTY
    difficulty.START_DIFFICULTY = Decimal("1.0")
    clock.freeze(GENESIS_EPOCH)
    random.seed(seed)
    telemetry.reset()
    try:
        yield
    finally:
        difficulty.START_DIFFICULTY = prev_difficulty
        clock.reset()
        faultinject.uninstall()


def core_ok(core: dict) -> bool:
    """True when every boolean assertion in a core dict held."""
    return all(v for v in core.values() if isinstance(v, bool))


def artifact_fingerprint(core: dict) -> str:
    """sha256 over core's canonical JSON — THE determinism contract."""
    blob = json.dumps(core, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()
