"""In-process multi-node network simulator (the port's copy of the JAX
package's ``swarm/``, so far without its scenarios).

Spins real port nodes — full middleware, breakers, mempool, telemetry —
inside one event loop, with every peer RPC and WS frame routed through
an in-memory :class:`LinkMatrix` that models per-link latency, jitter,
drop, partitions and the ``swarm.link`` fault site.  ``node/app.py`` and
``node/peers.py`` run unmodified: the only seam is
``Node.iface_factory``, swapped for :class:`LoopbackInterface`, whose
hub hands each request to the destination node's ``handle``.  Every node
runs on the CPU.

:mod:`.scenarios` holds the determinism helpers; the seeded scenario
runner, its catalog and the CLI come with ``fleet/`` (ROADMAP A13f).
"""

from .links import LinkDown, LinkMatrix, LinkPolicy  # noqa: F401
from .transport import LoopbackHub, LoopbackInterface  # noqa: F401
from .harness import Swarm  # noqa: F401
from .scenarios import (artifact_fingerprint, core_ok,  # noqa: F401
                        deterministic_world)
