"""In-process multi-node network simulator (the port's copy of the JAX
package's ``swarm/``).

Spins real port nodes — full middleware, breakers, mempool, telemetry —
inside one event loop, with every peer RPC and WS frame routed through
an in-memory :class:`LinkMatrix` that models per-link latency, jitter,
drop, partitions and the ``swarm.link`` fault site.  ``node/app.py`` and
``node/peers.py`` run unmodified: the only seam is
``Node.iface_factory``, swapped for :class:`LoopbackInterface`, whose
hub hands each request to the destination node's ``handle``.

On top sits a seeded scenario runner (:mod:`.scenarios`) with adversary
actors (:mod:`.adversary`) and a DPoS governance traffic generator;
each run emits a structured artifact whose deterministic core is
fingerprinted — same seed, byte-identical fingerprint, equal to the JAX
package's.  The nodes run on the card unless the caller passes
``device="cpu"`` (``--device cpu`` on the CLI):

    python -m upow_tpu_torch.swarm --scenario partition_heal --nodes 10
    python -m upow_tpu_torch.swarm --matrix fast --out swarm.json
"""

from .links import LinkDown, LinkMatrix, LinkPolicy  # noqa: F401
from .transport import LoopbackHub, LoopbackInterface  # noqa: F401
from .harness import Swarm  # noqa: F401
from .scenarios import (SCENARIOS, artifact_fingerprint,  # noqa: F401
                        core_ok, deterministic_world, run_matrix,
                        run_scenario)
