"""Multi-host scale-out of mining: disjoint nonce ranges per process.

Mining needs no collectives across hosts: each process takes a disjoint
range of the nonce space and the first hit wins through the ordinary
push_block.  :func:`plan_nonce_ranges` computes the ranges,
deterministically, as the JAX package's ``parallel/multihost.py`` does.

Process bring-up is not ported: the JAX package starts
``jax.distributed`` when ``UPOW_COORDINATOR_ADDRESS`` is set, and the
port's counterpart (``torch.distributed``) is ROADMAP A11.  Until then
:func:`initialize` refuses a configured coordinator instead of letting
every host mine the whole range.
"""

from __future__ import annotations

import os
from typing import List, Tuple

from ..mine.engine import NONCE_SPACE


def initialize() -> bool:
    """False for a single-process run; raises when a coordinator is
    configured, since the multi-host bring-up is not ported yet."""
    address = os.environ.get("UPOW_COORDINATOR_ADDRESS")
    if address:
        raise NotImplementedError(
            f"UPOW_COORDINATOR_ADDRESS={address!r}: multi-host mining is "
            "not ported yet (ROADMAP A11); run one miner per host with "
            "--shard i/k instead")
    return False


def plan_nonce_ranges(num_processes: int,
                      lo: int = 0, hi: int = NONCE_SPACE
                      ) -> List[Tuple[int, int]]:
    """Disjoint, exhaustive [lo, hi) ranges, one per process.

    Deterministic so every process computes the same plan with no
    communication.  Contiguous blocks (not the reference's per-nonce
    interleave, miner.py:140-148) keep each device round one range."""
    if not 0 <= lo < hi <= NONCE_SPACE:
        raise ValueError(f"bad nonce range [{lo}, {hi})")
    span = hi - lo
    return [
        (lo + span * i // num_processes, lo + span * (i + 1) // num_processes)
        for i in range(num_processes)
    ]
