"""Multi-host scale-out of mining: disjoint nonce ranges per process.

Mining needs no collectives across hosts: each process takes a disjoint
range of the nonce space and the first hit wins through the ordinary
push_block.  :func:`plan_nonce_ranges` computes the ranges,
deterministically, as the JAX package's ``parallel/multihost.py`` does;
within a process, ``parallel.mesh`` shards the range over its cards.

:func:`initialize` is the bring-up: where the JAX package starts
``jax.distributed``, the port starts ``torch.distributed`` with the
``gloo`` backend (its collectives run on the host, so every process may
share one card, where NCCL refuses two ranks on the same GPU).  The
coordinator comes from the argument or ``UPOW_COORDINATOR_ADDRESS``
(``host:port``), the process count and this process's rank from the
arguments or from ``WORLD_SIZE`` and ``RANK`` (the PyTorch launcher's
names).  A single-process run configures no coordinator and stays as it
is; a configured bring-up that fails raises, rather than letting every
host mine the whole range.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

from ..mine.engine import NONCE_SPACE


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout: float = 300.0) -> bool:
    """Bring up ``torch.distributed`` (gloo) for a multi-host run; a no-op
    when no coordinator is configured anywhere.  Returns True when
    distributed mode is active.  ``timeout`` bounds the rendezvous and
    each collective, in seconds."""
    coordinator_address = coordinator_address or os.environ.get(
        "UPOW_COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None:
        return False  # a single process: rank 0 of 1
    dist = _dist()
    if dist.is_initialized():
        return True  # already brought up (by a launcher)
    try:
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
        address = coordinator_address or ""
        url = address if "://" in address else f"tcp://{address}"
        dist.init_process_group(
            "gloo", init_method=url, world_size=num_processes,
            rank=process_id, timeout=datetime.timedelta(seconds=timeout))
        return True
    except Exception as e:
        # a configured-but-failed bring-up must be LOUD: falling back to a
        # single process would have every host mine the whole nonce space
        raise RuntimeError(
            f"torch.distributed bring-up failed for coordinator "
            f"{coordinator_address!r}: {e!r}") from e


def process_slot() -> Tuple[int, int]:
    """(this process's rank, the process count): (0, 1) without a
    distributed run."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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


def my_nonce_range(lo: int = 0, hi: int = NONCE_SPACE) -> Tuple[int, int]:
    """This process's range under the global plan (its rank of the
    distributed run)."""
    rank, count = process_slot()
    return plan_nonce_ranges(count, lo, hi)[rank]
