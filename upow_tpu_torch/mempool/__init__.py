"""Micro-batched mempool subsystem.

The in-process authority for pending transactions: a fee-rate priority
pool (:mod:`pool`), a coalescing admission pipeline that amortizes one
P-256 signature dispatch over a whole micro-batch of ``push_tx``
requests (:mod:`intake`), and block-template assembly with a
generation-keyed mining-info cache (:mod:`template`).  The SQL
``pending_transactions`` table stays on as a write-behind journal —
restart recovery plus the wallet CLI's direct-insert path — and the
pool reconciles against it by stamp (see :meth:`Mempool.sync`).

The port of the JAX package's ``mempool/`` (docs/MEMPOOL.md there has
the architecture and config knobs); the intake submits through the
port's dispatch front, so a batch of 8 checks or more reaches the P-256
kernel that ``device.verify_kernel`` selects.
"""

from .pool import Mempool, MempoolEntry, TTLSet
from .intake import IntakeCoordinator
from .template import MiningInfoCache, assemble_template, select_reference

__all__ = ["Mempool", "MempoolEntry", "TTLSet", "IntakeCoordinator",
           "MiningInfoCache", "assemble_template", "select_reference"]
