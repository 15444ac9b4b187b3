"""Deterministic wallet-population load generator (the part of the JAX
package's ``loadgen/`` that the swarm and fleet CLIs import).

Import-light on purpose: :mod:`.gate` must run with stdlib only, and
``python -m upow_tpu_torch.loadgen.gate`` imports this package.

* :mod:`.population` — seeded schedule builder (stdlib only).
* :mod:`.runner`     — schedule execution + summary (stdlib + asyncio);
  includes the deterministic mock backend the tests pin.
* :mod:`.gate`       — stdlib regression checker
  (``python -m upow_tpu_torch.loadgen.gate --against BENCH_r05.json``).
* :mod:`.observatory` — the artifact writer and the progress line.

The JAX package's in-process node harness, read-path and co-residency
scenarios, observatory runner and ``__main__`` read ``benchutil`` and
come with it (ROADMAP A13g).
"""

from .population import LoadEvent, PopulationSpec, build_schedule  # noqa: F401

__all__ = ["LoadEvent", "PopulationSpec", "build_schedule"]
