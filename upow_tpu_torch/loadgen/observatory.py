"""The perf observatory's artifact writer (the part of the JAX package's
``loadgen/observatory.py`` that the swarm and fleet CLIs import).

:func:`write_artifact` writes one JSON artifact atomically;
:func:`append_progress` appends one compact ``perf_observatory`` line
to a ``PROGRESS.jsonl`` trajectory, which :mod:`.gate`'s ``--trend``
reads.  The JAX module's ``run_observatory``, ``kernel_bench``,
``_arm_device`` and ``_kernel_cost_analysis`` read ``benchutil`` and
come with it (ROADMAP A13g).
"""

from __future__ import annotations

import datetime
import json
import os


def write_artifact(artifact: dict, out_path: str) -> None:
    tmp = f"{out_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, out_path)


def append_progress(artifact: dict, progress_path: str) -> None:
    """One compact trajectory line per observatory run, additive to the
    bench harness's own PROGRESS.jsonl records (distinguished by ``kind``)."""
    line = {
        "ts": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "kind": "perf_observatory",
        "slo": {ep: {"req_s": row.get("req_s"),
                     "p50_ms": row.get("p50_ms"),
                     "p95_ms": row.get("p95_ms"),
                     "p99_ms": row.get("p99_ms"),
                     "errors": row.get("errors")}
                for ep, row in artifact["slo"]["endpoints"].items()},
        "kernels": {name: entry.get("value")
                    for name, entry in artifact["kernels"].items()
                    if isinstance(entry, dict) and "value" in entry},
        "provenance": artifact["provenance"],
    }
    with open(progress_path, "a") as f:
        f.write(json.dumps(line, sort_keys=True) + "\n")
