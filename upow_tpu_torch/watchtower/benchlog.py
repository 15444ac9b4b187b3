"""Bench-harness alert sink: ``alert_fired`` lines in a JSONL file.

When a bench-driven node fires an alert, the incident belongs next to
the bench's own event stream, so the trajectory tooling sees the
regression and its exemplar trace in one place.  The record shape and
the size-capped keep-newest-half rotation are the JAX package's
``watchtower/benchlog.py``'s.

The engine calls :func:`record` from its evaluation task; the write is
a tiny O(100 B) append on an alert *transition* — rare by construction
(for-durations + dedup) — so it stays inline rather than dragging in
an executor hop.
"""

from __future__ import annotations

import json
import os
import time

from ..logger import get_logger

log = get_logger("watchtower")

MAX_BYTES = 1 << 20   # the event files' size cap


def _rotate_keep_tail(path: str, max_bytes: int) -> None:
    """Size-cap an append-only log: past ``max_bytes``, keep the newest
    half aligned to a line boundary (atomic replace, never raises)."""
    try:
        if os.path.getsize(path) <= max_bytes:
            return
        with open(path, "rb") as f:  # upowlint: disable=RC001
            f.seek(-(max_bytes // 2), os.SEEK_END)
            tail = f.read()
        cut = tail.find(b"\n")
        if cut >= 0:
            tail = tail[cut + 1:]
        tmp = path + ".rot"
        with open(tmp, "wb") as f:  # upowlint: disable=RC001
            f.write(tail)
        os.replace(tmp, path)
    except OSError:
        pass


def record(path: str, alert) -> None:
    """Append one ``alert_fired`` record; never raises into the engine."""
    entry = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "kind": "alert_fired",
        "rule": alert.rule.name,
        "severity": alert.rule.severity,
        "key": alert.key,
        "value": alert.value,
        "exemplar_trace_id": (alert.exemplars[0]
                              if alert.exemplars else None),
        "source": "watchtower",
    }
    try:
        _rotate_keep_tail(path, MAX_BYTES)
        # RC001: rare O(100 B) append on an alert transition; the
        # engine's tick cadence dwarfs the write.
        with open(path, "a") as f:  # upowlint: disable=RC001
            f.write(json.dumps(entry, sort_keys=True) + "\n")
    except OSError as e:
        log.warning("alert_fired record not written to %s: %s", path, e)
