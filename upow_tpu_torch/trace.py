"""Compatibility shim — the telemetry subsystem absorbed this module.

As in the JAX package, ``trace`` re-exports :mod:`upow_tpu_torch.telemetry`
(spans, counters, histograms, events, trace trees) for the call sites
that prefer the short import; the kernel and pipeline recorders
(``record_batch``, ``record_stage``, ``record_index_probe``) live in
:mod:`upow_tpu_torch.telemetry.device`.

Counters that a run should read as zero unless something went wrong:
``txid.sample_mismatch`` (a device txid batch disagreed with hashlib on
its integrity sample, ``crypto/sha256.py``) and ``sync.host_txid_retry``
(a sync page's device-seeded txids gave a merkle mismatch and the page
was hashed again on the host, ``node/app.py``).
"""

from __future__ import annotations

from .telemetry import (TRACE_HEADER, add_span, attached,  # noqa: F401
                        child_span, configure, counters, current_span,
                        current_trace_id, ensure_counter,
                        ensure_histogram, event, finish_child,
                        histograms, inc, new_trace_id, observe,
                        profile, request_trace, reset, span, stats,
                        traces, valid_trace_id)
