"""Node C's time a sync page in the window (sync, ``node/app.py`` and
``crypto/sha256.py``): the page's txid batch (``sync.page_txids``) and
its batched signature verify (``sync.page_sig_prefill``), summed over
the window's pages from the two reads of ``/metrics``, over the pages."""

def read(obs):
    if "c" not in obs.scrapes:
        return None
    before, after = obs.scrapes["c"]
    total = 0.0
    for span in ("sync_page_txids", "sync_page_sig_prefill"):
        name = f"upow_span_{span}_seconds_total"
        total += after.get(name, 0.0) - before.get(name, 0.0)
    count = "upow_span_sync_page_txids_count"
    pages = after.get(count, 0.0) - before.get(count, 0.0)
    return 1000.0 * total / pages if pages > 0 else None
