"""Node C's mean UTXO apply a block in the window (state,
``state/storage.py``): the ``block.utxo_apply`` span, from the two reads
of ``/metrics``."""


def read(obs):
    if "c" not in obs.scrapes:
        return None
    before, after = obs.scrapes["c"]
    name = "upow_span_block_utxo_apply"
    n = after.get(name + "_count", 0.0) - before.get(name + "_count", 0.0)
    s = (after.get(name + "_seconds_total", 0.0)
         - before.get(name + "_seconds_total", 0.0))
    return 1000.0 * s / n if n > 0 else None
