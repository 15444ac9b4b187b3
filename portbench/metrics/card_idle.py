"""The card's idle share over the traced span (the device).

Every process that launches work is captured (the miner by the shim,
each node by its ``/debug/profile``); their device events are merged on
the wall clock, and the share of the span that no kernel, copy or set
covers is the idle share.
"""


def read(obs):
    window = obs.extra.get("window_s")
    if not window or not obs.extra.get("busy_s"):
        return None
    return 100.0 * (1.0 - obs.extra["busy_s"] / window)
