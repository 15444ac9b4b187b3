"""The node's mean ``get_mining_info`` latency over the window (pool and
template, ``mempool/template.py`` and ``node/app.py``): the change of
``upow_slo_http_get_mining_info_latency_seconds`` between the window's
two reads of ``/metrics``."""

from portbench import readers


def read(obs):
    if "node" not in obs.scrapes:
        return None
    mean = readers.delta_mean(
        obs.scrapes["node"], "upow_slo_http_get_mining_info_latency_seconds")
    return None if mean is None else mean * 1000.0
