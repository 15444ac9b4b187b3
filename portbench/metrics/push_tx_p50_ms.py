"""The node's median ``push_tx`` latency in the window (HTTP,
``node/http.py``), from the change of the buckets of
``upow_slo_http_push_tx_latency_seconds`` between the window's two reads
of ``/metrics``: the node's own clock, from request to response, without
the client's wait for a connection."""

from portbench import readers


def read(obs):
    if "node" not in obs.scrapes:
        return None
    q = readers.delta_quantile(obs.scrapes["node"],
                               "upow_slo_http_push_tx_latency_seconds", 0.5)
    return None if q is None else 1000.0 * q
