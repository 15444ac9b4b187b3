"""The node's mean intake batch in the window (intake,
``mempool/intake.py``): the change of ``upow_mempool_intake_batch_size``
between the window's two reads of ``/metrics``."""

from portbench import readers


def read(obs):
    if "node" not in obs.scrapes:
        return None
    return readers.delta_mean(obs.scrapes["node"],
                              "upow_mempool_intake_batch_size")
