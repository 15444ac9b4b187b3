"""The port's swarm scenarios with the device backends, on the CPU.

The scenarios that verify signatures, reorg, restore or prune run on
``device="cpu"`` with ``device.sig_backend`` and ``device.txid_backend``
set to ``device``, ``device.txid_min_batch = 1`` and ``device.utxo_index``
on (``chip_smoke.swarm_backends``, the hook its ``swarm_path`` runs on the
card): every verify, txid batch and UTXO probe goes through the device
runtime (its drainer and kept box thread) and the kernels' plain
versions, which the test spies.  The thread hops must not move a core: each fingerprint must
equal the same scenario's host run, and the degrade must record no
failure.  The process's verdict cache is cleared before each run, so
the host run's verdicts cannot stand in for the device verify.
"""

import collections
import dataclasses

import pytest

import chip_smoke
import upow_tpu_torch.swarm.scenarios as tsc
from upow_tpu_torch.crypto import p256 as tp256
from upow_tpu_torch.crypto import sha256 as tsha
from upow_tpu_torch.state import device_index as tdi
from upow_tpu_torch.verify import txverify


#: the plain versions each scenario must reach (calls > 0) on the CPU
PLAIN_REACHED = {
    "dpos_governance": ("verify_plain", "sha256_ragged_plain", "probe_plain"),
    "reorg_storm": ("sha256_ragged_plain",),
    "snapshot_churn": ("sha256_ragged_plain",),
    "archive_prune": ("verify_plain", "sha256_ragged_plain", "probe_plain"),
    "geo_soak": ("verify_plain", "sha256_ragged_plain", "probe_plain"),
}


@pytest.mark.parametrize("name", sorted(PLAIN_REACHED))
def test_device_backends_keep_the_fingerprint(name, monkeypatch):
    host = tsc.run_scenario(name, seed=7, device="cpu")
    calls = collections.Counter()
    for mod, fn in ((tp256, "verify_plain"), (tsha, "sha256_ragged_plain"),
                    (tdi, "probe_plain")):
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _fn=fn, **k):
            calls[_fn] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, spy)
    spec = tsc.SCENARIOS[name]
    kwargs = dict(spec.swarm_kwargs, cfg_hook=chip_smoke.swarm_backends(
        spec.swarm_kwargs.get("cfg_hook")))
    monkeypatch.setitem(tsc.SCENARIOS, name,
                        dataclasses.replace(spec, swarm_kwargs=kwargs))
    txverify.DEGRADE.reset()
    txverify.clear_sig_verdicts()
    art = tsc.run_scenario(name, seed=7, device="cpu")
    assert tsc.core_ok(art["core"])
    assert art["core"] == host["core"]
    assert art["fingerprint"] == host["fingerprint"]
    for fn in PLAIN_REACHED[name]:
        assert calls[fn] > 0, (fn, dict(calls))
    snap = txverify.DEGRADE.snapshot()
    assert snap["errors"] == 0 and snap["state"] == "ok", snap
