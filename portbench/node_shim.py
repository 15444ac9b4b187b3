"""The port's node: ``python -m portbench.node_shim <node.run arguments>``
calls ``upow_tpu_torch.node.run.main`` unchanged.

With ``PORTBENCH_CLOSE`` set, a thread waits for that file and then
prints ``portbench-modules`` and the forbidden modules this process
holds (``guard``): the window has closed.

For the benchmark's tests, never for its runs, it can run the node
with a deliberately wrong part.  ``PORTBENCH_VARIANT``: ``control`` answers every signature check valid
(the node that skips the guarantee its configuration states),
``utxo_unchanged`` leaves the spent outputs in the UTXO set (a step that
returns its state unchanged), ``flipped_verdict`` turns the first
verdict of every signature batch, and ``altered_reply`` turns every
tenth ``push_tx`` that the node admits into a refusal (answers altered
where they are produced).
``PORTBENCH_START_DIFFICULTY`` lowers the protocol's start difficulty,
so that a test on the host can mine the chain it syncs.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from decimal import Decimal
from pathlib import Path

VARIANTS = ("control", "utxo_unchanged", "flipped_verdict", "altered_reply")


def _report_at_close(path: Path) -> None:
    from portbench import guard

    while not path.exists():
        time.sleep(0.1)
    print(f"portbench-modules {json.dumps(guard.loaded_forbidden())}",
          flush=True)


def main() -> None:
    from upow_tpu_torch.core import difficulty
    from upow_tpu_torch.node import app, run
    from upow_tpu_torch.state import storage
    from upow_tpu_torch.verify import txverify

    variant = os.environ.get("PORTBENCH_VARIANT", "")
    if variant and variant not in VARIANTS:
        raise SystemExit(f"unknown PORTBENCH_VARIANT {variant!r}")
    if os.environ.get("PORTBENCH_START_DIFFICULTY"):
        difficulty.START_DIFFICULTY = Decimal(
            os.environ["PORTBENCH_START_DIFFICULTY"])
    checks = txverify.run_sig_checks
    if variant == "control":
        txverify.run_sig_checks = lambda c, *a, **k: [True] * len(c)
    elif variant == "flipped_verdict":
        def flipped(c, *a, **k):
            out = list(checks(c, *a, **k))
            if out:
                out[0] = not out[0]
            return out
        txverify.run_sig_checks = flipped
    elif variant == "utxo_unchanged":
        async def unchanged(self, txs):
            return None
        storage.ChainState.remove_outputs = unchanged
    elif variant == "altered_reply":
        submit, admitted = app.Node._submit_tx, [0]

        async def altered(self, tx, sender):
            result = await submit(self, tx, sender)
            if result.get("ok"):
                admitted[0] += 1
                if admitted[0] % 10 == 0:
                    return {"ok": False, "error": "Transaction has not been added"}
            return result
        app.Node._submit_tx = altered
    if os.environ.get("PORTBENCH_CLOSE"):
        threading.Thread(target=_report_at_close, daemon=True,
                         args=(Path(os.environ["PORTBENCH_CLOSE"]),)).start()
    sys.argv = ["upow_tpu_torch.node.run"] + sys.argv[1:]
    run.main()


if __name__ == "__main__":
    main()
