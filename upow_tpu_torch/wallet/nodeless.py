"""Nodeless wallet: HTTP-only flows (reference upow_wallet/nodeless_wallet.py),
the port's copy of the JAX package's ``wallet/nodeless.py`` on the
port's standard-library client (:func:`..node.http.fetch`, no aiohttp).

Builds transactions purely from a remote node's ``get_address_info``
response (spendable outputs) and pushes them via ``push_tx`` — no local
chain state required.  Includes the reference's 255-input consolidation
guard (nodeless_wallet.py:97-111): when an address has more outputs than
one tx can spend, send batches of 255 back to yourself first.
"""

from __future__ import annotations

import asyncio
import json
from decimal import Decimal
from typing import List, Optional, Tuple
from urllib.parse import urlencode

from ..core import curve
from ..core.codecs import point_to_string
from ..core.constants import SMALLEST
from ..core.tx import Tx, TxInput, TxOutput
from ..node.http import fetch
from .builders import select_transaction_inputs, _to_units


class NodelessWallet:
    def __init__(self, node_url: str):
        self.node_url = node_url.rstrip("/")

    async def _get(self, path: str, params: dict) -> dict:
        """GET with query params, the whole request within 30 s."""
        _status, raw = await asyncio.wait_for(
            fetch(f"{self.node_url}/{path}?{urlencode(params)}"), 30)
        return json.loads(raw)

    async def get_address_info(self, address: str, **flags) -> dict:
        params = {"address": address}
        params.update({k: "true" for k, v in flags.items() if v})
        res = await self._get("get_address_info", params)
        if not res.get("ok"):
            raise RuntimeError(res.get("error", "get_address_info failed"))
        return res["result"]

    async def get_balance(self, address: str) -> Tuple[Decimal, Decimal]:
        info = await self.get_address_info(address)
        return Decimal(info["balance"]), Decimal(info["stake"])

    async def _spendable_inputs(self, address: str) -> List[TxInput]:
        info = await self.get_address_info(address, show_pending=True)
        pending_spent = {
            (o["tx_hash"], o["index"])
            for o in (info.get("pending_spent_outputs") or [])
        }
        inputs = []
        for o in info["spendable_outputs"]:
            if (o["tx_hash"], o["index"]) in pending_spent:
                continue
            i = TxInput(o["tx_hash"], o["index"])
            i.amount = int(Decimal(o["amount"]) * SMALLEST)
            inputs.append(i)
        return inputs

    async def create_transaction(self, private_key: int, receiving_address: str,
                                 amount, message: Optional[bytes] = None) -> Tx:
        units = _to_units(amount)
        pub = curve.point_mul(private_key, curve.G)
        sender = point_to_string(pub)
        inputs = await self._spendable_inputs(sender)
        if not inputs:
            raise ValueError("No spendable outputs")
        if sum(i.amount for i in inputs) < units:
            raise ValueError("Error: You don't have enough funds")
        chosen = select_transaction_inputs(inputs, units)
        if len(chosen) > 255:
            raise ValueError(
                "Too many inputs for one transaction — consolidate first "
                "(see consolidate_outputs)")
        total = sum(i.amount for i in chosen)
        tx = Tx(chosen, [TxOutput(receiving_address, units)], message)
        if total > units:
            tx.outputs.append(TxOutput(sender, total - units))
        return tx.sign([private_key], lambda _i: pub)

    async def consolidate_outputs(self, private_key: int,
                                  batch: int = 255) -> Optional[str]:
        """Merge up to ``batch`` outputs into one self-send
        (nodeless_wallet.py:97-111)."""
        pub = curve.point_mul(private_key, curve.G)
        sender = point_to_string(pub)
        inputs = await self._spendable_inputs(sender)
        if len(inputs) <= 1:
            return None
        chosen = inputs[:batch]
        total = sum(i.amount for i in chosen)
        tx = Tx(chosen, [TxOutput(sender, total)])
        tx.sign([private_key], lambda _i: pub)
        return await self.push_tx(tx)

    async def push_tx(self, tx: Tx) -> str:
        res = await self._get("push_tx", {"tx_hex": tx.hex()})
        if not res.get("ok"):
            raise RuntimeError(res.get("error", "push_tx failed"))
        return res.get("tx_hash", tx.hash())

    async def send(self, private_key: int, to_address: str, amount,
                   message: Optional[bytes] = None) -> str:
        tx = await self.create_transaction(private_key, to_address, amount, message)
        return await self.push_tx(tx)


def main() -> int:  # minimal CLI parity with the reference script
    import argparse

    parser = argparse.ArgumentParser("upow_tpu nodeless wallet")
    parser.add_argument("command", choices=["balance", "send", "consolidate"])
    parser.add_argument("--node", required=True)
    parser.add_argument("--key", type=lambda s: int(s, 0), required=False)
    parser.add_argument("--address", required=False)
    parser.add_argument("-to", dest="to")
    parser.add_argument("-a", dest="amount")
    args = parser.parse_args()
    w = NodelessWallet(args.node)
    if args.command == "balance":
        address = args.address or point_to_string(
            curve.point_mul(args.key, curve.G))
        bal, stake = asyncio.run(w.get_balance(address))
        print(f"Balance: {bal}\nStake: {stake}")
    elif args.command == "send":
        print(asyncio.run(w.send(args.key, args.to, args.amount)))
    else:
        print(asyncio.run(w.consolidate_outputs(args.key)))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
