"""Wallet CLI: the ten subcommands (reference upow_wallet/wallet.py:44-62),
the port's copy of the JAX package's ``wallet/cli.py``.

``python -m upow_tpu_torch.wallet.cli <command> [...]`` with the reference's
flags: ``-to`` recipient(s), ``-a`` amount(s), ``-m`` message, ``-r``
vote range, ``-from`` revoke source.  Transactions are pushed to the
configured node over HTTP; if that fails and a local chain DB is
configured, they are inserted directly into its mempool
(wallet.py:243-252's fallback).  The push goes over the port's
standard-library client (:func:`..node.http.fetch`, no aiohttp); the
lines printed and the exit codes are the JAX CLI's, a failed connect
worded as aiohttp words it.  The CLI opens the chain file with
``sole_writer=False`` and never touches a device, so it runs beside a
node that is writing the file and owns the card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from decimal import Decimal
from typing import Optional
from urllib.parse import urlencode, urlsplit

from ..config import Config
from ..core.codecs import point_to_string
from ..core import curve
from ..node.http import fetch
from ..state.storage import ChainState
from .builders import WalletBuilder
from .keystore import KeyStore


def _string_to_bytes(string: Optional[str]) -> Optional[bytes]:
    if string is None:
        return None
    try:
        return bytes.fromhex(string)
    except ValueError:
        return string.encode("utf-8")


def _error_text(url: str, e: Exception) -> str:
    """``e`` as the JAX CLI prints it: a failed connect in aiohttp's
    words (``ClientConnectorError``), anything else as it is."""
    if isinstance(e, OSError) and e.strerror:
        split = urlsplit(url)
        port = split.port or (443 if split.scheme == "https" else 80)
        return (f"Cannot connect to host {split.hostname}:{port}"
                f" ssl:default [{e.strerror}]")
    return str(e)


async def push_tx(tx, node_url: str, state: Optional[ChainState]) -> None:
    if not node_url:
        # explicit local-only mode (--node ""): straight to the local
        # chain's mempool, no network attempt
        if state is None:
            raise RuntimeError("no node url and no local chain db")
        await state.add_pending_transaction(tx)
        print(f"Transaction added to local mempool. Hash: {tx.hash()}")
        return
    url = f"{node_url.rstrip('/')}/push_tx?" + urlencode({"tx_hex": tx.hex()})
    try:
        _status, raw = await asyncio.wait_for(fetch(url), 20)
        res = json.loads(raw)
        if res.get("ok"):
            print(f"Transaction pushed. Hash: {tx.hash()}")
            return
        raise RuntimeError(res.get("error", "push failed"))
    except Exception as e:
        if state is None:
            raise
        print(f"node push failed ({_error_text(url, e)}); falling back to"
              " local mempool")
        await state.add_pending_transaction(tx)
        print(f"Transaction added to local mempool. Hash: {tx.hash()}")


async def amain(argv=None) -> int:
    parser = argparse.ArgumentParser("upow_tpu wallet")
    parser.add_argument("command", choices=[
        "createwallet", "balance", "send", "sendmany", "stake", "unstake",
        "register_inode", "de_register_inode", "register_validator",
        "vote", "revoke"])
    parser.add_argument("-to", metavar="recipient", type=str, required=False)
    parser.add_argument("-a", metavar="amount", type=str, required=False)
    parser.add_argument("-m", metavar="message", type=str, dest="message")
    parser.add_argument("-r", metavar="range", type=str, dest="range")
    parser.add_argument("-from", metavar="revoke_from", type=str,
                        dest="revoke_from")
    parser.add_argument("--wallet", type=str, default=None,
                        help="key_pair_list.json path")
    parser.add_argument("--db", type=str, default=None,
                        help="local chain db (direct mode)")
    parser.add_argument("--node", type=str, default=None, help="node URL")
    args = parser.parse_args(argv)

    cfg = Config.load()
    store = KeyStore(args.wallet)
    # an EXPLICIT --node "" means local-only (no fallback to the seed:
    # a test or air-gapped wallet must never push to the public API)
    node_url = cfg.node.seed_url if args.node is None else args.node
    db_path = args.db if args.db is not None else cfg.node.db_path
    # sole_writer=False: the node may be writing this file concurrently;
    # pay the per-read data_version pragma instead of risking 50 ms of
    # stale cached amounts (ADVICE r2).
    state = ChainState(db_path, sole_writer=False) if db_path else None

    if args.command == "createwallet":
        d, address = store.create_key()
        print(f"Private key: {hex(d)}\nAddress: {address}")
        return 0

    if not store.keys():
        print("No wallet keys — run createwallet first.")
        return 1

    if args.command == "balance":
        if state is None:
            print("balance needs a chain db (--db) or use the nodeless wallet")
            return 1
        total, total_pending = Decimal(0), Decimal(0)
        for pair in store.keys():
            d = int(pair["private_key"])
            address = point_to_string(curve.point_mul(d, curve.G))
            bal = Decimal(await state.get_address_balance(address)) / 10**8
            pend = Decimal(await state.get_address_balance(
                address, check_pending_txs=True)) / 10**8
            stake = await state.get_address_stake(address)
            total += bal
            total_pending += pend
            delta = pend - bal
            print(f"\nAddress: {address}\nPrivate key: {hex(d)}"
                  f"\nBalance: {bal}"
                  f"{f' ({delta} pending)' if delta else ''}"
                  f"\nStake: {stake}")
        print(f"\nTotal Balance: {total}"
              f"{f' ({total_pending - total} pending)' if total_pending != total else ''}")
        return 0

    if state is None:
        print("This command builds against chain state; pass --db or run a node.")
        return 1

    key = int(store.keys()[0]["private_key"])
    builder = WalletBuilder(state)
    try:
        if args.command == "send":
            tx = await builder.create_transaction(
                key, args.to, args.a, _string_to_bytes(args.message))
        elif args.command == "sendmany":
            tx = await builder.create_transaction_to_send_multiple_wallet(
                key, (args.to or "").split(","), (args.a or "").split(","),
                _string_to_bytes(args.message))
        elif args.command == "stake":
            tx = await builder.create_stake_transaction(key, args.a)
        elif args.command == "unstake":
            tx = await builder.create_unstake_transaction(key)
        elif args.command == "register_inode":
            tx = await builder.create_inode_registration_transaction(key)
        elif args.command == "de_register_inode":
            tx = await builder.create_inode_de_registration_transaction(key)
        elif args.command == "register_validator":
            tx = await builder.create_validator_registration_transaction(key)
        elif args.command == "vote":
            tx = await builder.create_voting_transaction(
                key, args.range, args.to)
        elif args.command == "revoke":
            tx = await builder.create_revoke_transaction(
                key, args.revoke_from)
        else:  # pragma: no cover
            return 2
    except ValueError as e:
        # builder refusals carry the user-facing reason (the reference
        # wallet prints these, utils.py raises the same strings) — a
        # clean message and exit code, not a traceback
        print(str(e))
        return 1
    await push_tx(tx, node_url, state)
    return 0


def main() -> int:
    return asyncio.run(amain())


if __name__ == "__main__":
    sys.exit(main())
