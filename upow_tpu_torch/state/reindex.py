"""UTXO reindex tool (reference create_unspent_outputs.py:37-41): the
port's copy of the JAX package's ``state/reindex.py``, with the same
output lines and exit codes (0; 1 on a mismatch under ``--check``; 2
with no database configured).

    python -m upow_tpu_torch.state.reindex [--db PATH | --pg-dsn DSN] [--check]

Rebuilds every UTXO-class table by replaying the transaction log in
block order.  ``--check`` compares the full state fingerprint (all six
UTXO-class tables, not just the wire-visible unspent_outputs hash)
without touching the live database — the consensus-bug detector the
reference runs in production (SURVEY.md §4 oracles).  On sqlite the
check replays a backup copy; on PostgreSQL it replays inside one
transaction and rolls it back.  Both backends run on the CPU: the tool
arms no resident index.
"""

from __future__ import annotations

import argparse
import asyncio
import shutil
import sqlite3
import sys
import tempfile

from ..config import Config
from .storage import ChainState


async def check_replay_pg(state) -> tuple:
    """(before, after) full-state fingerprints, replaying inside one
    rolled-back transaction — the live tables are never modified."""
    before = await state.get_full_state_hash()
    async with state.replay_transaction():
        await state.rebuild_utxos()
        after = await state.get_full_state_hash()
    return before, after


async def amain(argv=None) -> int:
    ap = argparse.ArgumentParser("upow_tpu_torch reindex")
    ap.add_argument("--db", default=None, help="chain sqlite path")
    ap.add_argument("--pg-dsn", default=None,
                    help="PostgreSQL DSN (reference schema.sql database)")
    ap.add_argument("--check", action="store_true",
                    help="verify only: replay a copy, compare fingerprints")
    args = ap.parse_args(argv)

    cfg = Config.load()
    # an explicit --db targets a sqlite file even when the config is
    # postgres-backed (offline snapshot checks must never touch the
    # live pg database)
    pg_dsn = args.pg_dsn if args.pg_dsn is not None else (
        cfg.node.pg_dsn
        if cfg.node.db_backend == "postgres" and args.db is None else "")
    if pg_dsn:
        from .pg import PgChainState

        state = PgChainState(pg_dsn)
        try:
            blocks = await state.get_next_block_id() - 1
            if args.check:
                before, after = await check_replay_pg(state)
            else:
                before = await state.get_full_state_hash()
                await state.rebuild_utxos()
                after = await state.get_full_state_hash()
            print(f"{blocks} blocks; live state fingerprint {before}")
            print(f"replayed state fingerprint {after}")
            if args.check and after != before:
                print("MISMATCH: live UTXO-class tables diverge from the "
                      "tx log (consensus bug or corruption)")
                return 1
            if args.check:
                print("OK: live tables match the replay")
            return 0
        finally:
            state.close()

    db_path = args.db if args.db is not None else cfg.node.db_path
    if not db_path:
        print("no database configured (--db / --pg-dsn or "
              "UPOW_NODE_DB_PATH / UPOW_NODE_PG_DSN)")
        return 2

    work_path = db_path
    tmpdir = None
    if args.check:
        # replay into a COPY: a mismatch must leave the live tables
        # untouched as evidence, not overwrite them with the replay
        tmpdir = tempfile.mkdtemp(prefix="upow_reindex_")
        work_path = f"{tmpdir}/check.sqlite"
        src = sqlite3.connect(db_path)
        dst = sqlite3.connect(work_path)
        src.backup(dst)
        src.close()
        dst.close()

    state = ChainState(work_path)
    try:
        before = await state.get_full_state_hash()
        blocks = await state.get_next_block_id() - 1
        print(f"{blocks} blocks; live state fingerprint {before}")
        await state.rebuild_utxos()
        after = await state.get_full_state_hash()
        print(f"replayed state fingerprint {after}")
        if args.check and after != before:
            print("MISMATCH: live UTXO-class tables diverge from the tx "
                  "log (consensus bug or corruption)")
            return 1
        if args.check:
            print("OK: live tables match the replay")
        return 0
    finally:
        state.close()
        if tmpdir is not None:
            # offline maintenance CLI: nothing else shares this event
            # loop while it tears down
            shutil.rmtree(tmpdir, ignore_errors=True)


def main() -> int:
    return asyncio.run(amain())


if __name__ == "__main__":
    sys.exit(main())
