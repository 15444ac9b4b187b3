"""Launcher: ``python -m upow_tpu_torch.node.run [--config cfg.json]
[--port N] [--db PATH] [--device cuda|cpu]``.

Reads the JAX package's config file and ``UPOW_*`` environment
(``UPOW_DEVICE_VERIFY_KERNEL=complete`` selects the complete-formula
kernel).  Verifies on the card by default and refuses to start without
one; ``--device cpu`` runs the kernels' plain PyTorch versions.  The
node configures the logger from ``Config.log`` (``UPOW_LOG_*``: a
rotating ``logs/app.log`` and the console by default,
``UPOW_LOG_JSON_FORMAT=1`` for JSONL lines carrying the trace id).
"""

import argparse
import asyncio

from ..config import Config
from .app import serve_forever


def main() -> None:
    parser = argparse.ArgumentParser("upow_tpu_torch node")
    parser.add_argument("--config", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--db", default=None)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    overrides = {}
    if args.port is not None:
        overrides["node__port"] = args.port
    if args.db is not None:
        overrides["node__db_path"] = args.db
    try:
        asyncio.run(serve_forever(Config.load(args.config, **overrides),
                                  device=args.device))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
