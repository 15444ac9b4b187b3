"""Driving one cell from a test: a folder of its own with the cell's
configuration (with overrides) and a traffic file, and a run on the
given device without the harness's look for a card."""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

from portbench import harness, registry

ROOT = Path(__file__).resolve().parents[2]

#: the solo miner at a difficulty the host's C++ miner reaches a block at
#: about once a second, with rounds of 2^20 nonces
SOLO_CPU = {"difficulty": "6.5", "miner_batch": 1 << 20,
            "reference_rounds": 24}


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def run_cell(base: Path, config: str, overrides: dict, traffic: dict,
             seconds: float, seed: int, device: str, trace: bool = False,
             sm_count: int = 0, name: Optional[str] = None):
    """(result line, observation) of one run of ``config`` under
    ``traffic`` from the folder ``base``."""
    cfg = registry.config(config)
    cfg.update(overrides)
    (base / "configs").mkdir(parents=True, exist_ok=True)
    (base / "traffic").mkdir(parents=True, exist_ok=True)
    with open(base / "configs" / f"{config}.json", "w") as f:
        json.dump(cfg, f)
    with open(base / "traffic" / "t.json", "w") as f:
        json.dump(traffic, f)
    b = bench()
    name = name or f"test.{config}"
    b["workloads"].append({"name": name, "config": config, "traffic": "t",
                           "chips": 1, "why": "test"})
    for m in b["per_layer"]:
        m.pop("workloads", None)
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=int(trace))
    run = harness.prepare(ROOT, args, device, time.monotonic(), b, base)
    run.sm_count = sm_count
    if device == "cuda":
        run.sampler.start()
    try:
        return harness.execute(run, b, {"platform": device})
    finally:
        run.sampler.stop()

#: the rig at a size the host can mine and verify: blocks of 32
#: transactions mined at difficulty 1.0 (the node shim lowers the
#: protocol's start difficulty to match), pages of two blocks
RIG_CPU = {"difficulty": "6.5", "chain_difficulty": "1.0", "pow_chunk": 1024, "n_fan": 8,
           "per_fan": 4, "wallets": 8, "full_blocks": 12,
           "miner_batch": 1 << 20, "reference_rounds": 24,
           "node_env": {"UPOW_NODE_SYNC_PAGE": "2",
                        "UPOW_DEVICE_SIG_BACKEND": "host"}}
