"""The port's miner CLI, run in this process so the harness can see it.

``python -m portbench.miner_shim <miner CLI arguments>`` calls
``upow_tpu_torch.mine.miner.main`` unchanged, with additions that
observe and change nothing of the search:

* each template's header prefix is printed as ``portbench-template
  <hex> <fetch start> <fetch end>`` before it is mined (the fetch of its
  ``get_mining_info`` on the monotonic clock, which every process of the
  host shares), so the reference can recompute its rounds and its pool,
  and the target the search kernel is handed for it as
  ``portbench-target`` and its seven words (on the card's path), so the
  reference can hold it to the header's difficulty;
* with ``PORTBENCH_PROFILE_DIR`` set, a ``torch.profiler`` capture of
  the card's activity starts at the first template after the file
  ``start`` appears there and stops at the first after ``stop`` appears,
  and is written to ``miner_trace.json`` in that directory;
* with ``PORTBENCH_CLOSE`` set, the first template after that file
  appears is not mined: the shim prints ``portbench-modules`` and the
  forbidden modules this process holds (``guard``), then mines each
  round that the file lists again, through the miner's own engine and
  backend, at the file's lower difficulty, prints each answer as
  ``portbench-recheck <i> <nonce|none>``, prints ``portbench-closed``
  and waits to be stopped.

``PORTBENCH_VARIANT`` selects a deliberately wrong miner for the
benchmark's tests, never for its runs: ``control`` searches for the
integer part of the difficulty (the target without its fractional
charset, the step that would tempt a faster miner), ``stale_template``
mines the first template for ever (a step that returns its state
unchanged), ``altered_nonce`` pushes the found nonce plus one (an
answer altered where it is produced), ``half_round`` searches the first
half of each round's nonces and answers for the whole round (half of
the batch left out), and ``jax_package`` puts a module named
``upow_tpu`` into ``sys.modules`` (what the import check must find).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import types
from decimal import Decimal
from pathlib import Path

VARIANTS = ("control", "stale_template", "altered_nonce", "half_round",
            "jax_package")


class _Capture:
    def __init__(self, directory: Path):
        self.dir = directory
        self.prof = None
        self.done = False

    @staticmethod
    def prime() -> None:
        """A first capture sets the profiler up (several seconds on the
        card), so that the traced window's own start is quick."""
        import torch

        if not torch.cuda.is_available():
            return
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").sum().item()

    def poll(self) -> None:
        if self.done:
            return
        if self.prof is None and (self.dir / "start").exists():
            import torch

            # the card's activity; the host's where there is no card
            # (the benchmark's tests)
            activity = (torch.profiler.ProfilerActivity.CUDA
                        if torch.cuda.is_available()
                        else torch.profiler.ProfilerActivity.CPU)
            self.prof = torch.profiler.profile(activities=[activity])
            self.prof.start()
            print(f"portbench-profile started {time.time():.6f}", flush=True)
        elif self.prof is not None and (self.dir / "stop").exists():
            t_stop = time.time()
            self.prof.stop()
            self.prof.export_chrome_trace(str(self.dir / "miner_trace.json"))
            self.done = True
            print(f"portbench-profile stopped {t_stop:.6f}", flush=True)


def _close(path: Path, engine, search: dict) -> None:
    """The window has closed: report the forbidden modules, mine the
    listed rounds again, and wait to be stopped."""
    from portbench import guard

    print(f"portbench-modules {json.dumps(guard.loaded_forbidden())}",
          flush=True)
    with open(path) as f:
        plan = json.load(f)
    difficulty = Decimal(plan["difficulty"])
    for i, (prefix, prev, start, count) in enumerate(plan["rounds"]):
        job = engine.MiningJob(bytes.fromhex(prefix), prev, difficulty)
        try:
            result = engine.mine(job, search["backend"], start=start,
                                 stride_end=start + count, batch=count,
                                 ttl=float("inf"),
                                 mesh_devices=search["mesh_devices"])
            answer = "none" if result.nonce is None else str(result.nonce)
        except Exception as e:  # a wrong hit fails the engine's host check
            answer = f"error {type(e).__name__}: {e}"[:200]
        print(f"portbench-recheck {i} {answer}", flush=True)
    print("portbench-closed", flush=True)
    threading.Event().wait()


def _half_round(sha_kernel) -> None:
    """Each launch searches the first half of its nonces."""
    from upow_tpu_torch import native

    pow_search, native_search = sha_kernel.pow_search, native.pow_search

    def half(template, target, start, count, device=None):
        return pow_search(template, target, start, count // 2, device=device)

    def native_half(prefix, target_hex, charset, start, count):
        return native_search(prefix, target_hex, charset, start, count // 2)

    sha_kernel.pow_search, native.pow_search = half, native_half


def main(argv=None) -> int:
    from upow_tpu_torch.crypto import sha256 as sha_kernel
    from upow_tpu_torch.mine import engine, miner

    variant = os.environ.get("PORTBENCH_VARIANT", "")
    if variant and variant not in VARIANTS:
        raise SystemExit(f"unknown PORTBENCH_VARIANT {variant!r}")
    if variant == "jax_package":
        sys.modules["upow_tpu"] = types.ModuleType("upow_tpu")
    if variant == "half_round":
        _half_round(sha_kernel)
    prof_dir = os.environ.get("PORTBENCH_PROFILE_DIR")
    capture = _Capture(Path(prof_dir)) if prof_dir else None
    if capture is not None:
        capture.prime()
    close = os.environ.get("PORTBENCH_CLOSE")
    close = Path(close) if close else None
    build_job, fetch = miner.build_job, miner.fetch_mining_info
    first, fetched = [], [0.0, 0.0]
    # the miner's backend, and whether the window has closed (the
    # rounds mined again after it print no target)
    search = {"backend": None, "mesh_devices": 0, "closed": False}

    def observed_fetch(node):
        fetched[0] = time.monotonic()
        info = fetch(node)
        fetched[1] = time.monotonic()
        return info

    def observed_build_job(info, address):
        if close is not None and close.exists():
            search["closed"] = True
            _close(close, engine, search)
        if capture is not None:
            capture.poll()
        if variant == "stale_template" and first:
            job, hashes, block_no = first[0]
        else:
            job, hashes, block_no = build_job(info, address)
            first.append((job, hashes, block_no))
        if variant == "control":
            job.difficulty = Decimal(int(job.difficulty))
        print(f"portbench-template {job.prefix.hex()} {fetched[0]:.6f} "
              f"{fetched[1]:.6f}", flush=True)
        return job, hashes, block_no

    miner.fetch_mining_info = observed_fetch
    miner.build_job = observed_build_job
    pack_target = sha_kernel.pack_target

    def observed_pack_target(spec):
        packed = pack_target(spec)
        if not search["closed"]:
                print("portbench-target "
                  + " ".join(str(int(v)) for v in packed), flush=True)
        return packed

    sha_kernel.pack_target = observed_pack_target
    mine = engine.mine

    def observed_mine(job, backend="cuda", **kwargs):
        search["backend"] = backend
        search["mesh_devices"] = kwargs.get("mesh_devices", 0)
        result = mine(job, backend, **kwargs)
        if variant == "altered_nonce" and result.nonce is not None:
            result.nonce += 1
        return result

    miner.mine = observed_mine
    return miner.main(argv)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
