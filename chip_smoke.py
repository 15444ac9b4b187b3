"""Drive the PyTorch/CUDA port's paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build every kernel of the paths from csrc/ with nvcc (sm_90a), one
   nvcc per source, all started together, with ptxas's registers and
   spills, and the SASS opcodes per loop trip (cuobjdump) of the sha256
   search and of both P-256 ladders;
3. kernel vs plain, P-256: the Jacobian verify kernel against its plain
   PyTorch version on 8,192 lanes (one full block of signatures: honest,
   corrupted, r + n < p, off-curve, (0, 0), oversized digests and
   coordinates, crafted ladder collisions), bit for bit, with verdicts
   held against the host oracle on a sample; then at the main path's
   launch shapes (1,026 lanes, a ragged edge, and 1 lane) and at 33
   lanes (a partial warp and block of its four-thread groups); times,
   the bound, and the kernel's group and block size, shared memory a
   block, registers and local bytes a thread;
4. kernel vs plain, P-256 complete: the RCB16 complete-formula kernel on
   the same 8,192 lanes against its plain version and against the
   Jacobian path's final verdicts (exception lanes decided by the host
   oracle), every lane, and at the 1,026-, 33- and 1-lane shapes (33: a
   partial warp and block of its four-thread groups); times with 10
   dispatches queued, the bound, and the kernel's group and block size,
   shared memory a block, registers and local bytes a thread;
5. kernel vs plain, sha256: the nonce-search kernel against its plain
   PyTorch version (and a hashlib brute force where the range is small
   or its first hit near) on v2 and v1 templates, integer and
   fractional difficulties, a miss, dense hits, ragged counts, a range
   ending at 2^32 - 1, and 16 consecutive 2^24-nonce rounds at
   difficulty 5 (the miner's dispatch shape); times and the bound;
6. the accept path: a 3-block chain fanning one coinbase into 255 x 32
   outputs (a sqlite file), each block mined by the port's ``mine(job,
   "cuda")`` at the protocol's difficulty 6.0, then, on an in-memory
   copy, ``BlockManager(state).create_block`` of the 8,160-tx block on
   the card (Jacobian kernel), counting kernel launches and exception lanes,
   with the device's busy time read by ``torch.profiler`` (CUDA activity
   only); then a block with one corrupted signature and a block that
   spends an output twice must be rejected with the reference's error
   strings;
7. the node, on a copy of the chain: the port's ``Node`` serving HTTP on
   the standard library, ``device="cuda"``, configured by
   ``Config.load`` with ``UPOW_DEVICE_VERIFY_KERNEL=complete``.  A burst
   of 1,024 concurrent ``push_tx`` must all be accepted through the
   coalescing intake with the complete kernel launched and the Jacobian
   one not; the duplicate and a tampered tx must be rejected with the
   reference's strings; ``upow_tpu_torch.mine.miner.run(device="cuda",
   once=True)`` against the node must get its block accepted, emptying
   the pending set by the count it took;
8. ``push_block`` of the 8,160-tx block over HTTP, each on a fresh copy
   of the chain: to a node on the complete kernel (then the two tampered
   blocks must be rejected with their strings) and to one on the
   Jacobian kernel, with wall time, launches and the profiler's idle
   share;
9. kernel vs plain, the txid batch: the batched-digest kernel against its
   plain version and hashlib, bit for bit, on the accept's micro-batch
   shape (1,024 txs x 3 payloads: signing bytes, their hex form and the
   txid payload), on the sync page (every tx of the chain with the
   8,160-tx block) and on the padding edges (0, 1, 55, 56, 63, 64, 119,
   120 and 1,000 bytes); per bucket, launched alone, the kernel's time
   with 10 launches queued, the host pack, the host-to-device copy and
   hashlib on the same payloads; then each shape as the main path sends
   it, one ragged launch (``sha256_batch`` must make exactly one), its
   time with 10 queued and alone under the profiler, ``sha256_batch``
   whole on the host clock, and the longest message's chain floor (its
   compressions times one compression's SASS instructions at the maximum
   SM clock); and which backend ``auto`` picks for each shape; then
   ``txid_batch`` whole on the card against hashlib at 256 to 24,480
   payloads of the accept's mix, the measurement ``auto``'s size rule
   (``crypto.sha256.TXID_AUTO_DEVICE_MIN``) is set from;
10. chain sync: a port node on a fresh file syncs the whole chain (one
   page: blocks 1-4 with the 8,160-tx block) from the node that accepted
   the push_block under jac, over HTTP (``/sync_blockchain?node_url=``,
   ``txid_backend = device``, ``sync_fetch_interval = 0``), with one txid
   batch and one signature verify for the page; its tip and UTXO hash
   must equal the server's, the integrity-sample and host-retry counters
   must be 0; wall, launches, and the card's busy time and idle share;
11. reorg: a port node holding the 3-block prefix and its own block 4' (a
   coinbase mined on the card), ``sync_reorg_window = 2``, syncs from the
   same server: it must find block 3 in common, remove 4' and accept the
   8,160-tx block 4, ending on the server's tip and UTXO hash;
12. the hash rate: one template at difficulty 10 swept over all 2^32 - 1
   nonces through ``mine(job, "cuda", batch=2**24)``, with the card's
   busy time and idle share from the profiler; then a difficulty-6.3 job
   mined to a hit that hashlib checks;
13. kernel vs plain, the UTXO probe: the resident index's windowed sorted
   probe against its plain version run on the card, bit for bit on all
   five outputs, at 8,192 queries (one block's inputs) and 1,024 (one
   micro-batch) into 2^24 and 2^20 sorted random keys built on the card
   from a seeded generator (a mid-size chain's UTXO set: 402.7 MB
   resident), with planted cases (a 12-entry run on one high lane, 64-bit
   twins, a high lane of I32_MAX) and an empty and a one-row index, and
   on the fence's edges (a run of equal high lanes longer than the
   fence's stride across fence points, queries at every fence point and
   the row before it, 0, 1 and 3 * 2^shift + 5 live rows at explicit
   shifts); times with 10 launches queued on the index's path (prepared
   arguments, ``device_index.launch``) beside ``torch.searchsorted``
   alone on the same tensors in the same call, the kernel alone under
   the profiler, and the plain version's; the launch path piece by
   piece (``utxo_probe_launch_path``: host microseconds a call over
   1,000 calls, and the C side's lookup timed in C); the bound from the
   bytes the run's probes need (``probe_bytes_needed``), registers,
   local and shared bytes;
14. the resident accept: an in-memory copy of the accept's chain with
   2^20 synthetic rows added to ``unspent_outputs``,
   ``enable_device_index()`` and the first upload timed apart, then the
   8,160-tx block through ``BlockManager.create_block`` on the fused
   accept scan (one probe launch a micro-batch) under the profiler; the
   resident probe, the shadow map and SQL must agree on the spends, the
   creations and 16 absent outpoints after the accept, after
   ``remove_blocks(4)`` (the UTXO hash back to its value before) and
   after the same txs are accepted again in a new block; then the same
   block on a copy without the index (the SQL scan), whose UTXO hash
   must equal the resident accept's;
15. ``push_block`` of the 8,160-tx block over HTTP to a node started
   with ``UPOW_DEVICE_UTXO_INDEX=1`` on a fresh copy: accepted through
   the probe, the two tampered blocks rejected with their strings;
16. kernel vs plain, the Jacobian ladder at every other window the config
   admits (``jac_windows_kernel_vs_plain``, right after phase 3): kernel
   B7 (w = 5) and ROADMAP B7b's w = 2 and 3 (``csrc/p256_verify.cu``)
   and 6-13 (``csrc/p256_verify_wide.cu``, the Q tables in device
   memory, a signature's table built by up to 32 groups of four), each
   against its plain version on phase 3's 8,192 lanes and their first
   1,026, 33 and 1, bit for bit with the collision lanes flagged and
   every kind's verdict (the off-curve lanes include qy = 0 keys and
   order-3 keys of another curve); at 6-13 also with every G (1-32
   groups a signature) forced on the 1,026- and 33-lane inputs, every G
   timed on 1 to 2,052 lanes with valid keys (the accept's kind), and the
   groups the wrapper picks at each shape; times with 10 launches queued
   beside w = 4's in turns at 8,192, 1,026 and 1 lanes and on 1,026
   valid-key lanes (and at 6-13 the latter's and 1 lane's times with one
   group a signature, and their bounds); the bound (multiplies, and the
   Q tables' bytes at 6-13) and share; resources (the blocks an SM
   holds), and the scratch a launch allocates;
17. the accept at each of those windows (``main_path_windows``, with
   ``device_profile_w<w>``): ``device.verify_window = w`` applied through
   ``DeviceConfig.apply_kernel_overrides``, the 8,160-tx accept with
   launches at window w only, to the w = 4 accept's UTXO hash;
18. the sharded verify (``mesh_verify``): ``verify_packed_sharded`` with
   4 shards on the card equal to the unsharded launch lane for lane,
   times; the accept with ``verify_mesh_devices = 0`` (one card: no
   mesh) and with an explicit 4-shard mesh, each to the same UTXO hash;
19. the mesh search (``mesh_search``): ``MeshEngine`` on the visible
   cards and on an explicit 4-shard mesh on the card, against one
   ``pow_search`` launch and the plain search (a hit, a miss, a ragged
   round, empty shards, the top of the nonce space), shards that would
   wrap past 2^32, a 2^24 round on 4 shards against one launch, the
   engine's host time a round; then ``miner.run(device="mesh")`` against
   the port's node, its block accepted;
20. two processes on the one card (``multihost``, after phase 12)
   rendezvous over gloo, each mines its planned half of 2^26 nonces with
   B2, and an ``all_reduce(MIN)`` agrees on the winner of one search of
   the whole range;
21. the txid kernel on a ragged batch (``txid_ragged_kernel_vs_plain``,
   right after phase 13): 1,187 messages (one of every block count
   from 2 to 154, the padding edges and 1,024 of 1-4 blocks) in one
   launch, against its plain version on the card and hashlib;
22. gossip between node processes (``gossip_path``, after phase 11):
   node A (this process) and nodes B and C, each ``python -m
   upow_tpu_torch.node.run --device cuda`` in a process of its own on
   the card (its own verdict cache and launch counters), on copies of
   the chain, with no seed, their peer books in the work directory,
   ``node.self_url`` their own address and rate limits off.  B is added
   to A's book by ``/add_node`` beside a dead URL; the 8,160-tx block
   pushed to A reaches B through A's gossip, and B's ``/metrics`` must
   show kernel-1 batches on its card; 256 ``push_tx`` to A must reach
   B's pool, the same hashes; the dead peer's breaker must be open in
   A's ``/debug/breakers`` with no send to B cut at
   ``resilience.propagate_deadline``; C, seeded with A, bootstraps on
   one request with a non-local ``Host``: it must learn B, announce
   itself to A and sync with no ``node_url`` (kernel 1 and B5 on its
   card, ``device.txid_backend = device``).  A, B and C must end on one
   tip and UTXO hash; the hop's, the burst's and C's walls are printed.
   The block's push and hop are ``telemetry_path`` (phase 26).

23. the device runtime (``runtime_path``, after phase 22; ``--only
   runtime_path`` runs it alone on a block of 8,160 txs signed over
   synthetic outpoints): the runtime's arm on the card (platform, card,
   each kernel's warm launch with its status and seconds); 32 sources'
   batches of 256 lanes of phase 3's mix held and released, one
   dispatch, the verdicts of one direct ``run_sig_checks`` of the same
   checks; 64 B2 rounds of 2^24 nonces (source ``mine``) queued ahead of
   the block's micro-batches (source ``block``), held then released and
   then with the flood already on the card: the block's queue wait and
   its submit-to-verdicts time against one round's; a one-check batch
   through the runtime against the same kernel work called directly, and
   the bare queue and boxed hops, µs a call over 1,000 calls; a degrade
   round trip (``device.verify:error:times=3``, ``device_failure_limit =
   3``, a 1 s cooldown: three groups fail with the injected error, a
   fourth is blocked with ``DeviceBlocked`` and no launch, none is served
   on the host, then one re-probe launches kernel 1, gives the native
   batch's verdicts and restores ``ok``); the native batch on the card's host in sigs/s at
   8,192 and 1,024 checks against the pure-Python oracle on 64 (host
   figures, with the CPU model and thread count) and the ``cpu`` miner
   (``native``) equal to the plain search over 2^17 nonces.

24. the deployed layout on one card (``shared_card``, after phase 22):
   ``python -m upow_tpu_torch.node.run --device cuda`` and ``python -m
   upow_tpu_torch.mine.miner --device cuda`` as processes of their own,
   each with its own runtime and CUDA context.  The 8,160-tx block is
   pushed over HTTP to one node process and a fresh node process syncs
   it from that one, first with the card to themselves, then (on two
   more copies) while the miner sweeps full templates of 2^32 nonces.
   The miner takes its templates from a stub in this process at
   difficulty 10, so no sweep finds a block; the stub's template
   requests time the sweeps.  The walls, the sweep's GH/s alone and
   during each wall, and each node's kernel-1 and txid batches are
   printed; the four nodes must end on one tip and UTXO hash.

25. a node at w = 13 (``node_push_block_w13``): ``python -m
   upow_tpu_torch.node.run --device cuda`` with
   ``UPOW_DEVICE_VERIFY_WINDOW=13`` arms its runtime (every library, a
   warm launch at w = 13) and accepts the 8,160-tx push_block with
   launches at w = 13 only (its ``/metrics``), to the same UTXO hash; its
   arm is read from its ``/debug/events``.

26. telemetry (``telemetry_path``, inside phase 22): the 8,160-tx
   ``push_block`` to A under a request trace, gossiped to B, which
   captures it with ``torch.profiler`` through ``/debug/profile``
   (``profile.enabled``).  A's response must carry ``X-Upow-Trace`` and
   B's ``/debug/traces`` a ``http.push_block`` tree under that id; A's
   tree must hold ``block_accept``, ``block.sig_verify``,
   ``block.utxo_apply`` and the runtime's dispatches, its root within
   A's client wall and its children within the root.  Both nodes'
   ``/metrics`` must carry the 0.0.4 content type and pass the
   validator, ``kernel_p256_verify_lanes_real`` must equal the lanes
   A's kernel-1 launches carried (spied in this process), and on B lie
   within the lanes its captured launches' grids can carry,
   A's ``runtime_dispatches`` its runtime's count and, on A and B, the
   ``runtime.dispatch`` spans of the tree, ``device_verify_health``
   0, and the card's memory gauges (``device_gpu_0_*``) must be there,
   and absent from a ``--device cpu`` node process's scrape.  B's capture
   must report no error and list as many ``p256_verify_kernel`` launches
   as B's launch counter moved.  ``trace_split`` prints the trees of A's
   and B's push_block and of phase 24's push_block and sync (its sync
   node's ``/sync_blockchain`` tree) by span name.  Then
   ``tracing_cost`` (after phase 24): a node of this process with
   ``telemetry.trace_requests`` on and off in turns (on, off, off, on),
   each on a fresh copy, takes the 1,024-tx burst and the
   8,160-tx push_block; every wall is printed.
27. the node's operator surfaces (``surfaces``, inside phases 7 and 22;
   the read cache and ``/ws`` at their defaults, on): a ``/ws``
   subscriber (the port's stdlib ``ws_connect``, on a thread of its own)
   on phase 7's node and on node A, subscribed to both channels, must
   receive one ``new_transaction`` frame for each tx the 1,024-tx burst
   (kernels 3/4) and A's 256-tx burst admitted, with the same hashes,
   one ``new_block`` frame for the miner's block and exactly one for
   the 8,160-tx push_block to A (kernel 1), whose ``block_no`` and hash
   are A's tip, and no dropped message.  On A, ``get_block`` of the
   height to come, read twice before the push, must hit the read cache
   the second time (``upow_hotcache_hits_total`` up by 1); after the
   push the generation must have moved and the re-read must equal the
   ``X-Upow-Cache-Bypass`` body byte for byte.  A runs the watchtower
   at a 0.5 s interval: ``/debug/alerts`` must answer ``enabled`` with
   evaluations and nothing firing after the run, and ``/metrics`` must
   carry the ``alert_*`` families.  The line prints the frame counts,
   the burst walls with the subscriber connected, the cache's hits and
   misses and the watchtower's evaluations and ``eval_lag_seconds``.
28. the PostgreSQL backend (``pg``, after phase 15; no process and no
   chain build added): the port's node in this process on
   ``PgChainState`` over ``MockPgDriver(threadsafe=True)`` (the card's
   machine has no asyncpg and no server), injected as the JAX tests
   inject it, its resident index armed on the card and
   ``device.txid_backend = device``, with the reference schema's two
   indexes made in the mock's database.  The 3-block base comes in as a
   sync page (``create_blocks``); 256 of the block's txs are admitted by
   ``push_tx`` and must stand in the pg pending table; the 8,160-tx
   ``push_block`` over HTTP must answer ``{"ok": true}`` with B6, kernel
   1 and B5 launched, no shadow consult and the pending table empty,
   and its UTXO and full-state fingerprints must equal phase 15's node's
   file; the two tampered blocks must be rejected with their strings.
   B6 is held against its plain version and the three-way parity
   (probe, shadow map, pg's SQL) must hold after the accept, after
   ``check_replay_pg`` (which must give ``before == after``) and after
   ``remove_blocks(4)``, which must restore the pre-accept UTXO hash;
   then ``python -m upow_tpu_torch.state.reindex --db <phase 15's file>
   --check`` must exit 0.  The line's walls are host walls on the mock
   driver over sqlite, not on a PostgreSQL server.
29. the wallet (``wallet_path``, after phase 7; no chain build added): a
   port node on a fresh copy of the chain's file, ``device.sig_backend =
   device``, in a work directory whose ``key_pair_list.json`` holds the
   chain's key (the script changes into it for the phase and back; no
   keystore is written into the repo).  64 ``/send_to_address``
   requests from localhost, one after another, to a fresh address must
   each answer ``{"ok": true}``; then one ``python -m
   upow_tpu_torch.wallet.cli send`` in a subprocess (``--db`` the node's
   file, ``--node`` its URL) and one ``NodelessWallet.send`` to the node
   must be accepted.  The pool must hold all 66, admitted with kernel-1
   launches and no batch served on the host; ``miner.run(device="cuda",
   once=True)`` must get a block of the 66 accepted with B2 launched,
   and the recipient's ``get_address_info`` balance must be the sum
   sent.  Host walls.
30. snapshots (``snapshot``, after phase 15; no chain build added): node
   S serves a copy of phase 15's file (the chain with the 8,160-tx
   block) with ``snapshot.dir`` set and builds one generation of 64 KiB
   chunks; node R starts on an empty file with ``device.utxo_index`` on,
   ``device.txid_backend = device`` and its own ``snapshot.dir`` and
   restores with ``bootstrap_from_snapshot(sources=[S])`` over HTTP.
   The result must be a snapshot restore (not ``replay_fallback``), R's
   UTXO and full-state fingerprints S's, and R's index, rebuilt on the
   card inside the restore, must hold against its plain version and
   against R's SQL (probe, shadow map, SQL); R must reject the two
   tampered blocks with their strings; an honest block of 1,024 spends
   of the big block's outputs, mined on R's tip, must be accepted by R
   (B6, kernel 1 and B5 launched, no shadow consult) and by S, to equal
   UTXO hashes.  Host walls: the build's, the restore's and the re-arm's.
31. the cold-block archive (``archive``, after phase 30): node A in this
   process on a copy of phase 15's file, ``device="cuda"``, its resident
   index on, ``device.txid_backend = device``, ``snapshot.dir`` and
   ``archive.dir`` in the work directory and the archive's default
   ``segment_blocks`` 256 and ``safety_window`` 64.  A block of txs of
   up to 255 inputs (signed on the host) spends every output of blocks
   1-4 still unspent, then coinbase-only blocks take the chain to height
   322, each mined by ``mine(job, "cuda")`` (the clock 60 s a block, so
   the retargets keep the difficulty) and pushed by ``push_block`` over
   HTTP; ``build_snapshot()`` and ``compact_archive()`` must report one
   segment built, [1, 256] archived and blocks 1-4 (the 8,160-tx block
   among them) pruned, the hot row counts dropping by the pruned counts;
   ``/archive/manifest`` and ``/archive/segment/0`` must answer, the
   segment's bytes hashing to its record.  The 8,160-tx block by height,
   by hash and its details, two of its txs, a page across the seam and
   the chain key's history deep in the archived span must answer byte
   for byte as a twin port node on a copy of A's file taken before the
   compaction, with reads served from the segment; A's index must hold
   against its plain version and its SQL (probe, shadow map, SQL) after
   the prune, and A's next block (spends of the 33 consolidated outputs
   and of 64 coinbases) must be accepted with B6, kernel 1 and B5
   launched and no shadow consult, the index holding after it.  Node J
   (empty file, index on, ``txid_backend = device``) syncs from genesis
   off A, its first blocks served from A's segment, to A's tip, UTXO and
   full-state fingerprints with kernel 1 and B5 launched and neither
   host fallback counter; node M mirrors A's archive by
   ``fetch_archive_from_peer`` to byte-identical segment files, and a
   second fetch reuses the segment.  Host walls.
32. the swarm's scenarios (``swarm``, last in the work directory's block;
   no chain build added): ``run_matrix("fast", seed=7,
   device="cpu")``, the ten scenarios with the JAX swarm's configuration
   on the host, then the same ten with the nodes on the card and each
   scenario's ``cfg_hook`` wrapped (a ``dataclasses.replace`` of its
   frozen spec) to set ``device.sig_backend`` and
   ``device.txid_backend`` to ``device``, ``device.txid_min_batch`` to 1
   and ``device.utxo_index`` on: every fingerprint and the matrix's the
   host's, every core flag true, neither host fallback counter in any
   node's registry, and kernel 1, B5 and B6 launched.  partition_heal at
   50 nodes and seed 3 on the host and on the card: equal cores, and
   before the card swarm closes every node's UTXO fingerprint node 0's
   and the host run's, every node's index held against its plain
   version and its SQL.  The scenarios' deterministic worlds freeze the
   clock and reset the telemetry; the path puts back the frozen clock it
   found.  Then ``python -m upow_tpu_torch.swarm --matrix fast``,
   ``python -m upow_tpu_torch.telemetry.selfcheck`` and ``python -m
   upow_tpu_torch.fleet --check-determinism``, with no ``--device``, as
   processes of their own at once: each exits 0, the matrix's
   fingerprint the host run's.  Host walls.

Every path runs through the device runtime (``device/runtime.py``): the
script arms a fresh runtime before each path, its warm launches before
any count is reset (``runtime_arm`` prints the first), and fails when
the verify path's degrade (``txverify.DEGRADE``) recorded any failure
after a path other than ``runtime_path``'s fault phase, with the
recorded error; the node processes of phase 22 report theirs on
``/metrics`` (``device_verify_health``, ``resilience_device_error``).
The sweep (phase 12) is timed through the runtime and in direct-launch
turns in the same call (``hashrate_turns``), and
``walls_vs_before_runtime`` prints this run's walls beside those of the
last run before the runtime.

The line before the last is the kernels' JSON record; each kernel's
``launches`` is one path's own count (the accept's for the Jacobian
kernel, each other window's accept for its record (B7's at w = 5), the
HTTP push_block's under complete
for the complete kernel, ``miner.run``'s for the sha256 search kernel,
the sync's for the txid kernel, the resident accept's for the probe
kernel, the 4-shard accept's for the sharded verify and the mesh
miner's for the mesh search), and ``launches_by_path`` gives each path
it ran on (the complete kernel's; kernel 1's, B5's and B6's with phase
28's push_block and phase 30's honest block on the restored node; kernel
1's and B2's with phase 29's sends and block; kernel 1's, B2's, B5's and
B6's with phase 31's ``archive`` path, from the extension through J's
sync; kernel 1's, B5's, B6's and the complete kernel's with phase 32's
card swarms, the checks' own launches left out).  Every phase that can
reach the txid batch (6, 7, 8, 10, 11, 14, 15, 17, 18, 22, 25, 28, 30,
31 and 32) counts
its txid kernel launches and fails if hashlib stood in for a device
digest there (``txid.sample_mismatch`` or ``sync.host_txid_retry`` above
0; in phase 22 read from each node's ``/metrics``, in phase 32 from
each swarm node's registry).
The last is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits non-zero and prints no result.

    python3 chip_smoke.py --only utxo_probe

runs the card line, the build and the named kernel phases alone (a
comma-separated list of ``KERNEL_PHASES``: ``utxo_probe``,
``jac_windows``, ``txid_ragged``, ``runtime_path``, ``swarm_path``) and
prints no result.

    python3 chip_smoke.py --sass LIB.so [LIB.so ...]

prints each kernel function of built libraries with its SASS instruction
count and a digest of their text (two builds of the same kernel code give
the same line), and needs no card.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import platform
import random
import re
import shutil
import signal
import socket
import sqlite3
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from decimal import Decimal
from urllib.parse import quote, urlencode

import numpy as np
import torch

from upow_tpu_torch import _build, device as tdevice, native, trace
from upow_tpu_torch.config import Config, DeviceConfig, LogConfig
from upow_tpu_torch.core import clock, curve, point_to_string
from upow_tpu_torch.core.constants import (
    CURVE_B, CURVE_GX, CURVE_GY, CURVE_N, CURVE_P)
from upow_tpu_torch.core.header import split_block_content
from upow_tpu_torch.core.difficulty import (
    START_DIFFICULTY, charset_count, check_pow_hash)
from upow_tpu_torch.core.merkle import merkle_root
from upow_tpu_torch.core.tx import Tx, TxInput, TxOutput
from upow_tpu_torch.crypto import p256, sha256 as tsha
from upow_tpu_torch.device import runtime as truntime
from upow_tpu_torch.mine import engine as mine_engine, miner
from upow_tpu_torch.mine import mesh_engine
from upow_tpu_torch.node.app import Node
from upow_tpu_torch.node.http import WSMsgType, fetch, ws_connect
from upow_tpu_torch.parallel import mesh as pmesh
from upow_tpu_torch.resilience import DeviceBlocked, faultinject
from upow_tpu_torch.logger import setup_logging
from upow_tpu_torch.state import ChainState, device_index as tdi
from upow_tpu_torch.state.pg import PG_SCHEMA, PgChainState
from upow_tpu_torch.state.pgdriver import MockPgDriver
from upow_tpu_torch.state.reindex import check_replay_pg
from upow_tpu_torch.swarm import scenarios as tsc
from upow_tpu_torch.telemetry import exposition
from upow_tpu_torch.verify import BlockManager, txverify
from upow_tpu_torch.wallet.nodeless import NodelessWallet

KERNELS = ["p256_verify", "p256_verify_wide", "p256_complete",
           "sha256_search", "sha256_blocks", "utxo_probe"]
LANES = 8192
FAN, PER = 255, 32          # 8,160 leaf spends: one full block
GENESIS_PREV = (18_884_643).to_bytes(32, "little").hex()
SEARCH_BATCH = 1 << 24      # the miner's dispatch (config device.search_batch)
BURST = 1024                # concurrent push_tx in the node's burst
GOSSIP_BURST = 256          # push_tx to node A gossiped to node B
MICROBATCH = 1024           # txs per check_block micro-batch (the default)
TXID_EDGES = [0, 1, 55, 56, 63, 64, 119, 120, 1000]
# payload counts of the txid batch's card-against-hashlib sweep
TXID_SWEEP = [256, 512, 1024, 2048, 3072, 4096, 6144, 8192, 12288, 16384]
# (live keys, capacity) of the probe phase: full lanes, and pad rows as
# the resident accept's index holds them (about 2^20 live at 2^21)
PROBE_SHAPES = [(1 << 24, 1 << 24), (1 << 20, 1 << 20),
                ((1 << 20) + 8163, 1 << 21)]
PROBE_QUERIES = [8192, 1024]      # one block's inputs, one micro-batch's
PROBE_SEED = 0xB6
SYNTH_ROWS = 1 << 20              # synthetic UTXOs of the resident accept
ABSENT = [("ff" * 32, i) for i in range(16)]
I32_MAX = 2 ** 31 - 1
KEY_SEED = 0xACC7           # the chain's and the miner's key
SENTINEL = int(tsha.SENTINEL)
# the verdict every lane of a kind in signature_mix must get
VERDICTS = {"valid": 1, "big_digest": 1, "big_coord": 1, "bad_s": 0,
            "off_curve": 0, "zero_pub": 0}
# charset size -> the fractional part of the difficulty that gives it
FRAC_OF_CHARSET = {charset_count(f"1.{d}"): f".{d}" for d in range(1, 10)}
# H100: 64 32-bit integer multiply(-add)s per SM per clock, and 64 32-bit
# integer adds, shifts and bitwise operations (CUDA C Programming Guide,
# arithmetic instruction throughput, compute capability 9.0).  Shifts and
# logic run on the ALU pipe alone; an add may also issue as IMAD on the
# FMA pipe, so integer work as a whole gets at most 128 a clock, which is
# also the issue rate of the SM's 4 schedulers of 32 threads.
IMUL_PER_SM_CLK = 64
INT_OPS_PER_SM_CLK = 64
INT_ISSUE_PER_SM_CLK = 128
HBM_BYTES_S = 3.35e12       # H100 SXM data sheet


# one SASS instruction in cuobjdump's listing: address, predicate, opcode
# (modifiers dropped), operands
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?"
                       r"([A-Z][A-Z0-9_]*)[A-Z0-9_.]*([^;]*);")
# the whole text of one SASS instruction, predicate and modifiers included
SASS_TEXT = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);")


def phase(title: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"phase {title}: {body}", flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


# --- phase 3 inputs --------------------------------------------------------

def host_digest_fallbacks(where: str) -> dict:
    """The two counters that say hashlib stood in for a wrong device
    digest (the txid batch's integrity sample, the sync's merkle retry),
    counted since the phase's ``trace.reset()``; fails on either."""
    counters = {k: trace.counters().get(k, 0) for k in (
        "txid.sample_mismatch", "sync.host_txid_retry")}
    if any(counters.values()):
        fail(f"{where}: hashlib stood in for device digests: {counters}")
    return counters


def order3_key(rng: random.Random) -> tuple:
    """A point of order 3 on y^2 = x^3 - 3x + b' for some b' != b (x a
    root of the 3-division polynomial 3x^4 - 18x^2 + 12 b' x - 9): off
    P-256, and a key on which the wide kernel's segmented Q-table build
    would flip an exception bit (tests/test_torch_p256_wide_coop.py)."""
    while True:
        x = rng.randrange(2, CURVE_P)
        b2 = (9 + 18 * x * x - 3 * x ** 4) * pow(12 * x, -1, CURVE_P) % CURVE_P
        rhs = (x ** 3 - 3 * x + b2) % CURVE_P
        y = pow(rhs, (CURVE_P + 1) // 4, CURVE_P)
        if y and y * y % CURVE_P == rhs and b2 != CURVE_B:
            return x, y


# the order-3 lanes' Q digit at w = 6, 7 and 8: a power of two that starts
# a segment of the wide kernel's 31-segment split (G = 32)
ORDER3_DIGITS = {6: 4, 7: 32, 8: 128}


def signature_mix(n: int, seed: int = 0x5A17):
    """(digests, sigs, pubs, kinds): a block's worth of signature lanes.
    Of the off-curve lanes (one in 32) every fourth, from the first, has a
    qy = 0 key, and every fourth from the third a key of order 3 on
    another curve with s = 1 and its Q digit at w = 6, 7 or 8 (in turns)
    set twice."""
    rng = random.Random(seed)
    order3 = order3_key(rng)
    keys = [curve.keygen(rng=rng.randrange(1, CURVE_N)) for _ in range(64)]
    G = curve.G
    neg = lambda P: (P[0], CURVE_P - P[1])  # noqa: E731
    digests, sigs, pubs, kinds = [], [], [], []

    def add(kind, digest, sig, pub):
        digests.append(digest)
        sigs.append(sig)
        pubs.append(pub)
        kinds.append(kind)

    crafted = [(3, 3, G), (7, 7, G), (3, 3, neg(G)),
               (0x10, 0x01, neg(curve.point_mul(16, G)))]
    for i in range(n):
        d, pub = keys[i % len(keys)]
        msg = i.to_bytes(4, "big") + b"chip smoke"
        digest = hashlib.sha256(msg).digest()
        sel = i % 32
        if sel < 22:
            add("valid", digest, curve.sign(msg, d), pub)
        elif sel < 25:
            r, s = curve.sign(msg, d)
            add("bad_s", digest, (r, (s + 1) % CURVE_N), pub)
        elif sel == 25:  # r + n < p: small r, s = 1 (digits chosen)
            add("r_plus_n", rng.randrange(1 << 200).to_bytes(32, "big"),
                (rng.randrange(1, 1 << 200), 1), pub)
        elif sel == 26 and i // 32 % 4 == 0:
            add("off_curve", digest, curve.sign(msg, d), (CURVE_GX + i, 0))
        elif sel == 26 and i // 32 % 4 == 2:
            w = 6 + i // 128 % 3
            top = w * (p256.rounds(w) - 1)
            r = ORDER3_DIGITS[w] << (top - 2 * w) \
                | ORDER3_DIGITS[w] << (top - 5 * w)
            add("off_curve", ((1 << 250) | i).to_bytes(32, "big"), (r, 1),
                order3)
        elif sel == 26:
            add("off_curve", digest, curve.sign(msg, d),
                (CURVE_GX, CURVE_GY + 1 + i))
        elif sel == 27:
            add("zero_pub", digest, curve.sign(msg, d), (0, 0))
        elif sel == 28:  # oversized digest: z reduced mod n on the host
            big = hashlib.sha512(msg).digest()
            z = int.from_bytes(big, "big") % CURVE_N
            k = rng.randrange(1, CURVE_N)
            r = curve.point_mul_G(k)[0] % CURVE_N
            s = pow(k, -1, CURVE_N) * (z + r * d) % CURVE_N
            add("big_digest", big, (r, s), pub)
        elif sel == 29:  # x + p (reduced on the card) or x + 2p (host)
            x = pub[0] + CURVE_P if pub[0] + CURVE_P < (1 << 256) \
                else pub[0] + 2 * CURVE_P
            add("big_coord", digest, curve.sign(msg, d), (x, pub[1]))
        else:
            z, r, Q = crafted[(i // 32) % len(crafted)]
            add("collision", z.to_bytes(32, "big"), (r, 1), Q)
    return digests, sigs, pubs, kinds


def cuda_ms(fn, reps: int, warm: int = 2, per: int = 1) -> float:
    """Median milliseconds of one ``fn`` over ``reps`` CUDA-event timings,
    each of ``per`` calls queued back to back (so that, for a kernel
    much longer than its launch, the host's launch time hides behind
    the card's work)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def kernel_phase(dev: torch.device, mix: tuple) -> dict:
    t0 = time.perf_counter()
    digests, sigs, pubs, kinds = mix
    fused, zs, rs, ss, qxs, qys = p256._pack_device_inputs(
        digests, sigs, pubs, LANES)
    packed = p256.packed_tensor(fused, dev)
    setup_s = time.perf_counter() - t0

    got = p256.verify_packed(packed)
    torch.cuda.synchronize()
    plain = p256.verify_plain(packed)
    torch.cuda.synchronize()
    if got.shape != (LANES,) or got.dtype != torch.int32:
        fail(f"kernel output {tuple(got.shape)} {got.dtype}")
    max_abs_err = int((got.long() - plain.long()).abs().max())
    if not torch.equal(got, plain):
        bad = torch.nonzero(got != plain).flatten()[:8].tolist()
        fail(f"kernel != plain on {int((got != plain).sum())} lanes, "
             f"first {bad}")
    bits = got.cpu().numpy()
    exc = [i for i in range(LANES) if bits[i] & 2]
    expect_exc = {i for i, k in enumerate(kinds) if k == "collision"}
    if not expect_exc <= set(exc):
        fail("crafted collision lanes were not flagged")
    sample = sorted(set(random.Random(7).sample(range(LANES), 96))
                    | set(exc[:32]))
    for i in sample:
        if i in exc:
            continue  # the host oracle decides those lanes
        want = p256._host_verify_prehashed(zs[i], rs[i], ss[i], qxs[i], qys[i])
        if bool(bits[i] & 1) != want:
            fail(f"lane {i} ({kinds[i]}): kernel {bits[i] & 1}, host {want}")
    for i, kind in enumerate(kinds):
        want = VERDICTS.get(kind)
        if want is not None and (bits[i] & 1) != want:
            fail(f"lane {i} ({kind}): verdict {bits[i] & 1}")

    # the main path's launch shapes: a 1,024-check micro-batch plus the
    # two canaries (32 full blocks of 32 signatures and a 2-signature
    # edge), and a pass-2 retry of a single lane; and 33 lanes, one live
    # group in a second block; each must equal the plain version's lanes
    shapes = {}
    for width in (1026, 33, 1):
        part = packed[:, :width].contiguous()
        got_part = p256.verify_packed(part)
        if not torch.equal(got_part, plain[:width]):
            fail(f"kernel != plain at the {width}-lane launch shape")
        shapes[width] = part

    ms = cuda_ms(lambda: p256.verify_packed(packed), reps=30, warm=3)
    ms_queued = cuda_ms(lambda: p256.verify_packed(packed), reps=5, per=10)
    ms_1026 = cuda_ms(lambda: p256.verify_packed(shapes[1026]), reps=10)
    ms_1 = cuda_ms(lambda: p256.verify_packed(shapes[1]), reps=10)
    plain_ms = cuda_ms(lambda: p256.verify_plain(packed), reps=2, warm=0)

    props = torch.cuda.get_device_properties(dev)
    clock_mhz = tdevice.max_sm_clock_mhz() or props.clock_rate / 1000
    # the least multiply operations these lanes need (crypto/p256.py
    # MUL_OPS): 36 wide products a squaring, none to reduce mod p
    ops = p256.mul_ops_needed(zs, rs, ss, qxs, qys)
    ops_ms = ops / (props.multi_processor_count * IMUL_PER_SM_CLK
                    * clock_mhz * 1e6) * 1e3
    nbytes = LANES * (p256.PACKED_ROWS * 4 + 4)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    phase("kernel_vs_plain", lanes=LANES, equal=True,
          equal_shapes=json.dumps(sorted(shapes)),
          exception_lanes=len(exc), sampled_vs_host=len(sample),
          ms=round(ms, 4), ms_10_queued=round(ms_queued, 4),
          ms_1026_lanes=round(ms_1026, 4),
          ms_1_lane=round(ms_1, 4), plain_ms=round(plain_ms, 1),
          bound_ms=round(bound_ms, 4), bound_share=round(bound_ms / ms, 4),
          sms=props.multi_processor_count, clock_mhz=clock_mhz,
          int_mul_ops=ops, setup_s=round(setup_s, 1),
          **p256.kernel_attributes("p256_verify", dev))
    return {"name": "p256_verify", "route": "cuda",
            "source": "upow_tpu_torch/csrc/p256_verify.cu",
            "replaces": "upow_tpu/crypto/p256.py:1016",
            "launches": 0, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None}


def complete_phase(dev: torch.device, mix: tuple) -> dict:
    """The complete-formula kernel against its plain version and against
    the Jacobian path's final verdicts (its exception lanes decided by
    the host oracle), on every lane of the mix and at the main path's
    launch shapes; times and the bound."""
    digests, sigs, pubs, kinds = mix
    fused, zs, rs, ss, qxs, qys = p256._pack_device_inputs(
        digests, sigs, pubs, LANES)
    packed = p256.packed_tensor(fused, dev)
    got = p256.verify_complete_packed(packed)
    torch.cuda.synchronize()
    plain = p256.verify_complete_plain(packed)
    torch.cuda.synchronize()
    if got.shape != (LANES,) or got.dtype != torch.int32:
        fail(f"complete kernel output {tuple(got.shape)} {got.dtype}")
    max_abs_err = int((got.long() - plain.long()).abs().max())
    if not torch.equal(got, plain):
        bad = torch.nonzero(got != plain).flatten()[:8].tolist()
        fail(f"complete kernel != plain on {int((got != plain).sum())} "
             f"lanes, first {bad}")
    if bool((got & 2).any()):
        fail("the complete kernel set an exception bit")
    saved = p256.VERIFY_KERNEL
    p256.VERIFY_KERNEL = "jac"
    jac = p256.verify_batch_prehashed(digests, sigs, pubs, device=dev)
    p256.VERIFY_KERNEL = saved
    verdicts = (got & 1).bool().cpu().numpy()
    if verdicts.tolist() != jac.tolist():
        lanes = [i for i in range(LANES) if verdicts[i] != jac[i]][:8]
        fail(f"complete kernel != the Jacobian path's verdicts at {lanes}")
    collisions = [i for i, k in enumerate(kinds) if k == "collision"]
    for i in collisions[:16]:
        want = p256._host_verify_prehashed(zs[i], rs[i], ss[i], qxs[i], qys[i])
        if bool(verdicts[i]) != want:
            fail(f"collision lane {i}: complete {verdicts[i]}, host {want}")
    shapes = {}
    for width in (1026, 33, 1):
        part = packed[:, :width].contiguous()
        if not torch.equal(p256.verify_complete_packed(part), plain[:width]):
            fail(f"complete kernel != plain at the {width}-lane launch shape")
        shapes[width] = part

    ms = cuda_ms(lambda: p256.verify_complete_packed(packed), reps=5, warm=2,
                 per=10)
    ms_1026 = cuda_ms(lambda: p256.verify_complete_packed(shapes[1026]),
                      reps=5, per=10)
    ms_1 = cuda_ms(lambda: p256.verify_complete_packed(shapes[1]), reps=5,
                   per=10)
    plain_ms = cuda_ms(lambda: p256.verify_complete_plain(packed), reps=1,
                       warm=0)
    props = torch.cuda.get_device_properties(dev)
    clock_mhz = tdevice.max_sm_clock_mhz() or props.clock_rate / 1000
    ops = p256.mul_ops_needed(zs, rs, ss, qxs, qys, kernel="complete")
    ops_ms = ops / (props.multi_processor_count * IMUL_PER_SM_CLK
                    * clock_mhz * 1e6) * 1e3
    bytes_ms = LANES * (p256.PACKED_ROWS * 4 + 4) / HBM_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    phase("complete_kernel_vs_plain", lanes=LANES, equal=True,
          equal_to_jac_path=True, collision_lanes=len(collisions),
          accepted=int(verdicts.sum()), ms=round(ms, 4),
          ms_1026_lanes=round(ms_1026, 4), ms_1_lane=round(ms_1, 4),
          plain_ms=round(plain_ms, 1), bound_ms=round(bound_ms, 4),
          bound_share=round(bound_ms / ms, 4), int_mul_ops=ops,
          sms=props.multi_processor_count, clock_mhz=clock_mhz,
          **p256.kernel_attributes("p256_complete", dev))
    return {"name": "p256_complete", "route": "cuda",
            "source": "upow_tpu_torch/csrc/p256_complete.cu",
            "replaces": "upow_tpu/crypto/p256.py:548",
            "launches": 0, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None}


# --- phase 4: sha256 kernel vs plain ----------------------------------------

def brute(prefix: bytes, prev: str, diff: str, base: int, count: int,
          limit: int = 1 << 16):
    """The least hit by hashlib in [base, base + count), or None where the
    range is longer than ``limit`` and holds no hit within it."""
    for n in range(base, base + min(count, limit)):
        h = hashlib.sha256(prefix + n.to_bytes(4, "little")).hexdigest()
        if check_pow_hash(h, prev, diff):
            return n
    return SENTINEL if count <= limit else None


def sha_cases(rng: random.Random):
    """(name, prefix, previous hash, difficulty, base, count)."""
    def hexs(n):
        return bytes(rng.randrange(256) for _ in range(n)).hex()

    v2 = bytes.fromhex(hexs(104))
    v1 = bytes.fromhex(hexs(134))
    prev = hexs(32)
    cases = []
    for tag, prefix in (("v2", v2), ("v1", v1)):
        for diff in ("1", "2", "3", "4", "5", "1.1", "2.3", "3.9"):
            cases.append((f"{tag}_d{diff}", prefix, prev, diff,
                          rng.randrange(1 << 31), 1 << 20))
    cases.append(("miss_d12", v2, prev, "12", 0, 1 << 22))
    # dense: the previous hash ends in the first lane's leading hex
    # char, so hits are 1 in 16 and the minimum is the first lane
    base = rng.randrange(1 << 31)
    first = hashlib.sha256(v2 + base.to_bytes(4, "little")).hexdigest()
    cases.append(("dense_first_lane", v2, prev[:-1] + first[0], "1", base,
                  1 << 22))
    # the charset edge: the first lane matches the one-char prefix and its
    # next nibble EQUALS the charset size, so it is no hit
    base = rng.randrange(1 << 31)
    while True:
        h = hashlib.sha256(v2 + base.to_bytes(4, "little")).hexdigest()
        if int(h[1], 16) in FRAC_OF_CHARSET:
            break
        base += 1
    cases.append(("charset_edge", v2, prev[:-1] + h[0],
                  "1" + FRAC_OF_CHARSET[int(h[1], 16)], base, 1 << 22))
    for count in (1, 127, (1 << 24) - 1):
        cases.append((f"ragged_{count}", v1, prev, "5",
                      rng.randrange(1 << 31), count))
    for diff, count in (("3", (1 << 22) + 3), ("1.3", 1000)):
        cases.append((f"ends_at_2^32-1_d{diff}", v2, prev, diff,
                      (1 << 32) - 1 - count, count))
    return cases


def sha_phase(dev: torch.device, addr: str) -> dict:
    rng = random.Random(0x5EA)
    worst, checked, hits = 0, 0, 0
    cases = sha_cases(rng)
    for name, prefix, prev, diff, base, count in cases:
        template = tsha.make_template(prefix)
        target = tsha.pack_target(tsha.target_spec(prev, diff))
        got = int(tsha.pow_search(template, target, base, count, device=dev))
        plain = int(tsha.pow_search_plain(template, target, base, count, dev))
        worst = max(worst, abs(got - plain))
        if got != plain:
            fail(f"sha256 {name}: kernel {got}, plain {plain}")
        want = brute(prefix, prev, diff, base, count)
        if want is not None:
            checked += 1
            if want != got:
                fail(f"sha256 {name}: kernel {got}, hashlib {want}")
        if name.startswith("miss") and got != SENTINEL:
            fail(f"sha256 {name}: a hit at {got}, expected none")
        if name.startswith("dense") and got != base:
            fail(f"sha256 {name}: {got}, expected the first lane {base}")
        if name == "charset_edge" and got == base:
            fail(f"sha256 {name}: the first lane {base} reported as a hit")
        hits += got != SENTINEL

    # the miner's dispatch shape: 16 consecutive 2^24-nonce rounds of one
    # v2 template at difficulty 5
    job = mine_engine.MiningJob.from_header_fields(
        previous_hash=random.Random(5).randbytes(32).hex(),
        address=addr, merkle_root=hashlib.sha256(b"").hexdigest(),
        timestamp=1_760_000_000, difficulty="5")
    template = tsha.make_template(job.prefix)
    target = tsha.pack_target(tsha.target_spec(job.previous_hash, "5"))
    rounds = []
    for r in range(16):
        base = r * SEARCH_BATCH
        got = int(tsha.pow_search(template, target, base, SEARCH_BATCH,
                                  device=dev))
        plain = int(tsha.pow_search_plain(template, target, base,
                                          SEARCH_BATCH, dev))
        if got != plain:
            fail(f"sha256 round {r}: kernel {got}, plain {plain}")
        if got != SENTINEL and not job.check(got):
            fail(f"sha256 round {r}: {got} fails the hashlib check")
        rounds.append(got)

    # time one 2^24 dispatch of the sweep's template (difficulty 10: no
    # hit, so every nonce is needed)
    sweep = sweep_job(addr)
    template = tsha.make_template(sweep.prefix)
    target = tsha.pack_target(tsha.target_spec(sweep.previous_hash,
                                               sweep.difficulty))
    if int(tsha.pow_search(template, target, 0, SEARCH_BATCH, device=dev)) \
            != SENTINEL:
        fail("the sweep template hit in its first round; pick another seed")
    ms = cuda_ms(lambda: tsha.pow_search(template, target, 0, SEARCH_BATCH,
                                         device=dev), reps=10, warm=3, per=10)
    plain_ms = cuda_ms(lambda: tsha.pow_search_plain(
        template, target, 0, SEARCH_BATCH, dev), reps=3, warm=1)
    # the launch path on the host: a 256-nonce round's pow_search call
    # (the output's fill, the argument block and the ctypes launch; no
    # CUDA runtime query, the wave is cached a device), then one
    # synchronisation
    launch_us = us_per_call(lambda: tsha.pow_search(
        template, target, 0, 256, device=dev), 1000)
    torch.cuda.synchronize()
    props = torch.cuda.get_device_properties(dev)
    clock_mhz = tdevice.max_sm_clock_mhz() or props.clock_rate / 1000
    alu, add = tsha.ops_per_nonce(template, target)
    clocks = max(alu / INT_OPS_PER_SM_CLK, (alu + add) / INT_ISSUE_PER_SM_CLK)
    ops_ms = clocks * SEARCH_BATCH / (props.multi_processor_count
                                      * clock_mhz * 1e6) * 1e3
    bytes_ms = (tsha.ARG_WORDS * 4 + 8) / HBM_BYTES_S * 1e3
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    phase("sha256_kernel_vs_plain", cases=len(cases),
          equal=True, hashlib_checked=checked, hits=hits,
          rounds_2e24=len(rounds), round_hits=sum(h != SENTINEL for h in rounds),
          ms=round(ms, 4), mh_s=round(SEARCH_BATCH / ms / 1e3, 1),
          plain_ms=round(plain_ms, 1), bound_ms=round(max(ops_ms, bytes_ms), 4),
          bound_share=round(max(ops_ms, bytes_ms) / ms, 4), bound_by=bound_by,
          alu_ops_per_nonce=alu, add_ops_per_nonce=add,
          sms=props.multi_processor_count, clock_mhz=clock_mhz,
          launch_path_us=round(launch_us, 3))
    return {"name": "sha256_search", "route": "cuda",
            "source": "upow_tpu_torch/csrc/sha256_search.cu",
            "replaces": "upow_tpu/crypto/sha256.py:344",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": bound_by, "library_ms": None}


def sweep_job(addr: str) -> "mine_engine.MiningJob":
    """The hash-rate template: difficulty 10 (one hit in about 1.1e12
    nonces, so a sweep of 2^32 - 1 almost surely finds none)."""
    return mine_engine.MiningJob.from_header_fields(
        previous_hash=random.Random(10).randbytes(32).hex(), address=addr,
        merkle_root=hashlib.sha256(b"sweep").hexdigest(),
        timestamp=1_760_000_000, difficulty="10")


# --- phases 5 and 6: the accept path and the node ------------------------

class Kit:
    """The chain's key: its spends, and headers mined on a manager's tip
    by the port's miner on the card at the chain's own difficulty."""

    def __init__(self, key: tuple):
        self.d, self.pub = key
        self.addr = point_to_string(self.pub)
        self.mined = []  # MineResult of every header mined

    def spend(self, outpoints, outs) -> Tx:
        return Tx([TxInput(h, i) for h, i in outpoints], outs).sign(
            [self.d], lambda _i: self.pub)

    async def header(self, manager: BlockManager, txs) -> str:
        diff, last = await manager.calculate_difficulty()
        prev = last["hash"] if last else GENESIS_PREV
        job = mine_engine.MiningJob.from_header_fields(
            previous_hash=prev, address=self.addr,
            merkle_root=merkle_root(txs), timestamp=clock.timestamp(),
            difficulty=diff)
        if not last:
            return job.block_content(0)  # genesis: no PoW
        res = mine_engine.mine(job, "cuda", batch=SEARCH_BATCH)
        if res.nonce is None:
            fail(f"no nonce found at difficulty {diff}")
        self.mined.append(res)
        return job.block_content(res.nonce)

    def tampered(self, leaves) -> tuple:
        """Candidates on the tip after the big block: 1,024 spends of its
        outputs with one corrupted signature, and half of them plus a
        second spend of an output."""
        new_outs = [(t.hash(), 0, t.outputs[0].amount) for t in leaves[:1024]]
        cand = [self.spend([(h, i)], [TxOutput(self.addr, a)])
                for h, i, a in new_outs]
        bad = cand[len(cand) // 2]
        r, s = bad.inputs[0].signature
        bad.inputs[0].signature = (r, (s + 1) % CURVE_N)
        bad._hex_cache.pop(True, None)
        bad._hash = None
        twin = self.spend([new_outs[0][:2]], [TxOutput(self.addr, 1)])
        return cand, cand[:len(cand) // 2] + [twin]


KERNEL_NAMES = {"jac": "p256_verify_kernel",
                "complete": "p256_complete_kernel"}
REJECTED = ["signature verification failed",
            "double spend in block: 5 (unspent_outputs)"]


async def build_chain(dev: torch.device, kit: Kit, path: str,
                      fan: int = FAN, per: int = PER) -> tuple:
    """A 3-block chain fanning one coinbase into fan x per outputs, in a
    sqlite file; returns (the leaf spends, the big block's header mined
    on its tip, seconds)."""
    t0 = time.perf_counter()
    state = ChainState(path)
    manager = BlockManager(state, device=dev)

    async def submit(txs):
        clock.advance(60)
        errors = []
        if not await manager.create_block(await kit.header(manager, txs),
                                          txs, errors=errors):
            fail(f"chain block rejected: {errors}")

    await submit([])
    coin = (await state.get_spendable_outputs(kit.addr))[0]
    each = coin.amount // fan
    fan_tx = kit.spend([(coin.tx_hash, coin.index)],
                       [TxOutput(kit.addr, each)] * (fan - 1)
                       + [TxOutput(kit.addr, coin.amount - each * (fan - 1))])
    await submit([fan_tx])
    mids = []
    for j in range(fan):
        amt = fan_tx.outputs[j].amount
        sub = amt // per
        mids.append(kit.spend([(fan_tx.hash(), j)],
                              [TxOutput(kit.addr, sub)] * (per - 1)
                              + [TxOutput(kit.addr, amt - sub * (per - 1))]))
    await submit(mids)
    leaves = [kit.spend([(m.hash(), k)], [TxOutput(kit.addr, o.amount)])
              for m in mids for k, o in enumerate(m.outputs)]
    clock.advance(60)
    content = await kit.header(manager, leaves)  # mined before any accept
    state.close()
    return leaves, content, time.perf_counter() - t0


async def accept_path(dev: torch.device, kit: Kit, path: str, leaves,
                      content: str, kernel_name: str = "p256_verify_kernel",
                      **manager_kw) -> dict:
    """BlockManager(state, **manager_kw).create_block of the big block on
    the card, then the tampered candidates.  The chain is loaded into an
    in-memory database, as in every accept measured since the first
    slice."""
    state = ChainState()
    with sqlite3.connect(path) as src:
        src.backup(state.db)
    manager = BlockManager(state, device=dev, **manager_kw)
    pre_hash = await state.get_unspent_outputs_hash()
    chain_difficulty = (await manager.calculate_difficulty())[0]

    # the measured accept: cold verdict cache, counts from zero
    txverify.clear_sig_verdicts()
    trace.reset()
    p256.reset_counts()
    tsha.reset_counts()
    pmesh.reset_counts()
    prof = start_profiler()
    errors = []
    t0 = time.perf_counter()
    ok = await manager.create_block(content, leaves, errors=errors)
    accept_s = time.perf_counter() - t0
    launches, exc_lanes = p256.LAUNCHES, p256.EXCEPTION_LANES
    by_window = dict(p256.LAUNCHES_BY_WINDOW)
    sharded = pmesh.VERIFY_LAUNCHES
    txid_launches = tsha.BLOCKS_LAUNCHES
    device = device_busy(prof, kernel_name)
    breakdown = accept_breakdown()
    if not ok:
        fail(f"{len(leaves)}-tx block rejected: {errors}")
    if launches == 0:
        fail("the accept path never launched the kernel")
    if exc_lanes != 0:
        fail(f"{exc_lanes} exception lanes on honest signatures")
    post_hash = await state.get_unspent_outputs_hash()
    tip = await state.get_last_block()
    if post_hash == pre_hash or tip["id"] != 4:
        fail("the accepted block did not move the chain")
    spendable = await state.get_spendable_outputs(kit.addr)
    if len(spendable) != len(leaves) + 3:  # + coinbases of blocks 2-4
        fail(f"{len(spendable)} spendable outputs after accept")

    # tampered candidates on the new tip must be rejected
    rejected = []
    for txs in kit.tampered(leaves):
        clock.advance(60)
        errors = []
        if await manager.create_block(await kit.header(manager, txs), txs,
                                      errors=errors):
            fail("a tampered block was accepted")
        rejected += errors
    if rejected != REJECTED:
        fail(f"tampered blocks: {rejected}")
    if await state.get_unspent_outputs_hash() != post_hash:
        fail("a rejected block changed the UTXO set")
    host_digest_fallbacks("accept")
    state.close()
    return {"txs": len(leaves), "accept_s": accept_s,
            "launches": launches, "exception_lanes": exc_lanes,
            "by_window": by_window, "sharded_launches": sharded,
            "utxo_hash": post_hash, "txid_launches": txid_launches,
            "rejected": rejected, "breakdown": breakdown, "device": device,
            "difficulty": chain_difficulty}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http(url: str, path: str, body=None, host: str = "") -> dict:
    """One request from this thread; the decoded body."""
    data = None if body is None else json.dumps(body).encode()
    _status, raw = asyncio.run(fetch(
        url.rstrip("/") + "/" + path, "GET" if data is None else "POST",
        data, headers={"Host": host} if host else None))
    return json.loads(raw)


class NodeThread:
    """The port's Node serving HTTP on its own event-loop thread (the
    loop owns the node's sqlite connection), configured as ``python -m
    upow_tpu_torch.node.run --device cuda`` would be: ``Config.load`` over
    the environment, the database file, a free port, no seed and the
    peer book beside the database."""

    def __init__(self, dev: torch.device, db: str, kernel_env: str,
                 state=None, **overrides):
        os.environ["UPOW_DEVICE_VERIFY_KERNEL"] = kernel_env
        overrides = {"node__seed_url": "",
                     "node__peers_file": db + ".nodes.json", **overrides}
        try:
            self.cfg = Config.load(node__db_path=db, node__ip_config_file="",
                                   node__host="127.0.0.1", node__port=0,
                                   **overrides)
        finally:
            del os.environ["UPOW_DEVICE_VERIFY_KERNEL"]
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.node = self.call(self._start(dev, state))

    async def _start(self, dev, state) -> Node:
        node = Node(self.cfg, state=state, device=dev)
        server = await node.serve()
        self.url = f"http://127.0.0.1:{server.port}/"
        return node

    def call(self, coro, timeout: float = 600.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def request(self, path: str, body=None) -> dict:
        """One request from this (client) thread; the decoded body."""
        return http(self.url, path, body)

    def close(self) -> None:
        self.call(self.node.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


async def _burst(url: str, hexes, width: int = 256) -> list:
    """Every tx pushed at once (at most ``width`` connections open)."""
    gate = asyncio.Semaphore(width)

    async def push(tx_hex):
        async with gate:
            _status, raw = await fetch(url + "push_tx", "POST",
                                       json.dumps({"tx_hex": tx_hex}).encode())
            return json.loads(raw)
    return await asyncio.gather(*(push(h) for h in hexes))


class WsSubscriber:
    """A ``/ws`` client of the node at ``url`` on an event-loop thread of
    its own, subscribed to both channels, keeping every frame."""

    def __init__(self, url: str):
        self.frames: list = []
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.ws = asyncio.run_coroutine_threadsafe(
            self._open(url.rstrip("/") + "/ws"), self.loop).result(30)

    async def _open(self, url: str):
        ws = await ws_connect(url)
        hello = await ws.receive_json()
        if hello.get("type") != "connection_established":
            fail(f"/ws at {url}: {hello}")
        for channel in ("block", "transaction"):
            await ws.send_json({"type": "subscribe_" + channel})
            reply = await ws.receive_json()
            if reply.get("type") != "success":
                fail(f"/ws subscribe_{channel} at {url}: {reply}")
        self.reader = asyncio.ensure_future(self._read(ws))
        return ws

    async def _read(self, ws) -> None:
        while True:
            msg = await ws.receive()
            if msg.type != WSMsgType.TEXT:
                return
            self.frames.append(json.loads(msg.data))

    def of(self, kind: str) -> list:
        return [f["data"] for f in list(self.frames) if f["type"] == kind]

    def close(self) -> None:
        async def shut():
            self.reader.cancel()
            await asyncio.gather(self.reader, return_exceptions=True)
            await self.ws.close()
        asyncio.run_coroutine_threadsafe(shut(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


def ws_dropped(node: "NodeThread") -> int:
    return int(node_metrics(node.url)["upow_ws_dropped_messages_total"])


def node_path(dev: torch.device, kit: Kit, workdir: Path, leaves) -> dict:
    """The port's node under ``UPOW_DEVICE_VERIFY_KERNEL=complete``: a
    burst of push_tx through the coalescing intake, the duplicate and a
    tampered tx, then ``miner.run(device="cuda", once=True)`` against it;
    a ``/ws`` subscriber gets a frame for each admitted tx and one for
    the mined block."""
    db = str(workdir / "node.db")
    shutil.copyfile(workdir / "base.db", db)
    node = NodeThread(dev, db, "complete")
    burst = leaves[:BURST]
    sub = WsSubscriber(node.url)
    try:
        txverify.clear_sig_verdicts()
        trace.reset()
        p256.reset_counts()
        t0 = time.perf_counter()
        replies = asyncio.run(_burst(node.url, [t.hex() for t in burst]))
        burst_s = time.perf_counter() - t0
        complete, jac = p256.COMPLETE_LAUNCHES, p256.LAUNCHES
        sizes = node.node.intake.batch_sizes  # batch size -> batches
        if not all(r.get("ok") for r in replies):
            fail(f"burst: {[r for r in replies if not r.get('ok')][:3]}")
        if complete == 0 or jac != 0:
            fail(f"burst launches: complete {complete}, jac {jac}")
        dup = node.request("push_tx", {"tx_hex": burst[0].hex()})
        bad = kit.spend([(leaves[BURST].inputs[0].tx_hash,
                          leaves[BURST].inputs[0].index)],
                        list(leaves[BURST].outputs))
        r, s = bad.inputs[0].signature
        bad.inputs[0].signature = (r, (s + 1) % CURVE_N)
        bad._hex_cache.pop(True, None)
        bad._hash = None
        tampered = node.request("push_tx", {"tx_hex": bad.hex()})
        strings = [dup.get("error"), tampered.get("error")]
        if strings != ["Transaction just added",
                       "Transaction has not been added"]:
            fail(f"duplicate / tampered push_tx: {dup} {tampered}")
        before = len(node.request("get_pending_transactions")["result"])

        clock.advance(60)
        tsha.reset_counts()
        p256.reset_counts()
        t0 = time.perf_counter()
        rc = miner.run(kit.addr, node.url, "cuda", SEARCH_BATCH, 90.0,
                       once=True)
        run_s = time.perf_counter() - t0
        sha_launches, txid_launches = tsha.LAUNCHES, tsha.BLOCKS_LAUNCHES
        after = len(node.request("get_pending_transactions")["result"])
        tip = node.call(node.node.state.get_last_block())
        if rc != 0 or tip["id"] != 4:
            fail(f"miner.run against the node: rc {rc}, tip {tip['id']}")
        if sha_launches == 0:
            fail("the miner's path never launched the sha256 kernel")
        taken = len(node.call(node.node.state.get_block_transactions(
            tip["hash"]))) - 1  # the block's txs, less its coinbase
        if before != BURST or before - after != taken:
            fail(f"pending {before} -> {after}, block took {taken}")
        host_digest_fallbacks("node")
        want = sorted(t.hash() for t in burst)
        until("a /ws frame for each tx of the burst",
              lambda: len(sub.of("new_transaction")) >= BURST)
        until("the /ws frame of the mined block",
              lambda: sub.of("new_block"))
        got = sorted(f["tx_hash"] for f in sub.of("new_transaction"))
        blocks = sub.of("new_block")
        ws = {"tx_frames": len(got), "block_frames": len(blocks),
              "dropped": ws_dropped(node)}
        if got != want or [(b["block_no"], b["block_hash"]) for b in
                           blocks] != [(tip["id"], tip["hash"])] \
                or ws["dropped"]:
            fail(f"node /ws: {ws}, hashes equal {got == want}, "
                 f"blocks {[b['block_no'] for b in blocks]}")
    finally:
        sub.close()
        node.close()
    return {"burst": len(burst), "burst_s": burst_s, "complete": complete,
            "ws": ws,
            "jac": jac, "batches": sizes, "rejected": strings,
            "miner": {"run_s": run_s, "launches": sha_launches,
                      "txs": taken, "tip": tip["id"],
                      "difficulty": float(tip["difficulty"]),
                      "pending": [before, after],
                      "complete": p256.COMPLETE_LAUNCHES,
                      "txid_launches": txid_launches}}


def push_block_path(dev: torch.device, kit: Kit, workdir: Path, leaves,
                    content: str, kernel: str) -> dict:
    """On a fresh copy of the chain, the big block pushed over HTTP to a
    node on ``kernel``, with a cold verdict cache, its launches and the
    card's busy time; under ``complete`` then the tampered blocks."""
    db = str(workdir / f"push_{kernel}.db")
    shutil.copyfile(workdir / "base.db", db)
    node = NodeThread(dev, db, kernel)
    try:
        body = {"block_content": content, "txs": [t.hex() for t in leaves]}
        txverify.clear_sig_verdicts()
        trace.reset()
        p256.reset_counts()
        tsha.reset_counts()
        prof = start_profiler()
        t0 = time.perf_counter()
        reply = node.request("push_block", body)
        wall_s = time.perf_counter() - t0
        out = {"wall_s": wall_s, "complete": p256.COMPLETE_LAUNCHES,
               "jac": p256.LAUNCHES, "exception_lanes": p256.EXCEPTION_LANES,
               "txid_launches": tsha.BLOCKS_LAUNCHES,
               "device": device_busy(prof, KERNEL_NAMES[kernel]),
               "bytes": len(json.dumps(body))}
        if reply != {"ok": True}:
            fail(f"push_block of {len(leaves)} txs under {kernel}: {reply}")
        launched = out["complete"] if kernel == "complete" else out["jac"]
        other = out["jac"] if kernel == "complete" else out["complete"]
        if launched == 0 or other != 0:
            fail(f"push_block under {kernel}: launches {out}")
        if kernel == "complete":
            rejected = []
            for txs in kit.tampered(leaves):
                clock.advance(60)
                header = node.call(kit.header(node.node.manager, txs))
                reply = node.request("push_block", {
                    "block_content": header, "txs": [t.hex() for t in txs]})
                rejected.append(reply.get("error"))
            if rejected != REJECTED:
                fail(f"tampered blocks over HTTP: {rejected}")
            out["rejected"] = rejected
        host_digest_fallbacks(f"push_block under {kernel}")
    finally:
        node.close()
    return out


# --- phases 9-11: the txid batch, chain sync and reorg -------------------------

def micro_batch_payloads(leaves, n: int = MICROBATCH) -> list:
    """The digest prep's payloads of an accept micro-batch of ``n`` txs:
    per tx its signing bytes, their hex form and the txid payload."""
    out = []
    for tx in leaves[:n]:
        signing = tx.hex(False)
        out += [bytes.fromhex(signing), signing.encode(),
                bytes.fromhex(tx.hex())]
    return out


def page_payloads(db: str) -> list:
    """Every tx of the chain in ``db``: what one sync page of it hashes."""
    with sqlite3.connect(db) as con:
        return [bytes.fromhex(h) for (h,) in con.execute(
            "SELECT tx_hex FROM transactions")]


def cuda_once(fn) -> tuple:
    """(``fn()``, its milliseconds between two CUDA events): one run, for
    a slow plain version that is run once anyway for its result."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def blocks_chain_floor_ms(max_blocks: int, clock_mhz: float) -> tuple:
    """(ms, SASS instructions a compression): the least time of the
    longest message's chain of compressions, one compression's
    instructions (the kernel's block loop, cuobjdump) issued one a clock
    at the card's maximum SM clock, or (None, 0) without cuobjdump."""
    _total, loop = sass_counts("sha256_blocks")
    per_block = sum(loop.values())
    if not per_block:
        return None, 0
    return max_blocks * per_block / (clock_mhz * 1e3), per_block


def ragged_check(dev: torch.device, payloads: list, where: str) -> dict:
    """One ragged launch of ``payloads`` (packed and staged as the main
    path does it) against the plain version on the card and hashlib;
    the launch's time with 10 queued, the plain version's (one run), and
    ``sha256_batch`` whole on the host clock (pack, stage, one copy, one
    launch, one read-back; median of 5)."""
    words, table, order = tsha.pack_ragged(payloads)
    on_card = tsha._Staging.fill(dev, (words.view(np.int32), table))
    table_ptr = on_card.data_ptr() + 4 * words.size
    rows = len(payloads)
    launches = tsha.BLOCKS_LAUNCHES
    got = tsha._launch(on_card, table_ptr, 0, rows)
    if tsha.BLOCKS_LAUNCHES != launches + 1:
        fail(f"txid ragged launch on {where}: "
             f"{tsha.BLOCKS_LAUNCHES - launches} launches")
    plain, plain_ms = cuda_once(lambda: tsha.sha256_ragged_plain(
        on_card[:words.size], on_card[words.size:].view(-1, 2)))
    if not torch.equal(got, plain):
        fail(f"txid ragged kernel != plain on {where}")
    digests = np.empty((rows, 8), dtype=np.uint32)
    digests[order] = got.cpu().numpy().view(np.uint32)
    if [r.astype(">u4").tobytes() for r in digests] != [
            hashlib.sha256(m).digest() for m in payloads]:
        fail(f"txid ragged kernel != hashlib on {where}")
    ms = cuda_ms(lambda: tsha._launch(on_card, table_ptr, 0, rows),
                 reps=5, warm=2, per=10)
    own_ms = kernel_only_ms(lambda: tsha._launch(on_card, table_ptr, 0, rows),
                            "sha256_blocks_kernel", calls=10)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        tsha.sha256_batch(payloads, device=dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"ms": ms, "kernel_only_ms": own_ms, "plain_ms": plain_ms,
            "rows": rows,
            "compressions": int(table[:, 1].sum()),
            "max_blocks": int(table[0, 1]) if rows else 0,
            "batch_ms": statistics.median(walls),
            "max_abs_err": int((got.long() - plain.long()).abs().max())}


def txid_phase(dev: torch.device, shapes: dict) -> dict:
    """The batched-digest kernel against its plain version (on the card)
    and hashlib on each shape: bucket by bucket (a uniform table, one
    launch a length bucket), then the shape as the main path sends it, one
    ragged launch, with times, the throughput bound and the longest
    message's chain floor; returns the kernel's record (its ms and
    bounds at the sync page's shape)."""
    props = torch.cuda.get_device_properties(dev)
    clock_mhz = tdevice.max_sm_clock_mhz() or props.clock_rate / 1000
    clocks = max(tsha.BLOCK_ALU_OPS / INT_OPS_PER_SM_CLK,
                 (tsha.BLOCK_ALU_OPS + tsha.BLOCK_ADD_OPS)
                 / INT_ISSUE_PER_SM_CLK)
    totals, worst = {}, 0
    for shape, payloads in shapes.items():
        want = [hashlib.sha256(m).digest() for m in payloads]
        launches = tsha.BLOCKS_LAUNCHES
        if tsha.sha256_batch(payloads, device=dev) != want:
            fail(f"txid batch != hashlib on the {shape} shape")
        if tsha.BLOCKS_LAUNCHES != launches + 1:
            fail(f"txid batch on the {shape} shape: "
                 f"{tsha.BLOCKS_LAUNCHES - launches} launches, not 1")
        buckets = tsha.n_blocks_of(np.array([len(m) for m in payloads]))
        tot = collections.Counter()
        for n_blocks in np.unique(buckets).tolist():
            msgs = [payloads[i] for i in np.nonzero(buckets == n_blocks)[0]]
            t0 = time.perf_counter()
            words = tsha.pack_bucket(msgs, n_blocks)
            pack_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            on_card = torch.from_numpy(words.view(np.int32)).to(dev)
            torch.cuda.synchronize()
            h2d_ms = (time.perf_counter() - t0) * 1e3
            got = tsha.sha256_blocks(on_card, n_blocks)
            plain, plain_ms = cuda_once(lambda: tsha.sha256_blocks_plain(
                on_card, n_blocks))
            worst = max(worst, int((got.long() - plain.long()).abs().max()))
            if not torch.equal(got, plain):
                fail(f"txid kernel != plain: {shape}, {n_blocks} blocks")
            ms = cuda_ms(lambda: tsha.sha256_blocks(on_card, n_blocks),
                         reps=5, warm=2, per=10)
            t0 = time.perf_counter()
            for m in msgs:
                hashlib.sha256(m).digest()
            hashlib_ms = (time.perf_counter() - t0) * 1e3
            compressions = len(msgs) * n_blocks
            ops_ms = clocks * compressions / (
                props.multi_processor_count * clock_mhz * 1e6) * 1e3
            bytes_ms = (words.nbytes + len(msgs) * 32) / HBM_BYTES_S * 1e3
            tot.update(ms=ms, plain_ms=plain_ms, pack_ms=pack_ms,
                       h2d_ms=h2d_ms, hashlib_ms=hashlib_ms, ops_ms=ops_ms,
                       bytes_ms=bytes_ms, rows=len(msgs),
                       compressions=compressions, launches=1)
            print(f"  txid {shape} blocks={n_blocks} rows={len(msgs)} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
                  f"pack_ms={pack_ms:.3f} h2d_ms={h2d_ms:.3f} "
                  f"hashlib_ms={hashlib_ms:.3f}", flush=True)
        ragged = ragged_check(dev, payloads, f"the {shape} shape")
        worst = max(worst, ragged["max_abs_err"])
        chain_ms, per_block = blocks_chain_floor_ms(ragged["max_blocks"],
                                                    clock_mhz)
        auto = tsha.txid_auto_backend(len(payloads), dev)
        totals[shape] = dict(tot, auto=auto, ragged=ragged,
                             chain_ms=chain_ms)
        phase(f"txid_{shape}", payloads=len(payloads), equal=True,
              buckets=tot["launches"], rows=tot["rows"],
              compressions=tot["compressions"],
              one_launch_ms=round(ragged["ms"], 4),
              kernel_only_ms=ragged["kernel_only_ms"],
              one_launch_plain_ms=round(ragged["plain_ms"], 3),
              batch_ms=round(ragged["batch_ms"], 3),
              bucket_kernel_ms=round(tot["ms"], 4),
              bucket_plain_ms=round(tot["plain_ms"], 3),
              pack_ms=round(tot["pack_ms"], 3),
              h2d_ms=round(tot["h2d_ms"], 3),
              hashlib_ms=round(tot["hashlib_ms"], 3),
              bound_ms=round(max(tot["ops_ms"], tot["bytes_ms"]), 5),
              longest_blocks=ragged["max_blocks"],
              chain_floor_ms="not_measured" if chain_ms is None
              else round(chain_ms, 5),
              sass_per_block=per_block, auto_picks=auto)
    page = totals["sync_page"]
    bound_ms = max(page["ops_ms"], page["bytes_ms"])
    attrs = tsha.blocks_kernel_attributes(dev)
    phase("txid_kernel_vs_plain", shapes=json.dumps(sorted(shapes)),
          equal=True, bound_share=round(bound_ms / page["ragged"]["ms"], 4),
          alu_ops_per_block=tsha.BLOCK_ALU_OPS,
          add_ops_per_block=tsha.BLOCK_ADD_OPS, clock_mhz=clock_mhz,
          **attrs)
    return {"name": "sha256_blocks", "route": "cuda",
            "source": "upow_tpu_torch/csrc/sha256_blocks.cu",
            "replaces": "upow_tpu/crypto/sha256.py:429",
            "redesigned": "PR 10",
            "launches": 0, "max_abs_err": worst, "ms": page["ragged"]["ms"],
            "plain_ms": page["ragged"]["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "operations" if page["ops_ms"] >= page["bytes_ms"]
            else "bytes",
            "library_ms": None, "share": bound_ms / page["ragged"]["ms"],
            "chain_floor_ms": page["chain_ms"],
            "registers": attrs["registers"],
            "ms_buckets": page["ms"],
            "ms_micro_batch": totals["micro_batch"]["ragged"]["ms"]}


def ragged_mix(seed: int = 0x7A6) -> list:
    """A ragged batch of 1- to 154-block messages: one of every block
    count from 1 to 154 (the sync page's fan tx is 154), the padding
    edges, and 1,024 messages of 0-247 bytes (1-4 blocks), shuffled."""
    rng = random.Random(seed)
    lengths = [64 * b - 9 - rng.randrange(56) for b in range(2, 155)]
    lengths += [0] + TXID_EDGES + [rng.randrange(248) for _ in range(1024)]
    msgs = [rng.randbytes(n) for n in lengths]
    rng.shuffle(msgs)
    return msgs


def txid_ragged_phase(dev: torch.device) -> dict:
    """B5 on a ragged batch of 1- to 154-block messages in one launch,
    against its plain version on the card and hashlib."""
    msgs = ragged_mix()
    counts = {int(c) for c in tsha.n_blocks_of(np.array(
        [len(m) for m in msgs]))}
    if counts != set(range(1, 155)):
        fail(f"the ragged mix covers {len(counts)} block counts, not 154")
    out = ragged_check(dev, msgs, "the 1- to 154-block mix")
    phase("txid_ragged_kernel_vs_plain", messages=len(msgs), equal=True,
          block_counts="1-154", launches=1, ms=round(out["ms"], 4),
          kernel_only_ms=out["kernel_only_ms"],
          plain_ms=round(out["plain_ms"], 3),
          batch_ms=round(out["batch_ms"], 3),
          compressions=out["compressions"])
    return out


def txid_crossover(dev: torch.device, payloads: list) -> None:
    """``txid_batch`` whole (pack, copy, launches, read-back, hex, the
    integrity sample) on the card against hashlib, on leading slices of
    the accept's payload mix: the median of 7 interleaved passes each.
    Prints the smallest slice from which the card was faster at it and
    every larger one, beside the size ``auto``'s rule uses."""
    sizes = [n for n in TXID_SWEEP if n < len(payloads)] + [len(payloads)]
    tsha.txid_batch(payloads[:sizes[0]], "device", 1, dev)  # warm
    host_ms, device_ms = [], []
    for n in sizes:
        batch = payloads[:n]
        times = {"host": [], "device": []}
        for _ in range(7):
            for backend in times:
                t0 = time.perf_counter()
                tsha.txid_batch(batch, backend, 1, dev)
                times[backend].append((time.perf_counter() - t0) * 1e3)
        host_ms.append(statistics.median(times["host"]))
        device_ms.append(statistics.median(times["device"]))
    device_from = None
    for i in range(len(sizes) - 1, -1, -1):
        if device_ms[i] >= host_ms[i]:
            break
        device_from = sizes[i]
    phase("txid_crossover", sizes=json.dumps(sizes),
          host_ms=json.dumps([round(t, 3) for t in host_ms]),
          device_ms=json.dumps([round(t, 3) for t in device_ms]),
          device_faster_from=device_from,
          auto_device_min=tsha.TXID_AUTO_DEVICE_MIN)


def sync_request(node: NodeThread, peer: NodeThread) -> dict:
    return node.request("sync_blockchain?node_url="
                        + quote(peer.url.rstrip("/"), safe=""))


def same_chain(node: NodeThread, server: NodeThread) -> tuple:
    """(tip, UTXO hash) of ``node``; fails unless they are the server's."""
    got = [(n.call(n.node.state.get_last_block())["hash"],
            n.call(n.node.state.get_unspent_outputs_hash()))
           for n in (node, server)]
    if got[0] != got[1]:
        fail(f"synced node at {got[0]}, server at {got[1]}")
    return got[0]


def sync_path(dev: torch.device, workdir: Path, server: NodeThread) -> dict:
    """A port node on a fresh file syncs the served chain in one page."""
    node = NodeThread(dev, str(workdir / "sync.db"), "jac",
                      device__txid_backend="device",
                      node__sync_fetch_interval=0)
    try:
        txverify.clear_sig_verdicts()
        trace.reset()
        tsha.reset_counts()
        p256.reset_counts()
        prof = start_profiler()
        t0 = time.perf_counter()
        reply = sync_request(node, server)
        wall_s = time.perf_counter() - t0
        b5, jac = tsha.BLOCKS_LAUNCHES, p256.LAUNCHES
        dev_use = device_busy(prof, "sha256_blocks_kernel")
        spans = trace.stats()
        if reply != {"ok": True, "peer": server.url.rstrip("/")}:
            fail(f"sync: {reply}")
        tip, utxo = same_chain(node, server)
        txs = node.call(node.node.state.get_next_block_id()) - 1
        counters = host_digest_fallbacks("sync")
        pages = {k: spans.get(k, {}).get("count", 0) for k in (
            "sync.page_txids", "sync.page_sig_prefill")}
        if b5 == 0 or jac == 0 or pages != {"sync.page_txids": 1,
                                             "sync.page_sig_prefill": 1}:
            fail(f"sync launches: txid {b5}, jac {jac}, pages {pages}")
        n_txs = len(page_payloads(str(workdir / "sync.db")))
    finally:
        node.close()
    return {"wall_s": wall_s, "blocks": txs, "txs": n_txs, "b5": b5,
            "jac": jac, "device": dev_use, "counters": counters,
            "pages": pages, "tip": tip, "utxo": utxo}


def reorg_path(dev: torch.device, kit: Kit, workdir: Path,
               server: NodeThread) -> dict:
    """A port node on the 3-block prefix mines its own block 4' on the
    card, then syncs from the server with a reorg window of 2."""
    db = str(workdir / "reorg.db")
    shutil.copyfile(workdir / "base.db", db)
    node = NodeThread(dev, db, "jac", node__sync_reorg_window=2,
                      node__sync_fetch_interval=0)
    try:
        clock.advance(60)
        manager = node.node.manager
        content = node.call(kit.header(manager, []))
        errors = []
        if not node.call(manager.create_block(content, [], errors=errors)):
            fail(f"block 4' rejected: {errors}")
        fork = node.call(node.node.state.get_last_block())
        removed = []
        node.node.state.on_blocks_removed = removed.append
        txverify.clear_sig_verdicts()
        trace.reset()
        tsha.reset_counts()
        p256.reset_counts()
        t0 = time.perf_counter()
        reply = sync_request(node, server)
        wall_s = time.perf_counter() - t0
        b5, jac = tsha.BLOCKS_LAUNCHES, p256.LAUNCHES
        if reply != {"ok": True, "peer": server.url.rstrip("/")}:
            fail(f"reorg sync: {reply}")
        host_digest_fallbacks("reorg")
        if removed != [4] or node.call(
                node.node.state.get_block(fork["hash"])) is not None:
            fail(f"block 4' not removed: {removed}")
        tip, utxo = same_chain(node, server)
    finally:
        node.close()
    return {"wall_s": wall_s, "fork_id": fork["id"], "removed": removed,
            "b5": b5, "jac": jac, "tip": tip}


# --- phase 22: gossip between node processes ----------------------------------

def until(what: str, pred, timeout: float = 240.0, every: float = 0.02):
    """Poll ``pred`` until it is truthy; its value and the seconds it took."""
    t0 = time.perf_counter()
    while True:
        try:
            value = pred()
        except (OSError, ValueError, KeyError, TypeError):
            value = None  # a node still starting, or a body not there yet
        if value:
            return value, time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            fail(f"gossip: timed out waiting for {what}")
        time.sleep(every)


class NodeProcess:
    """``python -m upow_tpu_torch.node.run --device cuda`` in a process of
    its own on the card: its own verdict cache and launch counters, read
    back through its ``/metrics``.  It loads the kernels this process
    built; its log goes to ``<db>.log``.  ``device="cpu"`` runs the plain
    versions (a node with no card)."""

    def __init__(self, db: str, device: str = "cuda", **env):
        self.port = free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.log = open(db + ".log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "upow_tpu_torch.node.run", "--device",
             device, "--db", db, "--port", str(self.port)],
            cwd=str(Path(__file__).resolve().parent), stdout=self.log,
            stderr=subprocess.STDOUT,
            env={**os.environ, "UPOW_NODE_HOST": "127.0.0.1",
                 "UPOW_LOG_PATH": "",
                 "UPOW_NODE_SEED_URL": "",
                 "UPOW_NODE_PEERS_FILE": db + ".nodes.json",
                 "UPOW_NODE_SELF_URL": self.url,
                 "UPOW_NODE_IP_CONFIG_FILE": "",
                 "UPOW_NODE_RATE_LIMITS_ENABLED": "0",
                 "UPOW_NODE_SYNC_FETCH_INTERVAL": "0",
                 "UPOW_DEVICE_VERIFY_KERNEL": "jac", **env})

    def wait_ready(self) -> float:
        if self.proc.poll() is not None:
            fail(f"node process {self.url} exited: {self.tail()}")
        return until(f"{self.url} to serve",
                     lambda: self.proc.poll() is None
                     and http(self.url, "get_nodes")["ok"])[1]

    def tail(self) -> str:
        if not self.log.closed:
            self.log.flush()
        return Path(self.log.name).read_text()[-2000:]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)  # the node's close()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()


def window_launches(url: str) -> dict:
    """A node process's Jacobian kernel launches by window, from its
    ``/metrics``."""
    scrape = node_metrics(url)
    return {w: int(scrape.get(
        f"upow_kernel_p256_verify_w{w}_launches_total", 0))
        for w in p256.WINDOWS}


def node_metrics(url: str) -> dict:
    """A node's ``/metrics``: it must carry the 0.0.4 content type and
    pass the exposition validator; its samples as {name: value}."""
    headers: dict = {}
    status, raw = asyncio.run(fetch(url.rstrip("/") + "/metrics",
                                    response_headers=headers))
    text = raw.decode()
    if status != 200 or headers.get("content-type") \
            != exposition.CONTENT_TYPE:
        fail(f"node {url}: /metrics {status} {headers.get('content-type')}")
    errors = exposition.validate(text)
    if errors:
        fail(f"node {url}: /metrics format violations {errors[:5]}")
    return exposition.samples(text)


def runtime_arm(url: str) -> dict:
    """A node process's device runtime arm, from its ``/debug/events``
    (``device_runtime_armed``: platform, reason, probe seconds and the
    warm launches)."""
    armed = http(url, "debug/events?kind=device_runtime_armed")["result"]
    if not armed:
        fail(f"node {url}: no device_runtime_armed event")
    arm = dict(armed[-1])
    arm["warmed"] = json.loads(arm["warmed"])
    return arm


def node_window_path(workdir: Path, leaves, content: str, want_utxo: str,
                     w: int = 13) -> dict:
    """``python -m upow_tpu_torch.node.run --device cuda`` with
    ``UPOW_DEVICE_VERIFY_WINDOW=w`` on a fresh copy of the chain: its
    runtime arms (every library built, a warm launch at window w), then
    the 8,160-tx push_block over HTTP must be accepted with Jacobian
    launches at window w only, to the w = 4 accept's UTXO hash."""
    db = str(workdir / f"push_w{w}.db")
    shutil.copyfile(workdir / "base.db", db)
    t0 = time.perf_counter()
    node = NodeProcess(db, UPOW_DEVICE_VERIFY_WINDOW=str(w))
    try:
        node.wait_ready()
        ready_s = time.perf_counter() - t0
        arm = runtime_arm(node.url)
        if arm["platform"] != "cuda":
            fail(f"the w = {w} node armed {arm}")
        since = kernel_counts(node.url)
        before = window_launches(node.url)
        body = {"block_content": content, "txs": [t.hex() for t in leaves]}
        t1 = time.perf_counter()
        reply = http(node.url, "push_block", body)
        wall_s = time.perf_counter() - t1
        if reply != {"ok": True}:
            fail(f"push_block to the w = {w} node: {reply}")
        counts = kernel_counts(node.url, since)
        after = window_launches(node.url)
        launches = {k: after[k] - before[k] for k in after}
        if launches[w] == 0 or any(v for k, v in launches.items() if k != w):
            fail(f"the w = {w} node's launches by window: {launches}")
        if http(node.url, "")["unspent_outputs_hash"] != want_utxo:
            fail(f"the w = {w} node reached another UTXO hash")
        if counts["txid.sample_mismatch"] or counts["sync.host_txid_retry"]:
            fail(f"the w = {w} node: hashlib stood in for device digests")
    finally:
        node.close()
    return {"ready_s": ready_s, "wall_s": wall_s, "launches": launches[w],
            "warm": before[w], "batches": counts["p256_verify"],
            "accept_s": counts["block_accept"], "arm": arm}


def tip(url: str) -> str:
    return http(url, "get_mining_info")["result"]["last_block"]["hash"]


def tip_and_utxo(url: str) -> tuple:
    return tip(url), http(url, "")["unspent_outputs_hash"]


def pending_hashes(url: str) -> list:
    return sorted(hashlib.sha256(bytes.fromhex(h)).hexdigest()
                  for h in http(url, "get_pending_transactions")["result"])


def kernel_counts(url: str, since: dict = None) -> dict:
    """A node process's launches and fallbacks, from its ``/metrics``
    (and span totals from its ``/``), less ``since`` (the counts after
    its start: its runtime's warm launches).  Fails on any failure the
    node's degrade recorded (``device_verify_health`` above 0, or a
    ``resilience_device_error``), with its degrade events."""
    scrape = node_metrics(url)
    errors = int(scrape.get("upow_resilience_device_error_total", 0))
    if scrape["upow_device_verify_health"] or errors:
        fail(f"node {url}: the degrade recorded {errors} failure(s), "
             f"health {scrape['upow_device_verify_health']}: "
             f"{http(url, 'debug/events?kind=degrade')['result']}")
    since = since or {}
    out = {k: int(scrape.get(f"upow_kernel_{k}_batches_total", 0))
           - since.get(k, 0) for k in ("p256_verify", "sha256_txid")}
    out.update({k: int(scrape.get(
        "upow_" + k.replace(".", "_") + "_total", 0)) for k in (
        "txid.sample_mismatch", "sync.host_txid_retry")})
    timings = http(url, "")["timings"]
    for span in ("block_accept", "sync.page_txids", "sync.page_sig_prefill"):
        out[span] = timings.get(span, {}).get("total_s", 0.0)
    out["runtime_dispatches"] = int(scrape["upow_runtime_dispatches_total"])
    return out


class TemplateStub:
    """``get_mining_info`` for a miner process: the hash-rate template's
    previous hash at difficulty 10 (no sweep of 2^32 nonces finds a
    block), served on a thread of this process; each request's time is
    kept, and the miner asks once a sweep."""

    def __init__(self):
        import http.server

        job = sweep_job(point_to_string(curve.keygen(rng=KEY_SEED)[1]))
        body = json.dumps({"ok": True, "result": {
            "difficulty": "10", "pending_transactions_hashes": [],
            "last_block": {"hash": job.previous_hash, "id": 1}}}).encode()
        times = self.times = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                times.append(time.perf_counter())
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *_a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def gh_s(self, t0: float, t1: float) -> float:
        """The sweep's GH/s over [t0, t1]: whole sweeps between the first
        and the last template request inside it."""
        inside = [t for t in self.times if t0 <= t <= t1]
        if len(inside) < 2:
            return float("nan")
        return (len(inside) - 1) * (2 ** 32) / (inside[-1] - inside[0]) / 1e9

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def shared_card_path(dev: torch.device, workdir: Path, leaves, content: str,
                     card: str) -> dict:
    """A node process's push_block of the 8,160-tx block and a fresh node
    process's sync of it, alone on the card and then beside a miner
    process sweeping on the same card."""
    names = ("push_alone", "sync_alone", "push_swept", "sync_swept")
    for name in names:
        shutil.copyfile(workdir / "base.db", workdir / f"shared_{name}.db")
    nodes = {n: NodeProcess(str(workdir / f"shared_{n}.db"),
                            UPOW_DEVICE_TXID_BACKEND="device")
             for n in names}
    stub = TemplateStub()
    miner_log = open(workdir / "shared_miner.log", "w")
    miner_proc = None
    out = {}
    body = {"block_content": content, "txs": [t.hex() for t in leaves]}
    try:
        for node in nodes.values():
            node.wait_ready()
        since = {n: kernel_counts(node.url) for n, node in nodes.items()}

        def turn(tag: str) -> None:
            push, sync = nodes["push_" + tag], nodes["sync_" + tag]
            t0 = time.perf_counter()
            reply = http(push.url, "push_block", body)
            t1 = time.perf_counter()
            if reply != {"ok": True}:
                fail(f"shared card ({tag}): push_block: {reply}")
            reply = http(sync.url, "sync_blockchain?node_url="
                         + quote(push.url, safe=""))
            t2 = time.perf_counter()
            if reply != {"ok": True, "peer": push.url}:
                fail(f"shared card ({tag}): sync: {reply}")
            out[tag] = {"push_s": t1 - t0, "sync_s": t2 - t1,
                        "push_gh_s": stub.gh_s(t0, t1),
                        "sync_gh_s": stub.gh_s(t1, t2),
                        "push_counts": kernel_counts(push.url,
                                                     since["push_" + tag]),
                        "sync_counts": kernel_counts(sync.url,
                                                     since["sync_" + tag])}

        turn("alone")
        # the two walls split by the nodes' own trace trees
        out["trees"] = {
            "push": tree_split(latest_tree(nodes["push_alone"].url,
                                           "http.push_block")),
            "sync": tree_split(latest_tree(nodes["sync_alone"].url,
                                           "http.sync_blockchain"))}
        miner_proc = subprocess.Popen(
            [sys.executable, "-m", "upow_tpu_torch.mine.miner",
             point_to_string(curve.keygen(rng=KEY_SEED)[1]), "--node",
             stub.url, "--device", "cuda"],
            cwd=str(Path(__file__).resolve().parent), stdout=miner_log,
            stderr=subprocess.STDOUT,
            env={**os.environ, "UPOW_MINER_CHILD": "1"})
        # sweeping once two templates were asked for: then 2 s alone
        until("the miner's second sweep", lambda: len(stub.times) >= 3
              or miner_proc.poll() is not None, timeout=300.0)
        if miner_proc.poll() is not None:
            miner_log.flush()
            fail("shared card: the miner exited: "
                 + (workdir / "shared_miner.log").read_text()[-2000:])
        t0 = time.perf_counter()
        time.sleep(2.0)
        out["sweep_alone_gh_s"] = stub.gh_s(t0, time.perf_counter())
        turn("swept")
        if miner_proc.poll() is not None:
            fail("shared card: the miner exited during the turn")
        tips = {n: tip_and_utxo(node.url) for n, node in nodes.items()}
        if len(set(tips.values())) != 1:
            fail(f"shared card: the nodes differ: {tips}")
        for tag in ("alone", "swept"):
            if out[tag]["push_counts"]["p256_verify"] == 0 or \
                    out[tag]["sync_counts"]["sha256_txid"] == 0:
                fail(f"shared card ({tag}): no kernel launch: {out[tag]}")
        out["sweeps"] = len(stub.times)
    finally:
        if miner_proc is not None and miner_proc.poll() is None:
            miner_proc.terminate()
            try:
                miner_proc.wait(30)
            except subprocess.TimeoutExpired:
                miner_proc.kill()
                miner_proc.wait()
        miner_log.close()
        stub.close()
        for node in nodes.values():
            node.close()
    a, w = out["alone"], out["swept"]
    phase("shared_card", layout="node.run+miner.run, one card",
          push_block_alone_s=round(a["push_s"], 3),
          push_block_swept_s=round(w["push_s"], 3),
          sync_alone_s=round(a["sync_s"], 3),
          sync_swept_s=round(w["sync_s"], 3),
          sweep_alone_gh_s=round(out["sweep_alone_gh_s"], 4),
          sweep_during_push_gh_s=round(w["push_gh_s"], 4),
          sweep_during_sync_gh_s=round(w["sync_gh_s"], 4),
          push_jac_batches=json.dumps([a["push_counts"]["p256_verify"],
                                       w["push_counts"]["p256_verify"]]),
          sync_txid_batches=json.dumps([a["sync_counts"]["sha256_txid"],
                                        w["sync_counts"]["sha256_txid"]]),
          sweeps=out["sweeps"], card=json.dumps(card))
    return out


def gossip_path(dev: torch.device, kit: Kit, workdir: Path, leaves,
                content: str) -> dict:
    """Node A (this process) and nodes B and C (processes of their own,
    each on the card): B is added to A's book beside a dead URL; the
    8,160-tx block pushed to A reaches B through A's gossip and B accepts
    it on its card; a burst of push_tx to A reaches B's pool; the dead
    peer's breaker opens; C, seeded with A, bootstraps on its first
    request from outside, learns B, announces itself and syncs (B5 and
    kernel 1 on its card).  A, B and C end on one tip and UTXO hash.
    The block's push and hop are ``telemetry_path``'s
    (:func:`telemetry_checks`): B captures them with ``torch.profiler``,
    and a ``--device cpu`` node process's scrape is held beside."""
    for name in ("a", "b", "c", "cpu"):
        shutil.copyfile(workdir / "base.db", workdir / f"gossip_{name}.db")
    # a node that has just taken the chain's newest block is not minutes
    # behind it: while A runs, the script's clock (which every earlier
    # phase advanced) stands a minute past block 4's timestamp, so A's
    # watchtower reads the sync lag a live node would
    resume = clock.timestamp()
    clock.freeze(split_block_content(content)[3] + 60)
    a = NodeThread(dev, str(workdir / "gossip_a.db"), "jac",
                   node__rate_limits_enabled=False,
                   watchtower__enabled=True, watchtower__interval=0.5)
    a.node.self_url = a.url.rstrip("/")
    sub = WsSubscriber(a.url)
    b = NodeProcess(str(workdir / "gossip_b.db"), UPOW_PROFILE_ENABLED="1",
                    UPOW_PROFILE_TRACE_DIR=str(workdir / "b_profile"))
    c = NodeProcess(str(workdir / "gossip_c.db"),
                    UPOW_NODE_SEED_URL=a.url.rstrip("/"),
                    UPOW_DEVICE_TXID_BACKEND="device")
    cpu = NodeProcess(str(workdir / "gossip_cpu.db"), device="cpu")
    dead = f"http://127.0.0.1:{free_port()}"
    out = {"rate_limits": "off", "dead": dead}
    try:
        out["b_start_s"] = b.wait_ready()
        out["c_start_s"] = c.wait_ready()
        cpu.wait_ready()
        # each node armed its runtime before serving (one warm launch of
        # each kernel): counts are read from here on
        b0, c0 = kernel_counts(b.url), kernel_counts(c.url)
        added = http(a.url, "add_node?url=" + quote(b.url, safe=""))
        if added != {"ok": True, "result": "Node added"}:
            fail(f"gossip: add_node of B on A: {added}")
        a.call(_add_peer(a.node, dead))
        nodes = http(a.url, "get_nodes")["result"]
        if b.url not in nodes or dead not in nodes:
            fail(f"gossip: A's get_nodes {nodes}")

        # the read cache: the height to come, read twice before the push
        read = cache_reads(a, "get_block?block=4")

        # the block: pushed to A under a trace, gossiped to B
        txverify.clear_sig_verdicts()
        trace.reset()
        p256.reset_counts()

        def hop() -> float:
            a_tip = a.call(a.node.state.get_last_block())["hash"]
            return until("block 4 on B", lambda: tip(b.url) == a_tip)[1]

        out["telemetry"] = telemetry_checks(a, b, cpu, {
            "block_content": content, "txs": [t.hex() for t in leaves]}, hop)
        out["hop_s"] = out["telemetry"]["hop_s"]
        cpu.close()
        a_tip = a.call(a.node.state.get_last_block())["hash"]
        out["cache"] = cache_after(a, "get_block?block=4", read, a_tip)
        until("the /ws frame of the pushed block",
              lambda: sub.of("new_block"))
        out["a_jac"] = p256.LAUNCHES
        out["b_block"] = kernel_counts(b.url, b0)
        if out["b_block"]["p256_verify"] == 0:
            fail(f"gossip: B accepted with no kernel-1 launch: {out}")
        if tip_and_utxo(b.url) != (a_tip, a.call(
                a.node.state.get_unspent_outputs_hash())):
            fail("gossip: B's UTXO hash differs from A's")

        # the burst: pushed to A, gossiped to B's pool
        spends = [kit.spend([(t.hash(), 0)], [TxOutput(kit.addr,
                                                        t.outputs[0].amount)])
                  for t in leaves[-GOSSIP_BURST:]]
        t0 = time.perf_counter()
        replies = asyncio.run(_burst(a.url, [t.hex() for t in spends]))
        out["burst_push_s"] = time.perf_counter() - t0
        if not all(r.get("ok") for r in replies):
            fail(f"gossip burst: {[r for r in replies if not r.get('ok')][:3]}")
        want = sorted(t.hash() for t in spends)
        until("a /ws frame for each tx of A's burst",
              lambda: len(sub.of("new_transaction")) >= GOSSIP_BURST)
        _, out["burst_hop_s"] = until(
            "the burst in B's pool", lambda: pending_hashes(b.url) == want)
        if pending_hashes(a.url) != want:
            fail("gossip: A's pending set is not the burst")
        out["b_burst"] = kernel_counts(b.url, b0)
        breakers = http(a.url, "debug/breakers")["result"]
        out["breakers"] = breakers
        if breakers["peers"].get(dead, {}).get("state") != "open" or \
                breakers["peers"].get(b.url, {}).get("state") != "closed":
            fail(f"gossip: A's breakers {breakers}")
        counters = trace.counters()
        out["propagate_timeouts"] = int(counters.get(
            "resilience.propagate_timeouts", 0))
        if out["propagate_timeouts"]:
            fail(f"gossip: {out['propagate_timeouts']} sends cut at "
                 f"propagate_deadline")
        out["a_counters"] = host_digest_fallbacks("gossip on A")

        # C: bootstrap on the first request from outside, then sync
        t0 = time.perf_counter()
        http(c.url, "get_supply_info", host=f"node-c.example:{c.port}")
        until("C at A's tip", lambda: tip(c.url) == a_tip)
        out["c_bootstrap_s"] = time.perf_counter() - t0
        c_nodes = http(c.url, "get_nodes")["result"]
        if b.url not in c_nodes or c.url in c_nodes:
            fail(f"gossip: C's book after its bootstrap {c_nodes}")
        until("A to learn C", lambda: c.url in http(a.url, "get_nodes")[
            "result"])
        out["c"] = kernel_counts(c.url, c0)
        if out["c"]["p256_verify"] == 0 or out["c"]["sha256_txid"] == 0:
            fail(f"gossip: C synced without launches {out['c']}")
        for where, counts in (("B", out["b_burst"]), ("C", out["c"])):
            if counts["txid.sample_mismatch"] or \
                    counts["sync.host_txid_retry"]:
                fail(f"gossip: hashlib stood in on {where}: {counts}")
        ends = {tip_and_utxo(url) for url in (a.url, b.url, c.url)}
        if len(ends) != 1:
            fail(f"gossip: A, B and C end apart: {ends}")
        out["tip"] = a_tip
        out["ws"] = ws_frames(a, sub, want, a_tip, len(leaves))
        out["alerts"] = alert_checks(a)
    except SystemExit:
        for node in (b, c, cpu):
            print(f"  node log {node.url}: {node.tail()}", file=sys.stderr)
        raise
    finally:
        sub.close()
        a.close()
        for node in (b, c, cpu):
            node.close()
        clock.freeze(resume)
    return out


def cache_status(node: "NodeThread") -> dict:
    return http(node.url, "debug/cache")["result"]


def cache_reads(node: "NodeThread", path: str) -> dict:
    """``path`` read twice from ``node``: the second read must be a read
    cache hit (``upow_hotcache_hits_total`` up by 1) with the same
    body."""
    hits0 = node_metrics(node.url)["upow_hotcache_hits_total"]
    bodies = [asyncio.run(fetch(node.url + path))[1] for _ in range(2)]
    hits = node_metrics(node.url)["upow_hotcache_hits_total"] - hits0
    if hits != 1 or bodies[0] != bodies[1]:
        fail(f"read cache: {path} read twice gave {hits} hits")
    return {"body": bodies[0], "generation": cache_status(node)["generation"]}


def cache_after(node: "NodeThread", path: str, before: dict,
                tip_hash: str) -> dict:
    """After a committed write: the generation moved, and the cached
    re-read is the ``X-Upow-Cache-Bypass`` body byte for byte, naming
    the new tip."""
    cached = asyncio.run(fetch(node.url + path))[1]
    fresh = asyncio.run(fetch(node.url + path,
                              headers={"X-Upow-Cache-Bypass": "1"}))[1]
    stats = cache_status(node)
    if stats["generation"] <= before["generation"] or cached != fresh \
            or cached == before["body"] or tip_hash.encode() not in cached:
        fail(f"read cache after the push: generation "
             f"{before['generation']} -> {stats['generation']}, re-read "
             f"equals bypass {cached == fresh}")
    return {"hits": stats["hits"], "misses": stats["misses"],
            "generation": [before["generation"], stats["generation"]]}


def ws_frames(node: "NodeThread", sub: WsSubscriber, tx_hashes: list,
              tip_hash: str, n_txs: int) -> dict:
    """Node A's ``/ws`` subscriber: one ``new_block`` frame, for the
    8,160-tx block at A's tip; a ``new_transaction`` frame for each tx
    of the burst; nothing dropped."""
    blocks = sub.of("new_block")
    got = sorted(f["tx_hash"] for f in sub.of("new_transaction"))
    out = {"tx_frames": len(got), "block_frames": len(blocks),
           "dropped": ws_dropped(node)}
    if [(b["block_no"], b["block_hash"], b["transactions_count"])
            for b in blocks] != [(4, tip_hash, n_txs)] \
            or got != tx_hashes or out["dropped"]:
        fail(f"/ws on A: {out}, hashes equal {got == tx_hashes}, blocks "
             f"{[(b['block_no'], b['transactions_count']) for b in blocks]}")
    return out


def alert_checks(node: "NodeThread") -> dict:
    """The watchtower on A after the clean run: enabled, evaluating,
    nothing firing, and ``/metrics`` carrying the alert families."""
    res = http(node.url, "debug/alerts")["result"]
    scrape = node_metrics(node.url)
    families = ("upow_alert_firing", "upow_alert_pending",
                "upow_alert_evaluations_total", "upow_alert_eval_lag_seconds",
                "upow_alert_rule_stuck_height_critical_firing")
    if not res.get("enabled") or res["stats"]["evaluations"] <= 0 \
            or res["counts"]["firing"] or res["stats"]["eval_errors"] \
            or any(f not in scrape for f in families):
        fail(f"watchtower on A: {json.dumps(res)[:600]}")
    return {"evaluations": res["stats"]["evaluations"],
            "eval_lag_seconds": res["stats"]["eval_lag_seconds"],
            "pending": sorted(a["key"] for a in res["active"]
                              if a["state"] == "pending"),
            "probe_errors": res["stats"]["probe_errors"],
            "alert_evaluations_total": int(
                scrape["upow_alert_evaluations_total"])}


async def _add_peer(node: Node, url: str) -> None:
    node.peers.add(url)


def latest_tree(url: str, name: str) -> dict:
    """A node process's most recent recorded tree ``name``."""
    recent = [t for t in http(url, "debug/traces")["result"]["recent"]
              if t["name"] == name]
    if not recent:
        fail(f"node {url}: no {name} trace recorded")
    return recent[-1]


def find_trace(traces: dict, trace_id: str, name: str):
    """The recorded tree ``name`` with ``trace_id`` in a ``/debug/traces``
    result (recent ring or slowest top-N), or None."""
    for t in traces["recent"] + traces["slowest"]:
        if t.get("trace_id") == trace_id and t["name"] == name:
            return t
    return None


def tree_split(root: dict) -> dict:
    """A trace tree's wall split by span name: {name: [count, total ms]}
    over every span under the root (nested spans inside their parents'
    totals too), and the root's own ms."""
    out: dict = {}

    def walk(t: dict) -> None:
        for c in t.get("spans", ()):
            row = out.setdefault(c["name"], [0, 0.0])
            row[0] += 1
            row[1] = round(row[1] + c["duration_ms"], 3)
            walk(c)
    walk(root)
    return {"root_ms": root["duration_ms"], "spans": out}


def check_tree(tree: dict, wall_s: float, must: tuple, where: str) -> None:
    """The tree holds every span of ``must``; its root fits in the
    client's wall and its direct children in the root (1 us of rounding
    each)."""
    names = {c["name"] for c in _walk(tree)}
    missing = [m for m in must if m not in names]
    if missing:
        fail(f"{where}: the trace lacks {missing}: {sorted(names)}")
    kids = sum(c["duration_ms"] for c in tree.get("spans", ()))
    slack = 1e-3 * (1 + len(tree.get("spans", ())))
    if tree["duration_ms"] > wall_s * 1e3 + slack or \
            kids > tree["duration_ms"] + slack:
        fail(f"{where}: spans {kids} ms, root {tree['duration_ms']} ms, "
             f"client wall {wall_s * 1e3} ms")


def _walk(t: dict):
    for c in t.get("spans", ()):
        yield c
        yield from _walk(c)


def profile_kernels(path: str, name: str, per_block: int = 32) -> tuple:
    """(launches, least lanes, most lanes) of the CUDA kernel ``name`` in
    a torch.profiler Chrome trace: a launch of ``per_block`` signatures a
    block (kernel 1: 128 threads, four a signature) on a grid of g blocks
    carried 32 (g - 1) + 1 to 32 g lanes."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    grids = [e.get("args", {}).get("grid", [0])[0] for e in events
             if e.get("cat") == "kernel" and name in e.get("name", "")]
    return (len(grids), sum(per_block * (g - 1) + 1 for g in grids),
            sum(per_block * g for g in grids))


def telemetry_checks(a: "NodeThread", b: "NodeProcess", cpu: "NodeProcess",
                     body: dict, a_tip_wait) -> dict:
    """``telemetry_path``: the 8,160-tx push_block to node A (this
    process) under a trace, gossiped to node B (a process profiling with
    ``torch.profiler`` through ``/debug/profile``); returns the hop's
    wall and the figures.  Checks that A's response carries a trace id
    and B's ``/debug/traces`` a tree under it; that A's tree holds the
    accept's spans within A's client wall; that both scrapes are valid
    with ``lanes_real`` equal to the lanes A's launches carried, A's
    runtime dispatches equal to its runtime's count and, on A and B, to
    the ``runtime.dispatch`` spans in the request's tree, the verify health
    0 and the card's memory gauges present (and absent on ``cpu``, a
    ``--device cpu`` node process); and that B's capture lists as many
    kernel-1 launches as B's launch counter moved, whose grids hold B's
    ``lanes_real``."""
    launched = []
    real_verify = p256.verify_packed

    def spy(packed, *args, **kw):
        if packed.device.type == "cuda":
            launched.append(int(packed.shape[1]))
        return real_verify(packed, *args, **kw)

    rt = truntime.get_runtime(a.node.device)
    d0 = rt.dispatches
    b0 = node_metrics(b.url)
    started = http(b.url, "debug/profile?action=start")
    if not started.get("ok"):
        fail(f"telemetry: B's profile start: {started}")
    headers: dict = {}
    p256.verify_packed = spy
    try:
        t0 = time.perf_counter()
        status, raw = asyncio.run(fetch(
            a.url + "push_block", "POST", json.dumps(body).encode(),
            response_headers=headers))
        client_s = time.perf_counter() - t0
    finally:
        p256.verify_packed = real_verify
    if (status, json.loads(raw)) != (200, {"ok": True}):
        fail(f"gossip: push_block to A: {status} {raw[:200]}")
    tid = headers.get("x-upow-trace", "")
    if not trace.valid_trace_id(tid):
        fail(f"telemetry: A's push_block carries no trace id: {headers}")
    hop_s = a_tip_wait()
    b_tree = until("B's trace of the gossiped block", lambda: find_trace(
        http(b.url, "debug/traces")["result"], tid, "http.push_block"))[0]
    stopped = http(b.url, "debug/profile?action=stop")
    result = stopped.get("result", {})
    if not stopped.get("ok") or "error" in result \
            or not os.path.exists(result.get("trace_file", "")):
        fail(f"telemetry: B's profile capture: {stopped}")
    a1, b1 = node_metrics(a.url), node_metrics(b.url)
    cpu_scrape = node_metrics(cpu.url)
    a_tree = find_trace(trace.traces(), tid, "http.push_block")
    if a_tree is None:
        fail(f"telemetry: A recorded no tree under {tid}")
    check_tree(a_tree, client_s, ("block_accept", "block.sig_verify",
                                  "block.utxo_apply", "runtime.dispatch"),
               "telemetry: A's push_block")
    lanes = sum(launched)

    def delta(m1: dict, m0: dict, key: str) -> int:
        return int(m1.get(key, 0) - m0.get(key, 0))
    lanes_key = "upow_kernel_p256_verify_lanes_real_total"
    w4_key = "upow_kernel_p256_verify_w4_launches_total"
    out = {"trace_id": tid, "client_s": client_s, "hop_s": hop_s,
           "launches": len(launched), "lanes": lanes,
           "a_lanes_real": int(a1[lanes_key]),
           "b_lanes_real": delta(b1, b0, lanes_key),
           "a_runtime_dispatches": int(a1["upow_runtime_dispatches_total"]),
           "a_runtime_count": rt.dispatches - d0,
           "b_runtime_dispatches": delta(
               b1, b0, "upow_runtime_dispatches_total"),
           "b_launches": delta(b1, b0, w4_key),
           "b_profile_kernels": profile_kernels(
               result["trace_file"], KERNEL_NAMES["jac"]),
           "b_profile_s": result["seconds"],
           "b_profile_bytes": os.path.getsize(result["trace_file"]),
           "a_tree": tree_split(a_tree), "b_tree": tree_split(b_tree),
           "memory": {k: v for k, v in b1.items()
                      if k.startswith("upow_device_gpu_0_")}}
    n_prof, lo, hi = out["b_profile_kernels"]
    if not launched or out["a_lanes_real"] != lanes \
            or not lo <= out["b_lanes_real"] <= hi:
        fail(f"telemetry: lanes_real A {out['a_lanes_real']} against the "
             f"{lanes} A's launches carried; B {out['b_lanes_real']} "
             f"against {lo}-{hi} by its captured grids")
    # every dispatch of the accept is in the request's tree, one
    # runtime.dispatch span each (a dispatch holds a micro-batch's
    # launches: pass 1 and the bad canary's pass 2)
    spans = {w: out[f"{w}_tree"]["spans"].get("runtime.dispatch", [0])[0]
             for w in ("a", "b")}
    if out["a_runtime_dispatches"] != out["a_runtime_count"] \
            or out["a_runtime_dispatches"] != spans["a"] \
            or out["b_runtime_dispatches"] != spans["b"]:
        fail(f"telemetry: runtime dispatches {out}")
    for where, m in (("A", a1), ("B", b1)):
        if m["upow_device_verify_health"] != 0 \
                or m.get("upow_device_gpu_0_peak_bytes_in_use", 0) <= 0 \
                or m.get("upow_device_gpu_0_bytes_limit", 0) <= 0 \
                or "upow_device_gpu_0_bytes_in_use" not in m:
            fail(f"telemetry: {where}'s health and card memory gauges: "
                 f"{ {k: v for k, v in m.items() if 'device' in k} }")
    if any(k.startswith("upow_device_gpu") for k in cpu_scrape):
        fail("telemetry: a --device cpu node exports card memory gauges")
    if out["b_launches"] == 0 or n_prof != out["b_launches"]:
        fail(f"telemetry: B's capture lists {n_prof} kernel-1 launches, "
             f"its counter moved {out['b_launches']}")
    return out


def tracing_cost_path(dev: torch.device, workdir: Path, leaves,
                      content: str,
                      turns=(True, False, False, True)) -> dict:
    """The cost of request tracing: on fresh copies of the chain, a
    node (this process, jac) with ``telemetry.trace_requests`` on and
    off in turns takes the 1,024-tx ``push_tx`` burst and then the
    8,160-tx ``push_block``; each turn's two walls."""
    body = {"block_content": content, "txs": [t.hex() for t in leaves]}
    walls = {True: [], False: []}
    for i, traced in enumerate(turns):
        db = str(workdir / f"tracing_{i}.db")
        shutil.copyfile(workdir / "base.db", db)
        node = NodeThread(dev, db, "jac", telemetry__trace_requests=traced)
        try:
            txverify.clear_sig_verdicts()
            t0 = time.perf_counter()
            replies = asyncio.run(_burst(node.url,
                                         [t.hex() for t in leaves[:BURST]]))
            t1 = time.perf_counter()
            reply = node.request("push_block", body)
            t2 = time.perf_counter()
            if not all(r.get("ok") for r in replies) or reply != {"ok": True}:
                fail(f"tracing cost turn {i}: {reply} "
                     f"{[r for r in replies if not r.get('ok')][:2]}")
            walls[traced].append((t1 - t0, t2 - t1))
        finally:
            node.close()
    return walls


# --- phases 13-15: the UTXO probe and the resident accept ------------------

def _low32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 values as int32 (two's complement)."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def probe_lanes(dev: torch.device, n: int, cap: int,
                gen: torch.Generator) -> tuple:
    """((6, cap) int32 resident lanes; planted rows): n sorted random
    64-bit keys built on the card, then the index's pad rows to the
    capacity, with a 12-entry run on one high lane, a pair of 64-bit
    twins (one key, other check lanes) and a last live key whose high
    lane is I32_MAX, the pads' own."""
    def rand(lo, hi):
        return torch.randint(lo, hi, (n,), dtype=torch.int64, device=dev,
                             generator=gen)
    key = torch.sort(rand(-2 ** 31, 2 ** 31) * 2 ** 32
                     + rand(0, 2 ** 32)).values
    lanes = torch.empty((6, cap), dtype=torch.int32, device=dev)
    lanes[:, n:] = torch.tensor([I32_MAX, I32_MAX, 0, 0, 0, 0],
                                dtype=torch.int32, device=dev)[:, None]
    lanes[0, :n] = (key >> 32).to(torch.int32)
    lanes[1, :n] = _low32(key)
    for r in range(2, 6):
        lanes[r, :n] = _low32(rand(-2 ** 31, 2 ** 31))
    run, twin = n // 3, n // 2
    lanes[0, run + 1:run + 12] = lanes[0, run]     # stays sorted: <= next
    lanes[:2, twin + 1] = lanes[:2, twin]
    lanes[0, n - 1] = I32_MAX
    planted = list(range(run, run + 12)) + [twin, twin + 1, n - 1]
    return lanes, planted


def probe_queries(lanes: torch.Tensor, n_live: int, q: int,
                  gen: torch.Generator, planted=()) -> torch.Tensor:
    """(4, q) int32 queries: half present (the planted rows first), a
    quarter equal to a live row on the high lane only, a quarter
    random (a 64-bit hit among them is about 2^-45 likely)."""
    dev = lanes.device
    qs = torch.randint(-2 ** 31, 2 ** 31, (4, q), dtype=torch.int64,
                       device=dev, generator=gen).to(torch.int32)
    if n_live:
        rows = torch.randint(0, n_live, (q,), device=dev, generator=gen)
        rows[:len(planted)] = torch.tensor(planted, device=dev)
        half, quarter = q // 2, q // 4
        qs[:, :half] = lanes[:4, rows[:half]]
        qs[0, half:half + quarter] = lanes[0, rows[half:half + quarter]]
    return qs.contiguous()


def probe_check(lanes, n_live: int, qs, where: str = "",
                args=None) -> tuple:
    """The kernel against its plain version on the card, all five
    outputs bit for bit: through ``tdi.probe`` (its own fence), or
    through ``tdi.launch`` on prepared ``args`` (a fence shift of the
    caller's, or the index's own); (max abs error, the kernel's
    outputs)."""
    q = int(qs.shape[1])
    got = tdi.probe(*lanes, n_live, *qs) if args is None else \
        tdi.split_results(tdi.launch(args, qs), q)
    want = tdi.probe_plain(*lanes, n_live, *qs)
    torch.cuda.synchronize()
    err = max((int((g.long() - w.long()).abs().max()) if g.numel() else 0)
              for g, w in zip(got, want))
    for g, w, name in zip(got, want, ("hit", "key_hit", "overflow",
                                      "amt_lo", "amt_hi")):
        if g.dtype != w.dtype or not torch.equal(g, w):
            bad = torch.nonzero(g != w).flatten()[:8].tolist()
            fail(f"utxo_probe != plain on {name} at {n_live} keys of "
                 f"{lanes[0].shape[0]}, {q} queries{where}: first {bad}")
    return err, got


def probe_launch_path(args, qs, calls: int = 1000) -> dict:
    """Host microseconds a call of each piece of B6's launch path: the
    steps of ``tdi.launch`` (the path the index takes once an upload has
    prepared its arguments) re-enacted ``calls`` times on the card with
    ``time.perf_counter`` around each piece (the query lanes' checks, the
    output buffer, the current-device test, the raw stream, the
    ``data_ptr`` calls, the ctypes call); the same ctypes call at 0
    queries (argument conversion and return alone); the C side's
    configuration lookup timed in C (``utxo_probe_query_ns``); and
    ``tdi.launch`` whole, ``calls`` calls queued with no synchronisation
    between them."""
    import ctypes

    lib = tdi._kernel_lib()
    lib.utxo_probe_query_ns.argtypes = [ctypes.c_int]
    lib.utxo_probe_query_ns.restype = ctypes.c_double
    dev, window, q = args.device_index, tdi.PROBE_WINDOW, int(qs.shape[1])
    spent = collections.Counter()
    clk = time.perf_counter
    torch.cuda.synchronize()
    for _ in range(calls):
        t0 = clk()
        tdi._check_lane(qs, (4, q), dev)
        t1 = clk()
        out = torch.empty(11 * q, dtype=torch.uint8, device=dev)
        t2 = clk()
        current = tdevice.current_index() == dev
        t3 = clk()
        stream = tdevice.raw_stream(dev)
        t4 = clk()
        ptrs = (qs.data_ptr(), out.data_ptr())
        t5 = clk()
        rc = lib.utxo_probe_launch(args.block_ptr, ptrs[0], q, window,
                                   ptrs[1], stream)
        t6 = clk()
        if rc != 0 or not current:
            fail(f"utxo_probe launch in the launch-path timing: {rc}")
        spent.update(checks=t1 - t0, outputs=t2 - t1, device=t3 - t2,
                     stream=t4 - t3, data_ptr=t5 - t4, ctypes_call=t6 - t5)
    torch.cuda.synchronize()
    t0 = clk()
    for _ in range(calls):
        lib.utxo_probe_launch(args.block_ptr, ptrs[0], 0, window, ptrs[1],
                              stream)
    spent["ctypes_call_q0"] = clk() - t0
    c_queries_us = lib.utxo_probe_query_ns(calls) / 1e3
    torch.cuda.synchronize()
    t0 = clk()
    for _ in range(calls):
        tdi.launch(args, qs)
    spent["whole"] = clk() - t0
    torch.cuda.synchronize()
    out = {k: v / calls * 1e6 for k, v in spent.items()}
    out["c_queries"] = c_queries_us
    return out


def fence_edge_lanes(lanes: torch.Tensor, n_live: int, shift: int,
                     gen: torch.Generator) -> tuple:
    """A run of equal high lanes 2.5 fence strides long planted one row
    past a fence point of ``lanes`` (in place: the run takes its first
    row's high lane, so the keys stay sorted); returns ((4, q) queries,
    the run's length).  The queries: every fence point and the row
    before it, every row of the run, the run's high lane with absent
    low lanes (64), and random keys (64)."""
    stride = 1 << shift
    start = min(stride + 1, n_live // 3)
    length = min(n_live - start, 2 * stride + stride // 2 + 1)
    lanes[0, start:start + length] = lanes[0, start].clone()
    rows = torch.cat([
        torch.arange(0, n_live, stride, device=lanes.device),
        torch.arange(stride - 1, n_live, stride, device=lanes.device),
        torch.arange(start, start + length, device=lanes.device)])
    qs = lanes[:4, rows]
    other = qs[:, -64:].clone()
    other[1] ^= 0x55555555
    rand = torch.randint(-2 ** 31, 2 ** 31, (4, 64), dtype=torch.int64,
                         device=lanes.device, generator=gen).to(torch.int32)
    return torch.cat([qs, other, rand], dim=1).contiguous(), length


def probe_fence_edges(dev: torch.device, gen: torch.Generator) -> tuple:
    """B6 against its plain version on the fence's edge cases: at the
    main shape's own fence (2^24 keys, a stride of 2,048 rows) and at the
    resident shape's (2^20 + 8,163 keys, not a multiple of its stride),
    with a planted run longer than the stride across fence points (every
    query of the run past the window must flag overflow); and on small
    indexes of 3 * 2^shift + 5 keys at explicit shifts, cut to 0, 1 and
    all of them live.  Returns (max abs error, the cases)."""
    worst, cases = 0, []
    pads = torch.tensor([I32_MAX, I32_MAX, 0, 0, 0, 0], dtype=torch.int32,
                        device=dev)[:, None]
    for n, cap in (PROBE_SHAPES[0], PROBE_SHAPES[2]):
        lanes, _planted = probe_lanes(dev, n, cap, gen)
        shift = tdi.fence_shift(n)
        qs, length = fence_edge_lanes(lanes, n, shift, gen)
        args = tdi.ProbeArgs(lanes.unbind(0), n)
        err, got = probe_check(lanes, n, qs, f" at fence shift {shift}", args)
        if length <= 1 << shift or not bool(
                got[2][-128 - length:-128].all()):
            fail(f"utxo_probe fence edges at {n} keys: the planted run of "
                 f"{length} rows did not flag overflow")
        worst = max(worst, err)
        cases.append([n, cap, shift, int(qs.shape[1])])
        del lanes, qs, args
    for shift in (4, 6, 9):
        n = 3 * (1 << shift) + 5
        lanes, _planted = probe_lanes(dev, n, tdi._pow2(n), gen)
        qs, _length = fence_edge_lanes(lanes, n, shift, gen)
        for n_live in (0, 1, n):
            cut = lanes.clone()
            cut[:, n_live:] = pads
            args = tdi.ProbeArgs(cut.unbind(0), n_live, shift)
            worst = max(worst, probe_check(cut, n_live, qs,
                                           f" at fence shift {shift}",
                                           args)[0])
            cases.append([n_live, int(cut.shape[1]), shift,
                          int(qs.shape[1])])
    return worst, cases


def probe_phase(dev: torch.device) -> dict:
    """Kernel B6 alone against its plain version at the main path's
    shapes and on the fence's edges, with times (the index's path:
    prepared arguments, ``tdi.launch``) beside ``torch.searchsorted`` in
    the same call, the launch path's breakdown and the bound; returns its
    record."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(PROBE_SEED)
    worst, times = 0, {}
    for n, cap in PROBE_SHAPES:
        t0 = time.perf_counter()
        lanes, planted = probe_lanes(dev, n, cap, gen)
        args = tdi.ProbeArgs(lanes.unbind(0), n)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        for q in PROBE_QUERIES:
            qs = probe_queries(lanes, n, q, gen, planted)
            qs[2, 15] ^= 1   # a present key with other check lanes
            qs[0, -1] = I32_MAX   # absent, on the pads' high lane
            err, (hit, key_hit, overflow, _lo, _hi) = probe_check(
                lanes, n, qs)
            worst = max(worst, err, probe_check(lanes, n, qs, "", args)[0])
            if not (bool(overflow[:12].all()) and bool(hit[12:15].all())
                    and bool(key_hit[15]) and not bool(hit[15])
                    and not bool(key_hit[-(q // 4):].any())):
                fail(f"utxo_probe at {n} keys, {q} queries: the planted "
                     "cases did not answer as planted")
            ms = cuda_ms(lambda: tdi.launch(args, qs), reps=10, warm=3,
                         per=10)
            lib_ms = cuda_ms(lambda: torch.searchsorted(lanes[0], qs[0]),
                             reps=10, warm=3, per=10)
            own_ms = kernel_only_ms(lambda: tdi.launch(args, qs),
                                    "utxo_probe_kernel")
            plain_ms = cuda_ms(lambda: tdi.probe_plain(*lanes, n, *qs),
                               reps=5, warm=1)
            nbytes = tdi.probe_bytes_needed(lanes[0], n, qs[0])
            bound_ms = nbytes / HBM_BYTES_S * 1e3
            times[(n, cap, q)] = (ms, plain_ms, lib_ms, bound_ms, own_ms)
            print(f"  utxo_probe keys={n} capacity={cap} queries={q} "
                  f"fence_shift={args.shift} fence={args.fence.shape[0]} "
                  f"kernel_ms={ms:.4f} searchsorted_ms={lib_ms:.4f} "
                  f"kernel_only_ms={own_ms} "
                  f"plain_ms={plain_ms:.4f} "
                  f"bound_bytes={nbytes} bound_ms={bound_ms:.6f} "
                  f"share={bound_ms / ms:.4f} build_s={build_s:.2f} "
                  f"hits={int(hit.sum())} key_only="
                  f"{int((key_hit & ~hit).sum())} "
                  f"overflow={int(overflow.sum())}", flush=True)
        if (n, cap) == PROBE_SHAPES[0]:
            path = probe_launch_path(args, probe_queries(
                lanes, n, PROBE_QUERIES[0], gen, planted))
            print("  utxo_probe_launch_path "
                  f"keys={n} queries={PROBE_QUERIES[0]} calls=1000 "
                  + " ".join(f"{k}_us={v:.3f}" for k, v in path.items()),
                  flush=True)
        del lanes, qs, args
    err, fence_cases = probe_fence_edges(dev, gen)
    worst = max(worst, err)
    # the edges: an empty index (its one pad row) and one live row
    pad = torch.tensor([[I32_MAX], [I32_MAX], [0], [0], [0], [0]],
                       dtype=torch.int32, device=dev)
    one = torch.tensor([[5], [-7], [11], [13], [17], [19]],
                       dtype=torch.int32, device=dev)
    for n_live, lanes in ((0, pad), (1, one)):
        qs = probe_queries(one, 1, 64, gen, [0])
        qs[0, 1] = I32_MAX
        worst = max(worst, probe_check(lanes, n_live, qs)[0])
    ms, plain_ms, lib_ms, bound_ms, own_ms = times[PROBE_SHAPES[0]
                                                  + (PROBE_QUERIES[0],)]
    attrs = tdi.kernel_attributes(dev)
    phase("utxo_probe_kernel_vs_plain", equal=True,
          shapes=json.dumps([list(k) for k in times]
                            + [[0, 1, 64], [1, 1, 64]]),
          fence_cases=json.dumps(fence_cases),
          resident_mb=round(6 * 4 * PROBE_SHAPES[0][1] / 1e6, 1),
          ms=round(ms, 4), plain_ms=round(plain_ms, 4),
          searchsorted_ms=round(lib_ms, 4), bound_ms=round(bound_ms, 6),
          bound_share=round(bound_ms / ms, 4),
          ms_by_shape=json.dumps({f"{n}/{cap}x{q}": round(t[0], 4)
                                  for (n, cap, q), t in times.items()}),
          searchsorted_ms_by_shape=json.dumps(
              {f"{n}/{cap}x{q}": round(t[2], 4)
               for (n, cap, q), t in times.items()}),
          kernel_only_ms_by_shape=json.dumps(
              {f"{n}/{cap}x{q}": t[4] for (n, cap, q), t in times.items()}),
          launch_path_us=round(path["whole"], 3), **attrs)
    return {"name": "utxo_probe", "route": "cuda",
            "source": "upow_tpu_torch/csrc/utxo_probe.cu",
            "replaces": "upow_tpu/state/device_index.py:171",
            "redesigned": "PR 10",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms, "registers": attrs["registers"],
            "shared_bytes": attrs["shared_bytes"],
            "kernel_only_ms": own_ms, "launch_path_us": path,
            "ms_micro_batch": times[PROBE_SHAPES[0] + (PROBE_QUERIES[1],)][0],
            "ms_by_shape": {f"{n}/{cap}x{q}": t[0]
                            for (n, cap, q), t in times.items()},
            "library_ms_by_shape": {f"{n}/{cap}x{q}": t[2]
                                    for (n, cap, q), t in times.items()}}


def synthetic_utxos(n: int, seed: int) -> list:
    """``n`` unspent_outputs rows of random outpoints and amounts."""
    rng = np.random.default_rng(seed)
    hexes = rng.bytes(32 * n).hex()
    idx = rng.integers(0, 4, size=n).tolist()
    amounts = rng.integers(1, 1 << 40, size=n).tolist()
    return [(hexes[64 * i:64 * i + 64], idx[i], "synthetic", amounts[i], 0)
            for i in range(n)]


def resident_probe_check(state, sample, where: str) -> dict:
    """B6 against its plain version on the card, bit for bit on all five
    outputs, on the lanes of the state's ``unspent_outputs`` index (its
    capacity and pad rows, as the accept probes them) with the queries of
    ``sample``: the whole of it, and one micro-batch's worth of it, each
    through the index's own prepared arguments (its fence) and through
    ``tdi.probe``."""
    index = state.resident_indexes()["unspent_outputs"]
    lanes, n_live = index._device_state()
    args = index._probe_args()
    ops = [tuple(o) for o in sample]
    qs = torch.from_numpy(tdi.query_lanes(
        tdi.fingerprint_batch(ops), tdi.check_batch(ops))).to(lanes.device)
    if n_live >= lanes.shape[1]:
        fail(f"resident probe check {where}: no pad row at {n_live} keys")
    err, got = probe_check(lanes, n_live, qs, f" {where}", args)
    mb = qs[:, :MICROBATCH].contiguous()
    err = max(err, probe_check(lanes, n_live, qs, f" {where}")[0])
    err_mb = max(probe_check(lanes, n_live, mb, f" {where}", args)[0],
                 probe_check(lanes, n_live, mb, f" {where}")[0])
    return {"n_live": n_live, "capacity": int(lanes.shape[1]),
            "queries": int(qs.shape[1]), "hits": int(got[0].sum()),
            "max_abs_err": max(err, err_mb)}


def resident_parity(state, sample, where: str, sql=None) -> None:
    """The resident probe, the shadow map and SQL agree on ``sample``;
    ``sql`` is the backend's own answer (default: the sqlite query)."""
    idx = state.resident_indexes()["unspent_outputs"]
    dev = [bool(v) for v in idx.contains_batch(sample)]
    shadow = [bool(v) for v in idx.shadow_contains_batch(sample)]
    if sql is None:
        rows = set()
        for lo in range(0, len(sample), 400):
            chunk = sample[lo:lo + 400]
            rows.update(state.db.execute(
                "SELECT tx_hash, idx FROM unspent_outputs WHERE"
                " (tx_hash, idx) IN (VALUES "
                + ",".join(["(?,?)"] * len(chunk)) + ")",
                [v for o in chunk for v in o]).fetchall())
        rows = {tuple(r) for r in rows}
        sql = [tuple(o) in rows for o in sample]
    if not dev == shadow == list(sql):
        fail(f"resident parity {where}: probe, shadow map and SQL differ")


async def accept_resident_path(dev: torch.device, kit: Kit, path: str,
                               leaves, content: str) -> dict:
    """The 8,160-tx block on the fused accept scan over a resident index
    of about 1.06 M entries, with the three-way parity after the accept,
    the reorg and the second accept; then on a copy without the index."""
    t0 = time.perf_counter()
    state = ChainState(device=dev)
    with sqlite3.connect(path) as src:
        src.backup(state.db)
    state.db.executemany(
        "INSERT INTO unspent_outputs (tx_hash, idx, address, amount,"
        " is_stake) VALUES (?,?,?,?,?)", synthetic_utxos(SYNTH_ROWS, 0x5D))
    state.db.commit()
    sql_state = ChainState(device=dev)
    state.db.backup(sql_state.db)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state.enable_device_index()
    arm_s = time.perf_counter() - t0
    index = state.resident_indexes()["unspent_outputs"]
    t0 = time.perf_counter()
    index.materialize()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    stats = index.stats()
    manager = BlockManager(state, device=dev)
    pre_hash = await state.get_unspent_outputs_hash()
    sample = [i.outpoint for t in leaves for i in t.inputs] \
        + [(t.hash(), 0) for t in leaves] + ABSENT
    probe_checks = [resident_probe_check(state, sample, "before the accept")]

    txverify.clear_sig_verdicts()
    trace.reset()
    p256.reset_counts()
    tsha.reset_counts()
    tdi.reset_counts()
    prof = start_profiler()
    errors = []
    t0 = time.perf_counter()
    ok = await manager.create_block(content, leaves, errors=errors)
    accept_s = time.perf_counter() - t0
    b6, jac, b5 = tdi.PROBE_LAUNCHES, p256.LAUNCHES, tsha.BLOCKS_LAUNCHES
    device = device_busy(prof, "utxo_probe_kernel")
    counters = trace.counters()
    probe_stage = trace.histograms().get(
        "pipeline.accept_probe.seconds", {}).get("sum", 0.0)
    if not ok:
        fail(f"resident accept rejected the block: {errors}")
    if b6 == 0 or jac == 0:
        fail(f"resident accept launches: probe {b6}, jac {jac}")
    if counters.get("index.probes", 0) == 0 \
            or counters.get("index.shadow_consults", 0) != 0:
        fail(f"resident accept index counters: {counters}")
    host_digest_fallbacks("resident accept")
    post_hash = await state.get_unspent_outputs_hash()
    trace.reset()
    probe_checks.append(resident_probe_check(state, sample,
                                             "after the accept"))
    # the one upload the check's first probe made (the index was dirty)
    uploads = trace.histograms().get("kernel.utxo_apply.dispatch_seconds",
                                     {"count": 0})
    resident_parity(state, sample, "after the accept")
    await state.remove_blocks(4)
    if await state.get_unspent_outputs_hash() != pre_hash:
        fail("remove_blocks(4) did not restore the UTXO hash")
    probe_checks.append(resident_probe_check(state, sample,
                                             "after remove_blocks(4)"))
    resident_parity(state, sample, "after remove_blocks(4)")
    clock.advance(60)
    errors = []
    if not await manager.create_block(await kit.header(manager, leaves),
                                      leaves, errors=errors):
        fail(f"resident accept of the same txs again: {errors}")
    resident_parity(state, sample, "after the second accept")
    stats_after = state.index_stats()
    state.close()

    sql_manager = BlockManager(sql_state, device=dev)
    txverify.clear_sig_verdicts()
    errors = []
    t0 = time.perf_counter()
    ok = await sql_manager.create_block(content, leaves, errors=errors)
    sql_accept_s = time.perf_counter() - t0
    if not ok or await sql_state.get_unspent_outputs_hash() != post_hash:
        fail(f"the SQL-scan accept differs from the resident one: {errors}")
    sql_state.close()
    return {"txs": len(leaves), "setup_s": setup_s, "arm_s": arm_s,
            "upload_s": upload_s, "upload_after_block_s":
            uploads["sum"] if uploads["count"] == 1 else None,
            "stats": stats,
            "accept_s": accept_s, "sql_accept_s": sql_accept_s,
            "b6": b6, "jac": jac, "b5": b5, "device": device,
            "probes": counters.get("index.probes", 0),
            "probe_outpoints": counters.get("index.probe_outpoints", 0),
            "shadow_consults": counters.get("index.shadow_consults", 0),
            "accept_probe_s": probe_stage,
            "shadow_consults_total": stats_after["shadow_consults"],
            "sample": len(sample), "probe_checks": probe_checks}


def push_block_resident_path(dev: torch.device, kit: Kit, workdir: Path,
                             leaves, content: str) -> dict:
    """The big block over HTTP to a node started with its UTXO index
    armed by ``UPOW_DEVICE_UTXO_INDEX=1``, then the tampered blocks."""
    db = str(workdir / "push_resident.db")
    shutil.copyfile(workdir / "base.db", db)
    os.environ["UPOW_DEVICE_UTXO_INDEX"] = "1"
    try:
        node = NodeThread(dev, db, "jac")
    finally:
        del os.environ["UPOW_DEVICE_UTXO_INDEX"]
    try:
        if not node.node.state.resident_indexes():
            fail("UPOW_DEVICE_UTXO_INDEX=1 did not arm the node's index")
        body = {"block_content": content, "txs": [t.hex() for t in leaves]}
        txverify.clear_sig_verdicts()
        trace.reset()
        p256.reset_counts()
        tsha.reset_counts()
        tdi.reset_counts()
        t0 = time.perf_counter()
        reply = node.request("push_block", body)
        wall_s = time.perf_counter() - t0
        out = {"wall_s": wall_s, "b6": tdi.PROBE_LAUNCHES,
               "jac": p256.LAUNCHES, "b5": tsha.BLOCKS_LAUNCHES,
               "consults": trace.counters().get(
                   "index.shadow_consults", 0)}
        if reply != {"ok": True}:
            fail(f"push_block to the resident node: {reply}")
        if out["b6"] == 0 or out["consults"]:
            fail(f"push_block to the resident node: {out}")
        rejected = []
        for txs in kit.tampered(leaves):
            clock.advance(60)
            header = node.call(kit.header(node.node.manager, txs))
            reply = node.request("push_block", {
                "block_content": header, "txs": [t.hex() for t in txs]})
            rejected.append(reply.get("error"))
        if rejected != REJECTED:
            fail(f"tampered blocks to the resident node: {rejected}")
        out["rejected"] = rejected
        out["counters"] = host_digest_fallbacks("push_block, resident")
    finally:
        node.close()
    return out


# --- phases 29 and 30: the wallet and snapshots ---------------------------

WALLET_SENDS = 64           # sequential /send_to_address requests
WALLET_AMOUNT = "0.0005"    # each send; a mid output (73,529 units) covers it
WALLET_DEST_SEED = 0x5E7D   # the recipient's key
SNAPSHOT_CHUNK = 1 << 16    # chunk bytes of the restore's generation
HONEST = 1024               # spends of the big block's outputs on R's tip


def wallet_path(dev: torch.device, kit: Kit, workdir: Path) -> dict:
    """The wallet against the port's node on a fresh copy of the chain's
    file: ``/send_to_address`` x 64, the wallet CLI and the nodeless
    wallet, then the miner's block of the 66."""
    wdir = workdir / "wallet"
    wdir.mkdir()
    db = str(wdir / "wallet.db")
    shutil.copyfile(workdir / "base.db", db)
    keys = wdir / "key_pair_list.json"
    keys.write_text(json.dumps(
        {"keys": [{"private_key": kit.d, "public_key": kit.addr}]}))
    dest = point_to_string(curve.keygen(rng=WALLET_DEST_SEED)[1])
    host_batches = []
    real_host_batch = txverify._host_batch

    def host_batch(*args, **kw):
        host_batches.append(len(args[0]))
        return real_host_batch(*args, **kw)
    here = os.getcwd()
    os.chdir(wdir)  # the node's KeyStore() reads the working directory
    txverify._host_batch = host_batch
    node = None
    try:
        node = NodeThread(dev, db, "jac", device__sig_backend="device")
        txverify.clear_sig_verdicts()
        trace.reset()
        p256.reset_counts()
        out = {}
        t0 = time.perf_counter()
        for k in range(WALLET_SENDS):
            _status, raw = asyncio.run(fetch(
                node.url + "send_to_address?" + urlencode(
                    {"to_address": dest, "amount": WALLET_AMOUNT}),
                headers={"Authorization": kit.addr}))
            reply = json.loads(raw)
            if not reply.get("ok"):
                fail(f"wallet: send {k}: {reply}")
        out["sends_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "upow_tpu_torch.wallet.cli", "send",
             "-to", dest, "-a", WALLET_AMOUNT, "--wallet", str(keys),
             "--db", db, "--node", node.url],
            capture_output=True, text=True, cwd=str(wdir), timeout=300,
            env=dict(os.environ, PYTHONPATH=str(
                Path(__file__).resolve().parent)))
        out["cli_s"] = time.perf_counter() - t0
        if cli.returncode != 0 or "Transaction pushed." not in cli.stdout:
            fail(f"wallet: cli send exited {cli.returncode}: "
                 f"{cli.stdout[-400:]} {cli.stderr[-400:]}")
        t0 = time.perf_counter()
        asyncio.run(NodelessWallet(node.url).send(kit.d, dest,
                                                  WALLET_AMOUNT))
        out["nodeless_s"] = time.perf_counter() - t0
        out.update(jac=p256.LAUNCHES, host_batches=len(host_batches),
                   pool=len(node.node.pool),
                   intake_batches=sum(node.node.intake.batch_sizes.values()))
        if out["pool"] != WALLET_SENDS + 2 or out["jac"] == 0 \
                or host_batches:
            fail(f"wallet: pool and launches {out}")

        clock.advance(60)
        tsha.reset_counts()
        t0 = time.perf_counter()
        rc = miner.run(kit.addr, node.url, "cuda", SEARCH_BATCH, 90.0,
                       once=True)
        out["miner_s"] = time.perf_counter() - t0
        out["b2"] = tsha.LAUNCHES
        tip = node.call(node.node.state.get_last_block())
        taken = len(node.call(node.node.state.get_block_transactions(
            tip["hash"]))) - 1
        info = node.request(f"get_address_info?address={dest}")["result"]
        out.update(height=tip["id"], block_txs=taken,
                   balance=str(info["balance"]))
        want = Decimal(WALLET_AMOUNT) * (WALLET_SENDS + 2)
        if rc != 0 or taken != WALLET_SENDS + 2 or out["b2"] == 0 \
                or Decimal(str(info["balance"])) != want:
            fail(f"wallet: miner.run rc {rc}, {out}, want {want}")
        host_digest_fallbacks("wallet_path")
    finally:
        txverify._host_batch = real_host_batch
        if node is not None:
            node.close()
        os.chdir(here)
    return out


def snapshot_path(dev: torch.device, kit: Kit, workdir: Path,
                  leaves) -> dict:
    """Node S builds a generation of phase 15's chain; node R, blank,
    with its index on the card, restores from S over HTTP, holds its
    index against its SQL, rejects the tampered blocks and accepts an
    honest block on its tip, as S does."""
    src = str(workdir / "snap_source.db")
    shutil.copyfile(workdir / "push_resident.db", src)
    out = {}
    source = NodeThread(dev, src, "jac",
                        snapshot__dir=str(workdir / "snap_s"),
                        snapshot__chunk_bytes=SNAPSHOT_CHUNK,
                        node__rate_limits_enabled=False)
    restored = None
    try:
        t0 = time.perf_counter()
        manifest = source.call(source.node.build_snapshot())
        out.update(build_s=time.perf_counter() - t0,
                   chunks=len(manifest["chunks"]),
                   bytes=manifest["payload_bytes"])
        want = source.call(_hashes(source.node.state))
        restored = NodeThread(dev, str(workdir / "snap_r.db"), "jac",
                              snapshot__dir=str(workdir / "snap_r"),
                              device__utxo_index=True,
                              device__txid_backend="device")
        state = restored.node.state
        if state.index_stats()["entries"] != 0:
            fail("snapshot: R's index is not empty before the restore")
        rearm = []
        build_index = state._build_index

        def timed_build():
            t = time.perf_counter()
            fresh = build_index()
            rearm.append(time.perf_counter() - t)
            return fresh
        state._build_index = timed_build
        t0 = time.perf_counter()
        res = restored.call(restored.node.bootstrap_from_snapshot(
            sources=[source.url.rstrip("/")]))
        out["restore_s"] = time.perf_counter() - t0
        state._build_index = build_index
        out["rearm_s"] = sum(rearm)
        if res.get("method") != "snapshot" or res.get("chunks") != \
                out["chunks"] or len(rearm) != 1:
            fail(f"snapshot: bootstrap {res}, re-arms {len(rearm)}")
        got = restored.call(_hashes(state))
        if got != want:
            fail(f"snapshot: R's fingerprints {got} != S's {want}")
        sample = [i.outpoint for t in leaves for i in t.inputs] \
            + [(t.hash(), 0) for t in leaves] + ABSENT

        async def parity(where):
            resident_parity(state, sample, where)
            return resident_probe_check(state, sample, where)
        out["probe_check"] = restored.call(parity("after the restore"))
        rows = restored.call(_row_counts(state))
        entries = {t: index.stats()["entries"]
                   for t, index in state.resident_indexes().items()}
        if entries != rows:
            fail(f"snapshot: R's index entries {entries}, rows {rows}")

        rejected = []
        for txs in kit.tampered(leaves):
            clock.advance(60)
            header = restored.call(kit.header(restored.node.manager, txs))
            reply = restored.request("push_block", {
                "block_content": header, "txs": [t.hex() for t in txs]})
            rejected.append(reply.get("error"))
        if rejected != REJECTED:
            fail(f"snapshot: tampered blocks to R: {rejected}")
        honest = [kit.spend([(t.hash(), 0)], [TxOutput(kit.addr,
                                                      t.outputs[0].amount)])
                  for t in leaves[:HONEST]]
        clock.advance(60)
        content = restored.call(kit.header(restored.node.manager, honest))
        body = {"block_content": content, "txs": [t.hex() for t in honest]}
        txverify.clear_sig_verdicts()
        trace.reset()
        p256.reset_counts()
        tsha.reset_counts()
        tdi.reset_counts()
        t0 = time.perf_counter()
        reply = restored.request("push_block", body)
        out["push_s"] = time.perf_counter() - t0
        out.update(b6=tdi.PROBE_LAUNCHES, jac=p256.LAUNCHES,
                   b5=tsha.BLOCKS_LAUNCHES,
                   consults=trace.counters().get("index.shadow_consults", 0))
        if reply != {"ok": True} or not (out["b6"] and out["jac"]
                                         and out["b5"]) or out["consults"]:
            fail(f"snapshot: honest block to R: {reply} {out}")
        host_digest_fallbacks("snapshot, the restored node's block")
        reply = source.request("push_block", body)
        if reply != {"ok": True}:
            fail(f"snapshot: honest block to S: {reply}")
        ends = [restored.call(state.get_unspent_outputs_hash()),
                source.call(source.node.state.get_unspent_outputs_hash())]
        if ends[0] != ends[1]:
            fail(f"snapshot: R and S differ after the honest block {ends}")
        out["probe_check_after"] = restored.call(parity(
            "after the honest block"))
    finally:
        if restored is not None:
            restored.close()
        source.close()
    return out


async def _row_counts(state) -> dict:
    """Rows of every UTXO-class table, by table."""
    return {t: len(await state.export_snapshot_rows(t))
            for t in state.resident_indexes()}


# --- phase 31: the cold-block archive ---------------------------------------

ARCHIVE_SEGMENT = 256       # archive.segment_blocks, the default users run
ARCHIVE_WINDOW = 64         # archive.safety_window, the default
MAX_INPUTS = 255            # inputs a tx may carry
ARCHIVE_HONEST = 64         # coinbase spends in A's block after the prune


def raw_get(node: NodeThread, path: str) -> tuple:
    """(status, body bytes) of one GET from this thread."""
    return asyncio.run(fetch(node.url + path))


async def _hot_block_rows(state, height: int) -> int:
    """Rows of ``blocks`` at ``height`` in the hot table alone."""
    return state.db.execute("SELECT COUNT(*) FROM blocks WHERE id = ?",
                            (height,)).fetchone()[0]


def archive_counts() -> dict:
    return {"jac": p256.LAUNCHES, "b2": tsha.LAUNCHES,
            "b5": tsha.BLOCKS_LAUNCHES, "b6": tdi.PROBE_LAUNCHES}


def archive_path(dev: torch.device, kit: Kit, workdir: Path,
                 leaves) -> dict:
    """Node A, on a copy of phase 15's file with its index on the card and
    the archive on at the default segment and safety window, takes blocks
    mined on the card that spend every output of blocks 1-4 and extend
    the chain past a full segment, builds a snapshot and compacts: blocks
    1-4 (the 8,160-tx block among them) leave its hot tables for a
    segment, and every read of them must answer as its unpruned twin's;
    its index must hold across the prune and take its next block.  Node J
    syncs the chain from genesis off A (its first blocks served from A's
    segment) and node M mirrors A's archive."""
    adir = workdir / "archive"
    adir.mkdir()
    a_db = str(adir / "a.db")
    shutil.copyfile(workdir / "push_resident.db", a_db)
    out, nodes = {}, []
    # the extension advances the script's clock a minute a block; the
    # later phases must see the clock the earlier phases left them
    resume = clock.timestamp()
    a = NodeThread(dev, a_db, "jac", device__utxo_index=True,
                   device__txid_backend="device",
                   node__rate_limits_enabled=False,
                   snapshot__dir=str(adir / "a.snap"),
                   archive__dir=str(adir / "a.archive"))
    nodes.append(a)
    try:
        state = a.node.state
        if a.cfg.archive.segment_blocks != ARCHIVE_SEGMENT \
                or a.cfg.archive.safety_window != ARCHIVE_WINDOW:
            fail(f"archive: defaults {a.cfg.archive}")
        txverify.clear_sig_verdicts()
        trace.reset()
        p256.reset_counts()
        tsha.reset_counts()
        tdi.reset_counts()

        def push(txs) -> None:
            clock.advance(60)
            header = a.call(kit.header(a.node.manager, txs))
            reply = a.request("push_block", {
                "block_content": header, "txs": [t.hex() for t in txs]})
            if reply != {"ok": True}:
                fail(f"archive: push_block at height "
                     f"{a.call(state.get_next_block_id())}: {reply}")

        # every output of blocks 1-4 still unspent (the big block's and
        # the coinbases), in txs of up to 255 inputs: one block
        t0 = time.perf_counter()
        outs = a.call(state.get_spendable_outputs(kit.addr))
        if len(outs) != len(leaves) + 3:
            fail(f"archive: {len(outs)} unspent outputs of blocks 1-4")
        spends = [kit.spend([(o.tx_hash, o.index) for o in chunk],
                            [TxOutput(kit.addr, sum(o.amount
                                                    for o in chunk))])
                  for chunk in (outs[k:k + MAX_INPUTS]
                                for k in range(0, len(outs), MAX_INPUTS))]
        push(spends)
        out["spend_txs"] = len(spends)
        # coinbase-only blocks to a tip at which [1, 256] lies below the
        # anchor less the safety window; the clock advances 60 s a block,
        # so the retargets keep the difficulty
        height = ARCHIVE_SEGMENT + ARCHIVE_WINDOW + 2
        while a.call(state.get_next_block_id()) <= height:
            push([])
        out["extension_s"] = time.perf_counter() - t0
        out["height"] = height
        out["difficulty"] = str(a.call(
            a.node.manager.calculate_difficulty())[0])
        out["extension"] = archive_counts()
        host_digest_fallbacks("archive, the extension")

        big = a.call(state.get_block_by_id(4))
        big_hashes = a.call(state.get_block_transaction_hashes(big["hash"]))
        twin_db = str(adir / "twin.db")
        with sqlite3.connect(a_db) as src, sqlite3.connect(twin_db) as dst:
            src.backup(dst)  # the unpruned twin, WAL included
        t0 = time.perf_counter()
        manifest = a.call(a.node.build_snapshot())
        out["snapshot_s"] = time.perf_counter() - t0
        hot_before = a.call(state.archive_hot_row_counts())
        t0 = time.perf_counter()
        stats = a.call(a.node.compact_archive())
        out["compact_s"] = time.perf_counter() - t0
        hot_after = a.call(state.archive_hot_row_counts())
        out.update(anchor=manifest["anchor_height"], stats=stats,
                   hot_before=hot_before, hot_after=hot_after)
        if not stats.get("ok") or stats["segments_built"] != 1 \
                or stats["archived_through"] != ARCHIVE_SEGMENT \
                or not stats["pruned_blocks"] or not stats["pruned_txs"]:
            fail(f"archive: compaction {stats}")
        if hot_before["blocks"] - hot_after["blocks"] \
                != stats["pruned_blocks"] \
                or hot_before["txs"] - hot_after["txs"] \
                != stats["pruned_txs"]:
            fail(f"archive: hot rows {hot_before} -> {hot_after}, {stats}")
        if a.call(_hot_block_rows(state, 4)):
            fail("archive: the 8,160-tx block stayed hot")

        status, body = raw_get(a, "archive/manifest")
        record = json.loads(body)["result"]["segments"][0]
        status0, seg = raw_get(a, "archive/segment/0")
        payload = bytes.fromhex(json.loads(seg)["result"]["data"])
        if status != 200 or status0 != 200 or hashlib.sha256(
                payload).hexdigest() != record["payload_sha256"]:
            fail(f"archive: /archive/* answered {status}, {status0}")
        out.update(segment_bytes=len(payload), segment_json_bytes=len(seg),
                   segment_txs=record["txs"])

        twin = NodeThread(dev, twin_db, "jac",
                          node__rate_limits_enabled=False)
        nodes.append(twin)
        reads = ["get_block?block=4&full_transactions=true",
                 f"get_block?block={big['hash']}",
                 "get_block_details?block=4",
                 f"get_transaction?tx_hash={big_hashes[1]}",
                 f"get_transaction?tx_hash={big_hashes[-1]}",
                 "get_blocks?offset=1&limit=8",
                 f"get_address_transactions?address={kit.addr}"
                 "&page=5&limit=100"]
        t0 = time.perf_counter()
        for path in reads:
            got = [raw_get(n, path) for n in (a, twin)]
            if got[0] != got[1] or got[0][0] != 200:
                fail(f"archive: {path} differs from the unpruned twin "
                     f"({got[0][0]}, {got[1][0]}, {len(got[0][1])} and "
                     f"{len(got[1][1])} bytes)")
        out["reads_s"] = time.perf_counter() - t0
        out["fallthrough_reads"] = state.archive.stats()["fallthrough_reads"]
        if not out["fallthrough_reads"]:
            fail("archive: no read fell through to the segment")
        if not state.archive.stats()["segments"] == 1:
            fail(f"archive: reader {state.archive.stats()}")

        # the index across the prune: probe, shadow map and SQL, then B6
        # against its plain version on its lanes
        spent = [(o.tx_hash, o.index) for o in outs]
        sample = spent + [(t.hash(), 0) for t in spends] + ABSENT

        async def parity(where):
            resident_parity(state, sample, where)
            return resident_probe_check(state, sample, where)
        out["probe_check"] = a.call(parity("after the prune"))
        coinbases = [o for o in a.call(state.get_spendable_outputs(kit.addr))
                     if o.tx_hash not in {t.hash() for t in spends}]
        honest = [kit.spend([(t.hash(), 0)],
                            [TxOutput(kit.addr, t.outputs[0].amount)])
                  for t in spends]
        honest += [kit.spend([(o.tx_hash, o.index)],
                             [TxOutput(kit.addr, o.amount)])
                   for o in coinbases[:ARCHIVE_HONEST]]
        txverify.clear_sig_verdicts()
        trace.reset()
        before = archive_counts()
        t0 = time.perf_counter()
        push(honest)
        out["honest_push_s"] = time.perf_counter() - t0
        after = archive_counts()
        out["honest"] = {k: after[k] - before[k] for k in after}
        out["honest"]["consults"] = trace.counters().get(
            "index.shadow_consults", 0)
        if not (out["honest"]["b6"] and out["honest"]["jac"]
                and out["honest"]["b5"]) or out["honest"]["consults"]:
            fail(f"archive: A's block after the prune {out['honest']}")
        host_digest_fallbacks("archive, A's block after the prune")
        out["honest_txs"] = len(honest)
        out["probe_check_after"] = a.call(parity("after A's next block"))

        # J syncs from genesis off A: the page below the seam is served
        # from A's segment
        j = NodeThread(dev, str(adir / "j.db"), "jac",
                       device__utxo_index=True,
                       device__txid_backend="device",
                       node__sync_fetch_interval=0)
        nodes.append(j)
        trace.reset()
        before = archive_counts()
        t0 = time.perf_counter()
        reply = sync_request(j, a)
        out["sync_s"] = time.perf_counter() - t0
        after = archive_counts()
        out["sync"] = {k: after[k] - before[k] for k in after}
        if reply != {"ok": True, "peer": a.url.rstrip("/")}:
            fail(f"archive: J's sync {reply}")
        ends = [(n.call(n.node.state.get_last_block())["hash"],
                 n.call(_hashes(n.node.state))) for n in (j, a)]
        if ends[0] != ends[1]:
            fail(f"archive: J {ends[0]} and A {ends[1]} differ")
        if not (out["sync"]["jac"] and out["sync"]["b5"]):
            fail(f"archive: J's sync launched {out['sync']}")
        out["sync_counters"] = host_digest_fallbacks("archive, J's sync")
        out["sync_blocks"] = j.call(j.node.state.get_next_block_id()) - 1
        out["all"] = archive_counts()

        # M mirrors A's archive; a second fetch reuses every segment
        m = NodeThread(dev, str(adir / "m.db"), "jac",
                       archive__dir=str(adir / "m.archive"))
        nodes.append(m)
        t0 = time.perf_counter()
        fetched = m.call(m.node.fetch_archive_from_peer(a.url.rstrip("/")))
        out["mirror_s"] = time.perf_counter() - t0
        again = m.call(m.node.fetch_archive_from_peer(a.url.rstrip("/")))
        if fetched != {"ok": True, "segments": 1, "fetched": 1, "reused": 0,
                       "archived_through": ARCHIVE_SEGMENT} \
                or again.get("reused") != 1 or again.get("fetched") != 0:
            fail(f"archive: M's mirror {fetched}, then {again}")
        name = record["name"]
        for f in ("payload.jsonl", "index.json"):
            if (adir / "a.archive" / name / f).read_bytes() != \
                    (adir / "m.archive" / name / f).read_bytes():
                fail(f"archive: M's {name}/{f} differs from A's")
    finally:
        for n in reversed(nodes):
            n.close()
        clock.freeze(resume)
    return out


# --- phase 32: the swarm's scenarios ---------------------------------------

SWARM_SEED = 7              # the fast matrix's seed, the CLI's default
SWARM_WIDE = (50, 3)        # partition_heal at the 10-50 node envelope's top
SWARM_FALLBACKS = ("txid.sample_mismatch", "sync.host_txid_retry")


def swarm_counts() -> dict:
    return {"jac": p256.LAUNCHES, "complete": p256.COMPLETE_LAUNCHES,
            "b5": tsha.BLOCKS_LAUNCHES, "b6": tdi.PROBE_LAUNCHES,
            "b2": tsha.LAUNCHES}


def _count_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def swarm_backends(inner):
    """A scenario's ``cfg_hook`` followed by the device backends: every
    verify, txid batch (from one payload) and UTXO probe of the node
    goes through the device runtime to the card."""
    def hook(i, cfg):
        if inner is not None:
            inner(i, cfg)
        cfg.device.sig_backend = "device"
        cfg.device.txid_backend = "device"
        cfg.device.txid_min_batch = 1
        cfg.device.utxo_index = True
    return hook


def swarm_spec(spec, card: bool, after):
    """The frozen ``ScenarioSpec`` replaced: on the card with the device
    backends, and ``after(swarm, launches)`` awaited between the
    scenario's end and its swarm's close (``launches`` the scenario's
    own counts, read before ``after`` runs anything)."""
    kwargs = dict(spec.swarm_kwargs)
    if card:
        kwargs["cfg_hook"] = swarm_backends(kwargs.get("cfg_hook"))

    async def fn(swarm, seed, _inner=spec.fn):
        before = swarm_counts()
        out = await _inner(swarm, seed)
        await swarm.settle()
        await after(swarm, _count_delta(swarm_counts(), before))
        return out
    return dataclasses.replace(spec, fn=fn, swarm_kwargs=kwargs)


def swarm_fallbacks(swarm) -> dict:
    """The two host-digest counters over the driver's registry and every
    node's own (the swarm's nodes count in their scopes)."""
    regs = [trace.counters()] + [node.telemetry_scope.metrics.counters()
                                 for node in swarm.nodes
                                 if node.telemetry_scope is not None]
    return {k: sum(r.get(k, 0) for r in regs) for k in SWARM_FALLBACKS}


def swarm_matrix(dev, card: bool, seen: dict) -> dict:
    """``run_matrix("fast")`` on ``dev`` with every spec replaced by
    :func:`swarm_spec`; ``seen[name]`` gets each scenario's launches and
    fallback counts, read before its swarm closes."""
    specs = dict(tsc.SCENARIOS)

    def after_for(name):
        async def after(swarm, launches):
            seen[name] = {"launches": launches,
                          "fallbacks": swarm_fallbacks(swarm)}
        return after
    try:
        for name, spec in specs.items():
            tsc.SCENARIOS[name] = swarm_spec(spec, card, after_for(name))
        return tsc.run_matrix("fast", seed=SWARM_SEED, device=dev)
    finally:
        tsc.SCENARIOS.update(specs)


def swarm_wide(dev, card: bool, check) -> tuple:
    """partition_heal at :data:`SWARM_WIDE` on ``dev`` with ``check``
    awaited before its swarm closes; (artifact, host seconds)."""
    nodes, seed = SWARM_WIDE
    spec = tsc.SCENARIOS["partition_heal"]
    tsc.SCENARIOS["partition_heal"] = swarm_spec(spec, card, check)
    try:
        t0 = time.perf_counter()
        art = tsc.run_scenario("partition_heal", nodes=nodes, seed=seed,
                               device=dev)
        return art, time.perf_counter() - t0
    finally:
        tsc.SCENARIOS["partition_heal"] = spec


def swarm_sample(state, seed: int, misses: int = 64) -> list:
    """Every unspent outpoint of ``state`` and ``misses`` seeded absent
    ones."""
    rows = [tuple(r) for r in state.db.execute(
        "SELECT tx_hash, idx FROM unspent_outputs ORDER BY tx_hash, idx")]
    rng = random.Random(seed)
    return rows + [(rng.randbytes(32).hex(), rng.randrange(4))
                   for _ in range(misses)]


def swarm_path(dev: torch.device) -> dict:
    """The swarm's ten scenarios (``run_matrix("fast")``, seed 7): on the
    host (``device="cpu"``, the JAX swarm's configuration), then with the
    swarm's nodes on the card and the device backends; each fingerprint
    the host's, every core flag true.  Then partition_heal at 50 nodes,
    seed 3, on the host and on the card: equal cores, every card node's
    UTXO fingerprint node 0's and the host run's, and every node's
    resident index held against its plain version and its SQL before
    the swarm closes.  The scenarios' deterministic worlds freeze the
    clock and reset the telemetry; the path puts back the frozen clock
    it found."""
    resume = clock.timestamp()
    out = {"host_walls": {}, "card_walls": {}, "per_scenario": {}}
    try:
        t0 = time.perf_counter()
        host = tsc.run_matrix("fast", seed=SWARM_SEED, device="cpu")
        out["host_s"] = time.perf_counter() - t0
        for run in host["runs"]:
            if not tsc.core_ok(run["core"]):
                fail(f"swarm: {run['scenario']} on the host: {run['core']}")
            out["host_walls"][run["scenario"]] = run["observed"]["elapsed_s"]
        out["host_fp"] = host["fingerprint"]

        txverify.clear_sig_verdicts()   # the host run's verdicts
        p256.reset_counts()
        tsha.reset_counts()
        tdi.reset_counts()
        seen = out["per_scenario"]
        t0 = time.perf_counter()
        card = swarm_matrix(dev, True, seen)
        out["card_s"] = time.perf_counter() - t0
        out["matrix"] = swarm_counts()
        want = {r["scenario"]: r for r in host["runs"]}
        for run in card["runs"]:
            name = run["scenario"]
            if run["fingerprint"] != want[name]["fingerprint"] \
                    or not tsc.core_ok(run["core"]):
                fail(f"swarm: {name} on the card: {run['fingerprint']} "
                     f"against the host's {want[name]['fingerprint']}: "
                     f"{run['core']}")
            if any(seen[name]["fallbacks"].values()):
                fail(f"swarm: {name}: hashlib stood in for device digests: "
                     f"{seen[name]['fallbacks']}")
            out["card_walls"][name] = run["observed"]["elapsed_s"]
        if card["fingerprint"] != host["fingerprint"]:
            fail(f"swarm: the card's matrix {card['fingerprint']} against "
                 f"the host's {host['fingerprint']}")
        out["card_recorders"] = {
            r["scenario"]: r.get("flight_recorder", {}).get("reason")
            for r in card["runs"]}
        out["host_recorders"] = {
            r["scenario"]: r.get("flight_recorder", {}).get("reason")
            for r in host["runs"]}

        wide = {}

        async def host_check(swarm, launches):
            wide["host_utxo"] = await swarm.nodes[0].state \
                .get_unspent_outputs_hash()

        async def card_check(swarm, launches):
            wide["launches"] = launches
            wide["fallbacks"] = swarm_fallbacks(swarm)
            hashes = [await node.state.get_unspent_outputs_hash()
                      for node in swarm.nodes]
            if len(set(hashes)) != 1 or hashes[0] != wide["host_utxo"]:
                fail(f"swarm: {len(set(hashes))} UTXO fingerprints over "
                     f"{len(hashes)} card nodes; node 0 {hashes[0]}, the "
                     f"host's {wide['host_utxo']}")
            checks = []
            for i, node in enumerate(swarm.nodes):
                sample = swarm_sample(node.state, i)
                checks.append(resident_probe_check(
                    node.state, sample, f"swarm node {i}"))
                resident_parity(node.state, sample, f"swarm node {i}")
            wide["probe_checks"] = checks

        host_wide, out["wide_host_s"] = swarm_wide("cpu", False, host_check)
        txverify.clear_sig_verdicts()
        card_wide, out["wide_card_s"] = swarm_wide(dev, True, card_check)
        for art in (host_wide, card_wide):
            if not tsc.core_ok(art["core"]):
                fail(f"swarm: partition_heal at {SWARM_WIDE}: {art['core']}")
        core = card_wide["core"]
        if core != host_wide["core"] or not (
                core["converged_after_heal"] and core["losers_reorged"]
                and core["trace_spans_nodes"]):
            fail(f"swarm: partition_heal at {SWARM_WIDE} on the card "
                 f"{core} against the host's {host_wide['core']}")
        if any(wide["fallbacks"].values()):
            fail(f"swarm: 50 nodes: hashlib stood in for device digests: "
                 f"{wide['fallbacks']}")
        out["wide"] = wide
        out["wide_fp"] = card_wide["fingerprint"]
        out["all"] = {k: out["matrix"][k] + wide["launches"][k]
                      for k in out["matrix"]}
        for k in ("jac", "b5", "b6"):
            if not out["all"][k]:
                fail(f"swarm: no {k} launch on the card's scenarios "
                     f"{out['all']}")
    finally:
        clock.freeze(resume)
    return out


def swarm_entry_points(want_fp: str) -> dict:
    """The three CLIs as a user runs them on a card machine, with no
    ``--device``, at once: the fast matrix (its fingerprint
    ``want_fp``), the selfcheck's two halves, the geo soak twice."""
    root = str(Path(__file__).resolve().parent)
    runs = {"swarm": ["upow_tpu_torch.swarm", "--matrix", "fast"],
            "selfcheck": ["upow_tpu_torch.telemetry.selfcheck"],
            "fleet": ["upow_tpu_torch.fleet", "--check-determinism"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-m", *argv], cwd=root,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, argv in runs.items()}
    out = {}

    def wait(k, proc):
        # each process's own wall: its pipes drained on a thread of its own
        stdout, stderr = proc.communicate(timeout=600)
        out[k] = (proc.returncode, stdout, stderr, time.perf_counter() - t0)
    waiters = [threading.Thread(target=wait, args=kv, daemon=True)
               for kv in procs.items()]
    try:
        for w in waiters:
            w.start()
        for w in waiters:
            w.join(660)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if len(out) != len(runs):
        fail(f"swarm: the entry points {sorted(set(runs) - set(out))} "
             f"did not finish")
    for k, (rc, stdout, stderr, _) in out.items():
        if rc != 0:
            fail(f"swarm: python -m {' '.join(runs[k])} exited {rc}: "
                 f"{stdout[-600:]} {stderr[-600:]}")
    last = json.loads(out["swarm"][1].splitlines()[-1])
    if last != {"kind": "swarm_matrix", "fingerprint": want_fp}:
        fail(f"swarm: the CLI's matrix {last} against {want_fp}")
    oks = [ln for ln in out["selfcheck"][1].splitlines()
           if ln.startswith("metrics-check: OK")]
    if len(oks) != 2 or "fleet" not in oks[1]:
        fail(f"swarm: the selfcheck printed {out['selfcheck'][1]}")
    if "ok   determinism: fp=" not in out["fleet"][1]:
        fail(f"swarm: the fleet CLI printed {out['fleet'][1]}")
    return {k: round(v[3], 3) for k, v in out.items()}


# --- phase 28: the PostgreSQL backend --------------------------------------

PG_ADMIT = 256              # of the big block's txs admitted by push_tx first


def pg_path(dev: torch.device, kit: Kit, workdir: Path, leaves,
            content: str) -> dict:
    """The port's node on its PostgreSQL backend: ``PgChainState`` over
    ``MockPgDriver(threadsafe=True)`` (no server or asyncpg on the card's
    machine; the node's loop thread makes every driver call), injected
    into a node served on its own loop thread, the resident index on the
    card and ``device.txid_backend = device``.  The 3-block base comes in as a sync page; then ``PG_ADMIT`` of
    the block's txs by ``push_tx``, the 8,160-tx ``push_block`` over
    HTTP, the tampered blocks, the probe against its plain version and
    the three-way parity against pg's SQL after the accept, the replay
    and ``remove_blocks(4)``, ``check_replay_pg``, and the reindex CLI's
    ``--check`` on the sqlite resident node's file.  Walls are host
    walls on the mock driver over sqlite, not on a PostgreSQL server."""
    resident_db = str(workdir / "push_resident.db")
    ref = ChainState(resident_db)
    want = asyncio.run(_hashes(ref))
    ref.close()
    base = ChainState(str(workdir / "base.db"))
    page = asyncio.run(base.get_blocks(1, 10))
    base.close()
    state = PgChainState(driver=MockPgDriver(threadsafe=True), device=dev)
    # the reference schema's two indexes (``PG_SCHEMA``'s CREATE INDEX
    # statements, which ``ensure_schema`` makes on a server), left out of
    # the mock's sqlite DDL: without them every outpoint DELETE of the
    # accept, the replay and the reorg scans its whole table
    for stmt in PG_SCHEMA:
        if stmt.startswith("CREATE INDEX"):
            state.drv.execute(stmt)
    # the digest prep on kernel B5 (``auto`` would hash a micro-batch's
    # 3,072 payloads with hashlib, below its 16,384 rule)
    node = NodeThread(dev, str(workdir / "pg.db"), "jac", state=state,
                      node__db_backend="postgres",
                      device__txid_backend="device")
    out = {}
    try:
        t0 = time.perf_counter()
        errors = []
        if not node.call(node.node.create_blocks(page, errors)):
            fail(f"pg: the base page was not accepted: {errors}")
        out["load_s"] = time.perf_counter() - t0

        async def arm():
            state.enable_device_index()
        t0 = time.perf_counter()
        node.call(arm())
        out["arm_s"] = time.perf_counter() - t0
        pre_hash = node.call(state.get_unspent_outputs_hash())

        admitted = leaves[:PG_ADMIT]
        t0 = time.perf_counter()
        replies = asyncio.run(_burst(node.url, [t.hex() for t in admitted]))
        out["admit_s"] = time.perf_counter() - t0
        if any(not r.get("ok") for r in replies):
            fail(f"pg: push_tx refused: {[r for r in replies if not r.get('ok')][:3]}")
        pending = node.call(state.get_pending_transactions_by_hash(
            [t.hash() for t in admitted]))
        if len(pending) != PG_ADMIT:
            fail(f"pg: {len(pending)} of {PG_ADMIT} admitted txs pending")

        body = {"block_content": content, "txs": [t.hex() for t in leaves]}
        txverify.clear_sig_verdicts()
        trace.reset()
        p256.reset_counts()
        tsha.reset_counts()
        tdi.reset_counts()
        t0 = time.perf_counter()
        reply = node.request("push_block", body)
        out["push_s"] = time.perf_counter() - t0
        out.update(b6=tdi.PROBE_LAUNCHES, jac=p256.LAUNCHES,
                   b5=tsha.BLOCKS_LAUNCHES,
                   consults=trace.counters().get("index.shadow_consults", 0))
        if reply != {"ok": True}:
            fail(f"pg: push_block: {reply}")
        if not (out["b6"] and out["jac"] and out["b5"]) or out["consults"]:
            fail(f"pg: push_block launches and consults: {out}")
        out["counters"] = host_digest_fallbacks("pg push_block")
        if node.call(state.get_pending_transactions_count()) != 0:
            fail("pg: the pending table is not empty after the block")
        got = node.call(_hashes(state))
        out["hashes_equal"] = got == want
        if not out["hashes_equal"]:
            fail(f"pg: fingerprints {got} != the sqlite node's {want}")

        rejected = []
        for txs in kit.tampered(leaves):
            clock.advance(60)
            header = node.call(kit.header(node.node.manager, txs))
            reply = node.request("push_block", {
                "block_content": header, "txs": [t.hex() for t in txs]})
            rejected.append(reply.get("error"))
        if rejected != REJECTED:
            fail(f"pg: tampered blocks: {rejected}")

        sample = [i.outpoint for t in leaves for i in t.inputs] \
            + [(t.hash(), 0) for t in leaves] + ABSENT

        def parity(where):
            sql = node.call(state._outpoints_exist_sql(sample,
                                                       "unspent_outputs"))
            resident_parity(state, sample, f"pg {where}", sql)
            return resident_probe_check(state, sample, f"pg {where}")

        out["probe_checks"] = [parity("after the accept")]
        t0 = time.perf_counter()
        before, after = node.call(check_replay_pg(state))
        out["replay_s"] = time.perf_counter() - t0
        out["replay_equal"] = before == after == got[1]
        if not out["replay_equal"]:
            fail(f"pg: check_replay_pg {before} -> {after}")
        out["probe_checks"].append(parity("after the replay"))
        t0 = time.perf_counter()
        node.call(state.remove_blocks(4))
        out["remove_s"] = time.perf_counter() - t0
        if node.call(state.get_unspent_outputs_hash()) != pre_hash:
            fail("pg: remove_blocks(4) did not restore the UTXO hash")
        out["probe_checks"].append(parity("after remove_blocks(4)"))
    finally:
        node.close()
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "upow_tpu_torch.state.reindex", "--db",
         resident_db, "--check"], capture_output=True, text=True,
        cwd=str(Path(__file__).resolve().parent), timeout=300)
    out["reindex_s"] = time.perf_counter() - t0
    out["reindex_rc"] = cli.returncode
    if cli.returncode != 0 or not cli.stdout.rstrip().endswith(
            "OK: live tables match the replay"):
        fail(f"pg: reindex --check exited {cli.returncode}: "
             f"{cli.stdout[-400:]} {cli.stderr[-400:]}")
    return out


async def _hashes(state) -> tuple:
    return (await state.get_unspent_outputs_hash(),
            await state.get_full_state_hash())


# --- phase 7: the hash rate ---------------------------------------------------

# --- phases 16-20: the w = 5 ladder, the mesh variants, two processes ----

# every window of the Jacobian ladder but the default 4: B7 (w = 5) and
# ROADMAP B7b's, w = 2 and 3 in csrc/p256_verify.cu and 6-13 in
# csrc/p256_verify_wide.cu
OTHER_WINDOWS = [w for w in p256.WINDOWS if w != 4]
# the wide kernel's groups a signature, each forced on the 1,026- and
# 33-lane inputs against the plain version, and timed at SWEEP_LANES of
# lanes whose keys pass their checks (as every lane of an accept's
# launch: a lane that fails them builds its table as one chain, and one
# such lane sets a launch's time)
FORCED_GROUPS = list(p256.WIDE_GROUPS)
SWEEP_LANES = [1, 33, 132, 264, 528, 1026, 2052]
KEYLESS = ("off_curve", "zero_pub")   # the mix's kinds with no valid key


def windows_phase(dev: torch.device, mix: tuple) -> list:
    """Each other window's kernel against its plain version, bit for bit,
    at 8,192, 1,026, 33 and 1 lanes (the plain version runs once, at
    8,192 lanes: each narrower launch's input is its first lanes), the
    collision lanes flagged and every kind's verdict; CUDA-event times
    with 10 launches queued beside w = 4's in turns (w = 4, w, w, w = 4)
    at 8,192, 1,026 and 1 lanes; the bound (the multiplies and, at the
    wide windows, the Q tables' bytes) and its share; resources and the
    scratch a launch allocates.  At the wide windows also each of
    ``FORCED_GROUPS`` forced on the 1,026- and 33-lane inputs, bit for
    bit, the groups a signature the wrapper picks and the scratch at each
    shape; on the lanes with valid keys (the accept's kind), every
    ``FORCED_GROUPS`` timed at each of ``SWEEP_LANES``, the 1,026-lane
    launch beside w = 4's in turns with its bound, and the 1,026- and
    1-lane times at G = 1 (one group a signature, the earlier layout).
    One kernel record a window."""
    digests, sigs, pubs, kinds = mix
    fused, zs, rs, ss, qxs, qys = p256._pack_device_inputs(
        digests, sigs, pubs, LANES)
    packed = p256.packed_tensor(fused, dev)
    parts = {width: packed[:, :width].contiguous()
             for width in (LANES, 1026, 33, 1)}
    keyed = [i for i, k in enumerate(kinds) if k not in KEYLESS]
    valid = {width: packed[:, keyed[:width]].contiguous()
             for width in SWEEP_LANES}
    props = torch.cuda.get_device_properties(dev)
    clock_mhz = tdevice.max_sm_clock_mhz() or props.clock_rate / 1000
    expect_exc = {i for i, k in enumerate(kinds) if k == "collision"}
    records = []
    for w in OTHER_WINDOWS:
        t0 = time.perf_counter()
        held = {}
        plain_ms = cuda_ms(lambda: held.__setitem__(
            "plain", p256.verify_plain(packed, w)), reps=1, warm=0)
        plain = held.pop("plain")
        max_abs_err = 0
        for width, part in parts.items():
            got = p256.verify_packed(part, window=w)
            torch.cuda.synchronize()
            max_abs_err = max(max_abs_err, int(
                (got.long() - plain[:width].long()).abs().max()))
            if not torch.equal(got, plain[:width]):
                bad = torch.nonzero(got != plain[:width]).flatten()[:8]
                fail(f"w = {w} kernel != plain at {width} lanes on "
                     f"{int((got != plain[:width]).sum())} lanes, first "
                     f"{bad.tolist()}")
            if width == LANES:
                bits = got.cpu().numpy()
        exc = {i for i in range(LANES) if bits[i] & 2}
        if not expect_exc <= exc:
            fail(f"w = {w}: crafted collision lanes were not flagged")
        for i, kind in enumerate(kinds):
            want = VERDICTS.get(kind)
            if want is not None and (bits[i] & 1) != want:
                fail(f"w = {w} lane {i} ({kind}): verdict {bits[i] & 1}")
        wide = {}
        if w not in p256.SHARED_WINDOWS:
            for groups in FORCED_GROUPS:
                for width in (1026, 33):
                    got = p256._verify(parts[width], w, groups=groups)
                    torch.cuda.synchronize()
                    if not torch.equal(got, plain[:width]):
                        fail(f"w = {w} kernel != plain at {width} lanes "
                             f"with {groups} groups a signature on "
                             f"{int((got != plain[:width]).sum())} lanes")
            sweep = {}
            for width, part in valid.items():
                got = p256.verify_packed(part, window=w)
                if not torch.equal(got, plain[keyed[:width]]):
                    fail(f"w = {w} kernel != plain on {width} valid lanes")
                sweep[width] = {groups: round(cuda_ms(
                    lambda: p256._verify(part, w, groups=groups), reps=2,
                    per=5), 4) for groups in FORCED_GROUPS}
            wide = {"forced_groups_equal": json.dumps(FORCED_GROUPS),
                    "valid_ms_by_groups": json.dumps(sweep),
                    "groups_by_lanes": json.dumps(
                        {n: p256._wide_plan(dev, n, w)[0]
                         for n in sorted(set(parts) | set(valid))}),
                    "scratch_by_lanes": json.dumps(
                        {n: p256.scratch_bytes(dev, n, w) for n in parts})}
        del plain
        torch.cuda.empty_cache()
        times = {}
        for width, part in [(LANES, parts[LANES]), (1026, parts[1026]),
                            (1, parts[1]), ("v1026", valid[1026])]:
            for ww in (4, w, w, 4):
                times.setdefault((ww, width), []).append(cuda_ms(
                    lambda: p256.verify_packed(part, window=ww),
                    reps=3, per=10))
        ms = {k: statistics.mean(v) for k, v in times.items()}
        if wide:
            for width, part in (("valid_1026", valid[1026]), (1, parts[1])):
                wide[f"ms_{width}_g1"] = round(cuda_ms(
                    lambda: p256._verify(part, w, groups=1),
                    reps=3, per=10), 4)
            # the bound of the accept's two shapes, as at 8,192 lanes
            for width, idx in (("valid_1026", keyed[:1026]), (1, [0])):
                sub = [[x[i] for i in idx] for x in (zs, rs, ss, qxs, qys)]
                wide[f"bound_ms_{width}"] = round(max(
                    p256.mul_ops_needed(*sub, w=w) / (
                        props.multi_processor_count * IMUL_PER_SM_CLK
                        * clock_mhz * 1e6) * 1e3,
                    p256.bytes_needed(*sub, w) / HBM_BYTES_S * 1e3), 4)
        ops = p256.mul_ops_needed(zs, rs, ss, qxs, qys, w=w)
        ops_ms = ops / (props.multi_processor_count * IMUL_PER_SM_CLK
                        * clock_mhz * 1e6) * 1e3
        nbytes = p256.bytes_needed(zs, rs, ss, qxs, qys, w)
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        source = "p256_verify" if w in p256.SHARED_WINDOWS \
            else "p256_verify_wide"
        phase("jac_windows_kernel_vs_plain", window=w, lanes=LANES,
              equal=True, equal_shapes=json.dumps(sorted(parts)),
              exception_lanes=len(exc), ms=round(ms[(w, LANES)], 4),
              ms_w4=round(ms[(4, LANES)], 4),
              turns_8192=json.dumps([round(t, 4) for t in
                                     times[(4, LANES)][:1] + times[(w, LANES)]
                                     + times[(4, LANES)][1:]]),
              ms_1026_lanes=round(ms[(w, 1026)], 4),
              ms_1026_lanes_w4=round(ms[(4, 1026)], 4),
              ms_1_lane=round(ms[(w, 1)], 4),
              ms_1_lane_w4=round(ms[(4, 1)], 4),
              ms_valid_1026=round(ms[(w, "v1026")], 4),
              ms_valid_1026_w4=round(ms[(4, "v1026")], 4),
              plain_ms=round(plain_ms, 1), bound_ms=round(bound_ms, 4),
              bound_by="operations" if ops_ms >= bytes_ms else "bytes",
              ops_ms=round(ops_ms, 4), bytes_ms=round(bytes_ms, 4),
              bound_share=round(bound_ms / ms[(w, LANES)], 4),
              int_mul_ops=ops, bytes=nbytes,
              products_per_lane=sum(p256.mults_per_lane("jac", w).values()),
              seconds=round(time.perf_counter() - t0, 1), **wide,
              **p256.kernel_attributes("p256_verify", dev, window=w,
                                       lanes=LANES))
        records.append({
            "name": f"p256_verify_w{w}", "route": "cuda",
            "source": f"upow_tpu_torch/csrc/{source}.cu",
            "replaces": "upow_tpu/crypto/p256.py:1016", "window": w,
            "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms[(w, LANES)], "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None})
    return records


def jac_kernel_name(w: int) -> str:
    """The Jacobian kernel's CUDA function at window ``w`` (its name in
    the profiler)."""
    if w not in p256.SHARED_WINDOWS:
        return "p256_verify_wide_kernel"
    return "p256_verify_kernel" if w == 4 else f"p256_verify_w{w}_kernel"


def accept_window(dev: torch.device, kit: Kit, path: str, leaves,
                  content: str, want_hash: str, w: int) -> dict:
    """The accept with ``device.verify_window = w`` applied through the
    config: the Jacobian kernel at window w only, and the w = 4 accept's
    UTXO hash."""
    DeviceConfig(verify_window=w).apply_kernel_overrides()
    try:
        out = asyncio.run(accept_path(dev, kit, path, leaves, content,
                                      kernel_name=jac_kernel_name(w)))
    finally:
        DeviceConfig(verify_window=4).apply_kernel_overrides()
    others = {k: v for k, v in out["by_window"].items() if k != w and v}
    if out["by_window"][w] == 0 or others:
        fail(f"the w = {w} accept's launches by window: {out['by_window']}")
    if out["utxo_hash"] != want_hash:
        fail(f"the w = {w} accept reached another UTXO hash")
    return out


# (start, count) of the engine checks: a hit, a miss (difficulty 9), a
# ragged last round, fewer nonces than shards (empty shards), and a round
# ending at 2^32 - 1
ENGINE_CASES = [("hit", "5", 0, SEARCH_BATCH),
                ("miss", "9", 1 << 28, SEARCH_BATCH),
                ("ragged", "4", 3 << 24, SEARCH_BATCH - 12345),
                ("fewer_than_shards", "1", 1000, 3),
                ("ends_at_2^32-1", "3", (1 << 32) - 1 - (1 << 20), 1 << 20)]


def engine_check(dev: torch.device, eng, addr: str) -> tuple:
    """Each case through the engine against one pow_search on one device
    and against the plain search; returns (hits, the largest difference
    between the engine's nonce and the plain search's)."""
    hits = worst = 0
    for name, diff, start, count in ENGINE_CASES:
        job = mine_engine.MiningJob.from_header_fields(
            previous_hash=random.Random(start).randbytes(32).hex(),
            address=addr, merkle_root=hashlib.sha256(b"mesh").hexdigest(),
            timestamp=1_760_000_000, difficulty=diff)
        eng.set_job(job)
        got = int(eng.dispatch(start, count))
        template = tsha.make_template(job.prefix)
        target = tsha.pack_target(tsha.target_spec(job.previous_hash, diff))
        one = int(tsha.pow_search(template, target, start, count, device=dev))
        plain = int(tsha.pow_search_plain(template, target, start, count,
                                          dev))
        worst = max(worst, abs(got - plain))
        if not got == one == plain:
            fail(f"mesh {name} on {eng.n_devices} shards: engine {got}, "
                 f"one launch {one}, plain {plain}")
        if name == "miss" and got != SENTINEL:
            fail(f"mesh {name}: a hit at {got}")
        if got != SENTINEL and not job.check(got):
            fail(f"mesh {name}: {got} fails the hashlib check")
        hits += got != SENTINEL
    return hits, worst


def mesh_search_phase(dev: torch.device, kit: Kit, workdir: Path) -> dict:
    """The mesh search: MeshEngine on the visible cards (one here) and on
    an explicit 4-shard mesh on the card, each against one pow_search
    launch and the plain search (hit, miss, ragged round, empty shards,
    the top of the nonce space); a range wrapping past 2^32 through
    pow_search_resident; a 2^24 round on 4 shards against one launch of
    2^24, and the engine's host time a round; then ``miner.run`` with
    ``device="mesh"`` against the port's node, its block accepted."""
    mesh_engine.reset_mesh_engine()
    one = mesh_engine.get_mesh_engine(mesh_devices=0, round_hint=SEARCH_BATCH)
    one.arm()
    four = mesh_engine.MeshEngine(round_hint=SEARCH_BATCH,
                                  devices=[dev] * 4)
    four.arm()
    if one.n_devices != torch.cuda.device_count() or four.n_devices != 4:
        fail(f"mesh sizes {one.n_devices} and {four.n_devices}")
    (h1, w1), (h4, w4) = (engine_check(dev, eng, kit.addr)
                          for eng in (one, four))
    # shards whose lanes would pass 2^32: those lanes drop out
    job = mine_engine.MiningJob.from_header_fields(
        previous_hash=random.Random(32).randbytes(32).hex(), address=kit.addr,
        merkle_root=hashlib.sha256(b"wrap").hexdigest(),
        timestamp=1_760_000_000, difficulty="1.5")
    template = tsha.make_template(job.prefix)
    target = tsha.pack_target(tsha.target_spec(job.previous_hash, "1.5"))
    top = (1 << 32) - 3000
    bases, limits = [top, top + 1000, 5, top + 2000], \
        [(1 << 32) - 1, (1 << 32) - 1, 5, (1 << 32) - 1]
    wrap = int(pmesh.pow_search_resident(
        template.midstate, template.tail_words, bases, limits, target, 4096,
        template.nonce_spec, four.mesh))
    want = int(tsha.pow_search_plain(template, target, top,
                                     (1 << 32) - 1 - top, dev))
    if wrap != want or wrap == SENTINEL:
        fail(f"wrapping shards: {wrap}, the plain search {want}")

    # a 2^24 round on 4 shards against one launch of the same nonces (the
    # sweep's template: no hit), and the engine's host time a round
    sweep = sweep_job(kit.addr)
    template = tsha.make_template(sweep.prefix)
    target = tsha.pack_target(tsha.target_spec(sweep.previous_hash,
                                               sweep.difficulty))
    four.set_job(sweep)
    one.set_job(sweep)
    t = {"one_launch": [], "four_shards": []}
    for _ in range(2):
        t["one_launch"].append(cuda_ms(lambda: tsha.pow_search(
            template, target, 0, SEARCH_BATCH, device=dev), reps=5, per=10))
        t["four_shards"].append(cuda_ms(lambda: pmesh.pow_search_sharded(
            template, target, 0, SEARCH_BATCH // 4, four.mesh), reps=5,
            per=10))
    rounds = 20
    host = {}
    for name, fn in (
            ("direct", lambda: int(mine_engine._ReadBack(tsha.pow_search(
                template, target, 0, SEARCH_BATCH, device=dev)))),
            ("engine_1", lambda: int(one.dispatch(0, SEARCH_BATCH))),
            ("engine_4", lambda: int(four.dispatch(0, SEARCH_BATCH)))):
        fn()
        t0 = time.perf_counter()
        for _ in range(rounds):
            fn()
        host[name] = (time.perf_counter() - t0) / rounds * 1e3
    plain_ms = cuda_ms(lambda: tsha.pow_search_plain(
        template, target, 0, SEARCH_BATCH, dev), reps=1, warm=0)

    # the miner with --device mesh against the port's node: the engine
    # armed inside the path, a coinbase-only block 4 accepted
    db = str(workdir / "mesh_miner.db")
    shutil.copyfile(workdir / "base.db", db)
    node = NodeThread(dev, db, "jac")
    try:
        mesh_engine.reset_mesh_engine()
        clock.advance(60)
        tsha.reset_counts()
        pmesh.reset_counts()
        t0 = time.perf_counter()
        rc = miner.run(kit.addr, node.url, "mesh", SEARCH_BATCH, 90.0,
                       once=True, mesh_devices=0)
        run_s = time.perf_counter() - t0
        launches = pmesh.SEARCH_LAUNCHES
        tip = node.call(node.node.state.get_last_block())
        stats = mesh_engine.engine_stats()
    finally:
        node.close()
    if rc != 0 or tip["id"] != 4:
        fail(f"miner.run --device mesh: rc {rc}, tip {tip['id']}")
    if launches == 0 or not stats["armed"]:
        fail(f"the mesh miner's launches {launches}, stats {stats}")
    phase("mesh_search", cases=2 * len(ENGINE_CASES), equal=True,
          hits=h1 + h4, wrap_hit=wrap, shards=json.dumps([1, 4]),
          round_2e24_ms_one_launch=json.dumps(
              [round(x, 4) for x in t["one_launch"]]),
          round_2e24_ms_four_shards=json.dumps(
              [round(x, 4) for x in t["four_shards"]]),
          host_ms_a_round=json.dumps({k: round(v, 4)
                                      for k, v in host.items()}),
          plain_ms=round(plain_ms, 1), miner_rc=rc, miner_tip=tip["id"],
          miner_launches=launches, miner_rounds=stats["dispatches"],
          miner_s=round(run_s, 3), arm=json.dumps(stats["arm_ladder"]))
    return {"launches": launches, "max_abs_err": max(w1, w4),
            "ms": statistics.mean(t["four_shards"]),
            "one_launch_ms": statistics.mean(t["one_launch"]),
            "plain_ms": plain_ms}


def mesh_verify_phase(dev: torch.device, kit: Kit, path: str, leaves,
                      content: str, want_hash: str, mix: tuple) -> dict:
    """The sharded verify: verify_packed_sharded with 4 shards on the card
    equal to the unsharded launch lane for lane (8,192 lanes and the
    1,026-lane shape), times; then the accept with ``verify_mesh_devices
    = 0`` (one card: no mesh) and with an explicit 4-shard mesh, each to
    the w = 4 accept's UTXO hash."""
    digests, sigs, pubs, _kinds = mix
    fused = p256._pack_device_inputs(digests, sigs, pubs, LANES)[0]
    packed = p256.packed_tensor(fused, dev)
    four = pmesh.make_mesh([dev] * 4)
    max_abs_err = 0
    for width in (LANES, 1026, 3):
        part = packed[:, :width].contiguous()
        got = pmesh.verify_packed_sharded(part, four)
        want = p256.verify_packed(part)
        torch.cuda.synchronize()
        max_abs_err = max(max_abs_err,
                          int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            fail(f"sharded verify != unsharded at {width} lanes")
    t = {"unsharded": [], "four_shards": []}
    for _ in range(2):
        t["unsharded"].append(cuda_ms(lambda: p256.verify_packed(packed),
                                      reps=5, per=10))
        t["four_shards"].append(cuda_ms(
            lambda: pmesh.verify_packed_sharded(packed, four), reps=5,
            per=10))
    zero = asyncio.run(accept_path(dev, kit, path, leaves, content,
                                   verify_mesh_devices=0))
    sharded = asyncio.run(accept_path(dev, kit, path, leaves, content,
                                      verify_mesh_devices=four))
    if zero["utxo_hash"] != want_hash or sharded["utxo_hash"] != want_hash:
        fail("an accept on a mesh reached another UTXO hash")
    if zero["sharded_launches"] != 0 or sharded["sharded_launches"] == 0:
        fail(f"sharded launches: mesh 0 {zero['sharded_launches']}, "
             f"explicit 4 {sharded['sharded_launches']}")
    phase("mesh_verify", lanes=LANES, shards=4, equal=True,
          equal_shapes=json.dumps([LANES, 1026, 3]),
          ms_unsharded=json.dumps([round(x, 4) for x in t["unsharded"]]),
          ms_four_shards=json.dumps([round(x, 4) for x in t["four_shards"]]),
          accept_mesh0_s=round(zero["accept_s"], 3),
          accept_mesh0_launches=zero["launches"],
          accept_four_shards_s=round(sharded["accept_s"], 3),
          accept_four_shards_launches=sharded["sharded_launches"],
          same_utxo_hash=True)
    return {"launches": sharded["sharded_launches"],
            "ms": statistics.mean(t["four_shards"]),
            "max_abs_err": max_abs_err}


_MULTIHOST_CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
from upow_tpu_torch.mine import engine
from upow_tpu_torch.parallel import multihost

assert multihost.initialize({coord!r}, num_processes=2, process_id={pid},
                            timeout=120.0)
lo, hi = multihost.my_nonce_range(0, {span})
job = engine.MiningJob({prefix!r}, {prev!r}, __import__("decimal").Decimal({diff!r}))
res = engine.mine(job, {backend!r}, start=lo, stride_end=hi, batch=1 << 24)
local = res.nonce if res.nonce is not None else 0xFFFFFFFF
best = torch.tensor([local], dtype=torch.int64)
dist.all_reduce(best, op=dist.ReduceOp.MIN)
print("RESULT " + json.dumps({{"range": [lo, hi], "local": local,
                               "global": int(best)}}), flush=True)
dist.destroy_process_group()
"""


def multihost_phase(addr: str, backend: str = "cuda",
                    span: int = 1 << 26) -> dict:
    """Two processes on the one card rendezvous over gloo
    (``multihost.initialize``); each mines its planned half of ``span``
    nonces with kernel B2 (built by this process already, so the children
    only load it), and an all_reduce(MIN) agrees on the winner, which
    must equal this process's search of the whole range."""
    job = mine_engine.MiningJob.from_header_fields(
        previous_hash=random.Random(26).randbytes(32).hex(), address=addr,
        merkle_root=hashlib.sha256(b"multihost").hexdigest(),
        timestamp=1_760_000_000, difficulty="5.5")
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("UPOW_COORDINATOR_ADDRESS", "WORLD_SIZE", "RANK")}
    root = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MULTIHOST_CHILD.format(
            root=root, coord=f"127.0.0.1:{port}", pid=i, span=span,
            backend=backend,
            prefix=job.prefix, prev=job.previous_hash,
            diff=str(job.difficulty))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            if p.returncode != 0:
                fail(f"multihost child rc {p.returncode}: {err[-1500:]}")
            line = [x for x in out.splitlines() if x.startswith("RESULT ")]
            if len(line) != 1:
                fail(f"multihost child printed no result: {out[-500:]}")
            results.append(json.loads(line[0][7:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    whole = mine_engine.mine(job, backend, start=0, stride_end=span,
                             batch=SEARCH_BATCH).nonce
    whole = SENTINEL if whole is None else whole
    ranges = [r["range"] for r in results]
    if ranges != [[0, span // 2], [span // 2, span]]:
        fail(f"multihost ranges {ranges}")
    if any(r["global"] != whole for r in results) or whole == SENTINEL \
            or min(r["local"] for r in results) != whole:
        fail(f"multihost winners {results}, one search {whole}")
    phase("multihost", processes=2, backend="gloo", span=span,
          winner=whole, locals=json.dumps([r["local"] for r in results]),
          wall_s=round(wall_s, 3))
    return {"winner": whole}


def hashrate_phase(key: tuple) -> dict:
    addr = point_to_string(key[1])
    job = sweep_job(addr)
    tsha.reset_counts()
    prof = start_profiler()
    t0 = time.perf_counter()
    res = mine_engine.mine(job, "cuda", batch=SEARCH_BATCH, ttl=600.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = tsha.LAUNCHES
    device = device_busy(prof, "sha256_search_kernel")
    full = mine_engine.MAX_SEARCH_END
    if res.nonce is None and res.hashes_tried != full:
        fail(f"the sweep tried {res.hashes_tried} of {full} nonces")
    # turns in the same call: rounds launched directly (no runtime), then
    # through the runtime again, then directly again
    turns = []
    for how in ("direct", "runtime", "direct"):
        t1 = time.perf_counter()
        if how == "direct":
            tried = direct_sweep(job)
        else:
            tried = mine_engine.mine(job, "cuda", batch=SEARCH_BATCH,
                                     ttl=600.0).hashes_tried
        torch.cuda.synchronize()
        if tried != full:
            fail(f"the {how} sweep tried {tried} of {full} nonces")
        turns.append((how, round(tried / (time.perf_counter() - t1) / 1e9,
                                 4)))
    # BASELINE config 2: a fractional difficulty mined to a checked hit
    job63 = mine_engine.MiningJob.from_header_fields(
        previous_hash=random.Random(63).randbytes(32).hex(), address=addr,
        merkle_root=hashlib.sha256(b"6.3").hexdigest(),
        timestamp=1_760_000_000, difficulty="6.3")
    t1 = time.perf_counter()
    res63 = mine_engine.mine(job63, "cuda", batch=SEARCH_BATCH)
    s63 = time.perf_counter() - t1
    if res63.nonce is None or not job63.check(res63.nonce):
        fail(f"difficulty 6.3: {res63}")
    return {"tried": res.hashes_tried, "seconds": seconds,
            "hit": res.nonce, "launches": launches, "device": device,
            "nonce_6_3": res63.nonce, "tried_6_3": res63.hashes_tried,
            "seconds_6_3": s63, "turns": turns}


def direct_sweep(job) -> int:
    """The sweep's rounds launched straight from this thread, with
    ``mine()``'s two rounds in flight and its read-back; the hashes
    tried (the sweep's template has no hit)."""
    dev = torch.device("cuda")
    template = tsha.make_template(job.prefix)
    target = tsha.pack_target(tsha.target_spec(job.previous_hash,
                                               job.difficulty))
    end, cursor, tried, inflight = mine_engine.MAX_SEARCH_END, 0, 0, []
    while cursor < end or inflight:
        while len(inflight) < 2 and cursor < end:
            count = min(SEARCH_BATCH, end - cursor)
            inflight.append((mine_engine._ReadBack(tsha.pow_search(
                template, target, cursor, count, device=dev)), count))
            cursor += count
        handle, count = inflight.pop(0)
        if int(handle) != SENTINEL:
            fail("the sweep template hit in a direct round")
        tried += count
    return tried


def kernel_only_ms(fn, kernel_name: str, calls: int = 20):
    """The named kernel's mean device time over ``calls`` calls of
    ``fn`` under the profiler (the kernel alone, without the host's
    launch path), rounded to 0.1 us; "not_measured" where the profiler
    sees no such kernel."""
    fn()
    torch.cuda.synchronize()
    prof = start_profiler()
    for _ in range(calls):
        fn()
    use = device_busy(prof, kernel_name)
    if not use.get("kernel_events"):
        return "not_measured"
    return round(use["kernel_s"] / use["kernel_events"] * 1e3, 4)


def start_profiler():
    """A CUDA-activity-only ``torch.profiler`` session, or None where the
    machine's profiler cannot start (then the idle share is reported as
    not measured; the accept itself runs either way)."""
    try:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        return prof
    except Exception as e:  # noqa: BLE001  (measurement only)
        print(f"  profiler did not start: {e}", flush=True)
        return None


def device_busy(prof, kernel_name: str) -> dict:
    """Seconds the card was busy (the union of every device activity's
    interval: kernels and copies) and in the named kernel, from a
    session started by :func:`start_profiler`."""
    if prof is None:
        return {}
    torch.cuda.synchronize()
    try:
        prof.__exit__(None, None, None)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as e:  # noqa: BLE001  (measurement only)
        print(f"  profiler did not stop cleanly: {e}", flush=True)
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    kernel = [e for e in events if kernel_name in e.name]
    return {"events": len(events), "busy_s": busy_us / 1e6,
            "kernel_events": len(kernel),
            "kernel_s": sum(e.time_range.elapsed_us() for e in kernel) / 1e6}


def accept_breakdown() -> dict:
    """Seconds by stage of one block accept, from the port's span stats
    and histograms (counted since the last ``trace.reset()``)."""
    spans, hists = trace.stats(), trace.histograms()
    out = {name: round(spans[name]["total_s"], 4) for name in (
        "block_accept", "block.header_check", "block.sig_verify",
        "block.utxo_apply") if name in spans}
    for stage in ("block_decode", "block_sig_wait"):
        out[stage] = round(hists.get(f"pipeline.{stage}.seconds",
                                     {}).get("sum", 0.0), 4)
    calls = hists.get("kernel.p256_verify.dispatch_seconds",
                      {"count": 0, "sum": 0.0})
    out["verify_calls"] = calls["count"]
    out["verify_call_s"] = round(calls["sum"], 4)
    return out


def device_phase(title: str, dev_use: dict, wall_s: float) -> None:
    if dev_use.get("events"):
        phase(title, events=dev_use["events"],
              busy_s=round(dev_use["busy_s"], 4),
              kernel_events=dev_use["kernel_events"],
              kernel_s=round(dev_use["kernel_s"], 4),
              idle_share=round(1 - dev_use["busy_s"] / wall_s, 4))
    else:
        phase(title, idle_share="not_measured")


def sass_counts(name: str, inside: str = "") -> tuple:
    """(instructions in the kernel, opcode counts inside its loop) from
    cuobjdump's SASS of the built library, NOPs left out.  The loop is
    the longest backward branch's span that holds the opcode ``inside``
    (any, if empty): one nonce a trip in the search kernel; in the P-256
    kernels, with ``inside="WARPSYNC"`` (the group's sync), one ladder
    round (the complete kernel's six point operations share one copy of
    the four-step add; the Jacobian kernel's round holds the doubling's
    loop, the madd and the add).  (0, {}) where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return 0, {}
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    code = [(int(a, 16), op, args) for a, op, args in SASS_LINE.findall(sass)
            if op != "NOP"]
    lo, hi = 0, -1
    for addr, op, args in code:
        target = re.findall(r"0x[0-9a-f]+", args) if op == "BRA" else []
        if not target or int(target[-1], 16) >= addr \
                or addr - int(target[-1], 16) <= hi - lo:
            continue
        start = int(target[-1], 16)
        if not inside or any(o == inside for a, o, _ in code
                             if start <= a <= addr):
            lo, hi = start, addr
    loop = collections.Counter(op for a, op, _ in code if lo <= a <= hi)
    return len(code), loop


def sass_functions(lib: str) -> dict:
    """{kernel function: (SASS instructions, the first 16 hex digits of the
    sha256 of their text)} of a built library, from cuobjdump, NOPs left
    out: two builds of the same kernel code give the same pair.  {} where
    the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        code = [" ".join(i.split()) for i in SASS_TEXT.findall(block)
                if not i.strip().startswith("NOP")]
        out[name] = (len(code), hashlib.sha256(
            "\n".join(code).encode()).hexdigest()[:16])
    return out


# --- phase 23: the device runtime ------------------------------------------

# the walls of the last run before the device runtime (PERF.md run AK,
# printed by this script on an NVIDIA H100 80GB HBM3 at 700 W), printed
# beside this run's
BEFORE_RUNTIME = {"accept_s": 0.597, "node_burst_s": 2.663,
           "push_block_jac_s": 2.023, "sync_s": 1.919, "gossip_hop_s": 1.932}
RUNTIME_SOURCES = 32          # sig batches held, then released together
RUNTIME_BATCH = 256           # checks in each
FLOOD_ROUNDS = 64             # B2 rounds of 2^24 in the fair-share flood
COST_CALLS = 1000             # one-check batches timed for the hop's cost


def degrade_clean(where: str) -> None:
    """Fails on any failure the verify path's degrade recorded since its
    last reset: a degrade that hid a broken kernel fails the run."""
    snap = txverify.DEGRADE.snapshot()
    if snap["errors"] or snap["state"] != "ok":
        fail(f"{where}: the degrade recorded {snap['errors']} failure(s), "
             f"state {snap['state']}: {snap['last_error']}")


def fresh_runtime(dev: torch.device, after: str) -> dict:
    """Checks the degrade after the phase ``after``, then a fresh device
    runtime armed on the card, its warm launches made before the next
    phase resets any count."""
    degrade_clean(after)
    truntime.reset_runtime()
    return truntime.get_runtime(dev).arm()


def leaf_checks(txs, pub) -> list:
    """The signature checks of one-input txs, as check_block collects
    them: (digest, hex-form digest, signature, key)."""
    out = []
    for tx in txs:
        signing = tx.hex(False)
        out.append((hashlib.sha256(bytes.fromhex(signing)).digest(),
                    hashlib.sha256(signing.encode()).digest(),
                    tx.inputs[0].signature, pub))
    return out


def us_per_call(fn, calls: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def runtime_arm_line(info: dict, card: str) -> None:
    bad = [w for w in info["warmed"] if w["status"] != "ok"]
    if info["platform"] != "cuda" or bad or len(info["warmed"]) < 4:
        fail(f"runtime arm: {info}")
    phase("runtime_arm", platform=info["platform"],
          card_name=json.dumps(info["card"]),
          probe_seconds=info["probe_seconds"],
          warmed=json.dumps({w["kernel"]: [w["status"], w["seconds"]]
                             for w in info["warmed"]}),
          card=json.dumps(card))


def runtime_path(dev: torch.device, block: list, mix: tuple,
                 card: str) -> dict:
    """The device runtime on the card: its arm, cross-source coalescing,
    fair share against a miner flood, its own cost a dispatch, a degrade
    round trip under injected faults, and the native host batch."""
    out = {}
    truntime.reset_runtime()
    rt = truntime.get_runtime(dev)
    runtime_arm_line(rt.arm(), card)

    # 1. coalescing: 32 sources' batches of the mix held, then released
    digests, sigs, pubs, _kinds = mix
    checks = [(d, d, s, q) for d, s, q in zip(digests, sigs, pubs)]
    parts = [checks[i * RUNTIME_BATCH:(i + 1) * RUNTIME_BATCH]
             for i in range(RUNTIME_SOURCES)]
    txverify.clear_sig_verdicts()
    p256.reset_counts()
    d0, s0 = rt.dispatches, rt.submissions
    t0 = time.perf_counter()
    with rt.hold():
        futs = [rt.submit_sig_checks(part, backend="device",
                                     source=f"src{i:02d}")
                for i, part in enumerate(parts)]
    got = [v for f in futs for v in f.result(timeout=300)]
    held_s = time.perf_counter() - t0
    launches = p256.LAUNCHES
    dispatches, submissions = rt.dispatches - d0, rt.submissions - s0
    want = txverify.run_sig_checks(sum(parts, []), backend="device",
                                   device=dev, use_cache=False)
    if got != want:
        fail("runtime coalescing: the verdicts differ from one direct "
             "run_sig_checks")
    if dispatches != 1:
        fail(f"runtime coalescing: {dispatches} dispatches for "
             f"{submissions} submissions")
    phase("runtime_coalescing", submissions=submissions,
          dispatches=dispatches, checks=len(got), kernel1_launches=launches,
          valid=sum(got), verdicts_equal_direct=True,
          seconds=round(held_s, 4), card=json.dumps(card))

    # 2. fair share: 64 B2 rounds queued (source mine) ahead of the
    # block's micro-batches (source block), held then released, and then
    # the same with the flood already on the card
    sweep = sweep_job(point_to_string(curve.keygen(rng=KEY_SEED)[1]))
    template = tsha.make_template(sweep.prefix)
    target = tsha.pack_target(tsha.target_spec(sweep.previous_hash,
                                               sweep.difficulty))
    round_ms = cuda_ms(lambda: tsha.pow_search(
        template, target, 0, SEARCH_BATCH, device=dev), reps=5, warm=1)
    micro = [block[i:i + MICROBATCH] for i in range(0, len(block),
                                                    MICROBATCH)]
    served = []

    def round_fn(k: int):
        def fn():
            served.append(k)
            return mine_engine._ReadBack(tsha.pow_search(
                template, target, k * SEARCH_BATCH, SEARCH_BATCH,
                device=dev))
        return fn

    for held in (True, False):
        txverify.clear_sig_verdicts()
        served.clear()
        truntime.reset_runtime()
        rt = truntime.get_runtime(dev)
        rt.arm()
        position = []
        t0 = time.perf_counter()
        with (rt.hold() if held else contextlib.nullcontext()):
            rounds = [rt.submit_call(round_fn(k), kernel="sha256_search",
                                     source="mine")
                      for k in range(FLOOD_ROUNDS)]
            tb = time.perf_counter()
            blocks = [rt.submit_sig_checks(m, source="block") for m in micro]
            blocks[0].add_done_callback(
                lambda _f: position.append(len(served)))
        verdicts = [v for f in blocks for v in f.result(timeout=300)]
        block_s = time.perf_counter() - tb
        until("the block's serve position", lambda: bool(position), 10.0)
        hits = [int(f.result(timeout=300)) for f in rounds]
        flood_s = time.perf_counter() - t0
        if not all(verdicts) or len(verdicts) != len(block):
            fail("runtime fair share: the block's verdicts are not all true")
        if any(h != SENTINEL for h in hits):
            fail(f"runtime fair share: the sweep template hit: {hits}")
        waits = rt.stats()["queue_waits"]
        block_wait, mine_wait = max(waits["block"]), max(waits["mine"])
        if held and (position[0] >= 12 or block_wait >= mine_wait / 4):
            fail(f"runtime fair share: the block served after "
                 f"{position[0]} rounds, waiting {block_wait:.4f} s "
                 f"against the flood's {mine_wait:.4f} s")
        phase("runtime_fair_share", held=held, mine_rounds=FLOOD_ROUNDS,
              block_micro_batches=len(micro), block_checks=len(block),
              rounds_issued_before_block=position[0],
              block_queue_wait_max_ms=round(block_wait * 1e3, 4),
              mine_queue_wait_max_ms=round(mine_wait * 1e3, 4),
              block_submit_to_verdicts_ms=round(block_s * 1e3, 3),
              flood_s=round(flood_s, 4), round_ms=round(round_ms, 4),
              dispatches=rt.dispatches, card=json.dumps(card))
        out["fair_held" if held else "fair_flood"] = {
            "wait_ms": block_wait * 1e3, "latency_ms": block_s * 1e3,
            "position": position[0]}
    out["round_ms"] = round_ms

    # 3. the runtime's own cost: a one-check batch through the runtime
    # against the same kernel work called directly, and the bare hops
    one = block[:1]
    good, bad = txverify._canary_checks()
    d1 = [one[0][0], good[0], bad[0]]
    s1 = [one[0][2], good[2], bad[2]]
    q1 = [one[0][3], good[3], bad[3]]

    def through():
        txverify.clear_sig_verdicts()
        if rt.submit_sig_checks(one, backend="device").result(60) != [True]:
            fail("runtime cost: the one-check batch was not valid")

    def direct():  # pass 1 with the canaries, then the bad canary's pass 2
        p256.verify_batch_prehashed(d1, s1, q1, device=dev)
        p256.verify_batch_prehashed([bad[1]], [bad[2]], [bad[3]],
                                    device=dev)

    cost = {"through_us": us_per_call(through, COST_CALLS),
            "direct_us": us_per_call(direct, COST_CALLS),
            "call_hop_us": us_per_call(
                lambda: rt.submit_call(lambda: None).result(60), COST_CALLS),
            "boxed_hop_us": us_per_call(
                lambda: rt.run_boxed(lambda: None, 60.0), COST_CALLS)}
    cost["runtime_us"] = cost["through_us"] - cost["direct_us"]
    phase("runtime_cost", calls=COST_CALLS,
          **{k: round(v, 2) for k, v in cost.items()},
          card=json.dumps(card))
    out["cost"] = cost

    # 4. a degrade round trip on the card: three injected device.verify
    # errors fail three groups (recorded and raised, never served on the
    # host), the fourth is blocked without a launch, and after the
    # cooldown one re-probe launches kernel 1 and restores ok
    groups = [block[1 + 64 * i:1 + 64 * (i + 1)] for i in range(5)]
    want = txverify.run_sig_checks(groups[4], backend="host", use_cache=False)
    degrade = txverify.DEGRADE
    degrade.reset()
    degrade.configure(3, 1.0)
    faultinject.install("device.verify:error:times=3", seed=12)
    trace.reset()
    p256.reset_counts()
    txverify.clear_sig_verdicts()
    states = []
    try:
        for i, g in enumerate(groups):
            if i == 4:
                time.sleep(1.1)  # the cooldown
            fut = rt.submit_sig_checks(g, backend="device", source="block")
            try:
                got, raised = fut.result(timeout=120), None
            except (faultinject.FaultInjected, DeviceBlocked) as e:
                got, raised = None, type(e).__name__
            if i == 4 and got != want:
                fail("degrade round trip: the re-probe's verdicts differ "
                     "from the native batch's")
            states.append((degrade.state, p256.LAUNCHES, raised))
    finally:
        faultinject.uninstall()
    counters = trace.counters()
    if [(s, r) for s, _, r in states] != [
            ("ok", "FaultInjected"), ("ok", "FaultInjected"),
            ("degraded", "FaultInjected"), ("degraded", "DeviceBlocked"),
            ("ok", None)] or states[3][1] != 0 or states[4][1] == 0:
        fail(f"degrade round trip: states, launches and errors {states}")
    if counters.get("resilience.device_fallback", 0) < 1 or \
            counters.get("resilience.device_recovered") != 1:
        fail(f"degrade round trip: counters {counters}")
    phase("runtime_degrade", faults="device.verify:error:times=3",
          failure_limit=3, cooldown_s=1.0,
          states=json.dumps([s for s, _, _ in states]),
          raised=json.dumps([r for _, _, r in states]),
          kernel1_launches=json.dumps([n for _, n, _ in states]),
          device_error=counters.get("resilience.device_error"),
          device_degraded=counters.get("resilience.device_degraded"),
          blocked=counters.get("resilience.device_fallback"),
          reprobe=counters.get("resilience.device_reprobe"),
          recovered=counters.get("resilience.device_recovered"),
          card=json.dumps(card))
    degrade.reset()
    degrade.configure(3, 60.0)

    # 5. native on the card's host: host figures, not the card's
    if native.load() is None:
        fail("the native library did not build on this machine")
    cpu_model = next((line.split(":", 1)[1].strip() for line in
                      Path("/proc/cpuinfo").read_text().splitlines()
                      if line.lower().startswith(("model name", "cpu model"))),
                     platform.processor() or platform.machine())
    tiled = (block * (8192 // len(block) + 1))[:8192]
    rates = {}
    for n in (8192, 1024):
        part = tiled[:n]
        t0 = time.perf_counter()
        got = native.p256_verify_batch([c[0] for c in part],
                                       [c[2] for c in part],
                                       [c[3] for c in part])
        rates[n] = n / (time.perf_counter() - t0)
        if not all(got):
            fail(f"native batch: {got.count(False)} of {n} honest checks "
                 "failed")
    t0 = time.perf_counter()
    oracle = [txverify._host_verify_digest(c[0], c[2], c[3])
              for c in tiled[:64]]
    oracle_rate = 64 / (time.perf_counter() - t0)
    if not all(oracle):
        fail("the pure-Python oracle failed an honest check")
    backend = miner.select_backend("cpu")
    job = mine_engine.MiningJob.from_header_fields(
        previous_hash=random.Random(3).randbytes(32).hex(),
        address=point_to_string(curve.keygen(rng=KEY_SEED)[1]),
        merkle_root=hashlib.sha256(b"native").hexdigest(),
        timestamp=1_760_000_000, difficulty="3")
    kw = dict(start=0, stride_end=1 << 17, batch=1 << 15)
    res = mine_engine.mine(job, backend, **kw)
    plain = mine_engine.mine(job, "torch", **kw)
    if backend != "native" or (res.nonce, res.hashes_tried) != (
            plain.nonce, plain.hashes_tried) or res.nonce is None:
        fail(f"the cpu miner ({backend}): {res} against the plain "
             f"search's {plain}")
    phase("runtime_native_host", host_cpu=json.dumps(cpu_model),
          host_threads=os.cpu_count(), openmp=native.OPENMP,
          sigs_per_s_8192=round(rates[8192], 1),
          sigs_per_s_1024=round(rates[1024], 1),
          oracle_sigs_per_s_64=round(oracle_rate, 1),
          cpu_miner=backend, cpu_miner_nonce=res.nonce,
          cpu_miner_hashes=res.hashes_tried, equal_to_plain_search=True,
          figures="host")
    out["native"] = {"8192": rates[8192], "1024": rates[1024],
                     "oracle": oracle_rate, "cpu": cpu_model}
    truntime.reset_runtime()
    return out


def swarm_line(swarm: dict, card: str) -> None:
    """The ``swarm`` line of :func:`swarm_path` and its entry points."""
    phase("swarm", walls="host", seed=SWARM_SEED,
          scenarios=len(swarm["host_walls"]),
          matrix_fp=swarm["host_fp"][:16], card_fp_equal=True,
          host_s=round(swarm["host_s"], 3), card_s=round(swarm["card_s"], 3),
          host_walls_s=json.dumps(swarm["host_walls"], sort_keys=True),
          card_walls_s=json.dumps(swarm["card_walls"], sort_keys=True),
          card_launches=json.dumps(
              {k: v["launches"] for k, v in swarm["per_scenario"].items()},
              sort_keys=True),
          matrix_launches=json.dumps(swarm["matrix"]),
          geo_soak_recorder=json.dumps(
              swarm["card_recorders"]["geo_soak"]),
          card_recorders=json.dumps(swarm["card_recorders"], sort_keys=True),
          host_recorders=json.dumps(swarm["host_recorders"], sort_keys=True),
          wide_nodes=SWARM_WIDE[0], wide_seed=SWARM_WIDE[1],
          wide_fp=swarm["wide_fp"][:16],
          wide_host_s=round(swarm["wide_host_s"], 3),
          wide_card_s=round(swarm["wide_card_s"], 3),
          wide_launches=json.dumps(swarm["wide"]["launches"]),
          wide_utxo_equal=True,
          wide_probe_vs_plain=json.dumps(
              max(c["max_abs_err"] for c in swarm["wide"]["probe_checks"])),
          path_launches=json.dumps(swarm["all"]),
          entry_points_s=json.dumps(swarm["entry_s"]),
          sample_mismatch=0, host_txid_retry=0, card=json.dumps(card))


def swarm_only(dev: torch.device) -> None:
    """``--only swarm_path``: phase 32 and the three entry points."""
    fresh_runtime(dev, "the build")
    swarm = swarm_path(dev)
    fresh_runtime(dev, "swarm_path")
    swarm["entry_s"] = swarm_entry_points(swarm["host_fp"])
    degrade_clean("the swarm's entry points")
    swarm_line(swarm, tdevice.card_line())


def runtime_only(dev: torch.device) -> None:
    """``--only runtime_path``: the phase on a block of 8,160 one-input
    txs signed over synthetic outpoints (no chain is built)."""
    kit = Kit(curve.keygen(rng=KEY_SEED))
    rng = random.Random(0xB10C)
    txs = [kit.spend([(rng.randbytes(32).hex(), 0)],
                     [TxOutput(kit.addr, 1 + i)]) for i in range(FAN * PER)]
    runtime_path(dev, leaf_checks(txs, kit.pub), signature_mix(LANES),
                 tdevice.card_line())
    degrade_clean("runtime_path")


# the kernel phases that need no chain, by the name ``--only`` takes
KERNEL_PHASES = {"utxo_probe": probe_phase,
                 "jac_windows": lambda dev: windows_phase(
                     dev, signature_mix(LANES)),
                 "txid_ragged": txid_ragged_phase,
                 "runtime_path": runtime_only,
                 "swarm_path": swarm_only}


def main() -> int:
    if sys.argv[1:2] == ["--sass"]:
        # each kernel function of the built libraries named, by its SASS
        for lib in sys.argv[2:]:
            for fn, (count, digest) in sass_functions(lib).items():
                print(f"{lib} {fn}: instructions={count} sha256={digest}")
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # the nodes of this process log warnings only, as before they had a
    # logger; the node processes log to their <db>.log
    setup_logging(LogConfig(path="", console=False))
    card = tdevice.card_line()
    if not card:
        fail("nvidia-smi did not report the card")
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    phase("card", name=json.dumps(name), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    built = _build.build_all(KERNELS, force=True)
    phase("build", seconds=round(time.perf_counter() - t0, 1),
          **{k: round(v, 1) for k, v in built.items()})
    for k in KERNELS:
        for line in _build.ptxas_report(k).splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                print(f"  ptxas {k}: {line.strip()}", flush=True)
    for k, inside in (("sha256_search", ""), ("sha256_blocks", ""),
                      ("utxo_probe", ""),
                      ("p256_verify", "WARPSYNC"),
                      ("p256_verify_wide", "WARPSYNC"),
                      ("p256_complete", "WARPSYNC")):
        total, loop = sass_counts(k, inside)
        print(f"  sass {k}: instructions={total or 'not_measured'} "
              f"loop={sum(loop.values())} "
              + " ".join(f"{op}={n}" for op, n in loop.most_common(12)),
              flush=True)
    for k in ("p256_verify", "p256_verify_wide"):
        for fn, (count, digest) in sass_functions(
                str(_build.library_path(k))).items():
            print(f"  sass_function {k} {fn}: instructions={count} "
                  f"sha256={digest}", flush=True)

    if sys.argv[1:2] == ["--only"]:
        # a partial run: the card, the build and the named kernel phases
        for name in sys.argv[2].split(","):
            KERNEL_PHASES[name](dev)
        print("chip_smoke: partial run; no result", flush=True)
        return 0
    # every device dispatch of the paths below goes through the device
    # runtime; each path gets a fresh one, armed before its counts reset,
    # and the degrade must have recorded no failure after any of them
    runtime_arm_line(fresh_runtime(dev, "the build"), card)
    mix = signature_mix(LANES)
    record = kernel_phase(dev, mix)
    window_records = windows_phase(dev, mix)
    complete_record = complete_phase(dev, mix)
    key = curve.keygen(rng=KEY_SEED)
    sha_record = sha_phase(dev, point_to_string(key[1]))
    probe_record = probe_phase(dev)
    txid_ragged_phase(dev)

    kit = Kit(key)
    clock.freeze(int(time.time()) - 3600)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        fresh_runtime(dev, "the kernel phases")
        leaves, content, setup_s = asyncio.run(build_chain(
            dev, kit, str(workdir / "base.db")))
        fresh_runtime(dev, "build_chain")
        res = asyncio.run(accept_path(dev, kit, str(workdir / "base.db"),
                                      leaves, content))
        fresh_runtime(dev, "accept_path")
        resident = asyncio.run(accept_resident_path(
            dev, kit, str(workdir / "base.db"), leaves, content))
        res_windows, last = {}, "accept_resident"
        for w in OTHER_WINDOWS:
            fresh_runtime(dev, last)
            res_windows[w] = accept_window(
                dev, kit, str(workdir / "base.db"), leaves, content,
                res["utxo_hash"], w)
            last = f"main_path_w{w}"
        fresh_runtime(dev, last)
        node_w13 = node_window_path(workdir, leaves, content,
                                    res["utxo_hash"])
        fresh_runtime(dev, "node_push_block_w13")
        mverify = mesh_verify_phase(dev, kit, str(workdir / "base.db"),
                                    leaves, content, res["utxo_hash"], mix)
        fresh_runtime(dev, "mesh_verify")
        msearch = mesh_search_phase(dev, kit, workdir)
        fresh_runtime(dev, "mesh_search")
        nres = node_path(dev, kit, workdir, leaves)
        fresh_runtime(dev, "node_path")
        wal = wallet_path(dev, kit, workdir)
        pushes, last = {}, "wallet_path"
        for k in ("complete", "jac"):
            fresh_runtime(dev, last)
            pushes[k] = push_block_path(dev, kit, workdir, leaves, content, k)
            last = "push_block " + k
        fresh_runtime(dev, last)
        pushed_resident = push_block_resident_path(dev, kit, workdir, leaves,
                                                   content)
        fresh_runtime(dev, "push_block_resident")
        snap = snapshot_path(dev, kit, workdir, leaves)
        fresh_runtime(dev, "snapshot")
        arch = archive_path(dev, kit, workdir, leaves)
        fresh_runtime(dev, "archive")
        pg = pg_path(dev, kit, workdir, leaves, content)
        fresh_runtime(dev, "pg_path")
        txid_record = txid_phase(dev, {
            "micro_batch": micro_batch_payloads(leaves),
            "sync_page": page_payloads(str(workdir / "push_jac.db")),
            "edges": [random.Random(e).randbytes(e) for e in TXID_EDGES]})
        txid_crossover(dev, micro_batch_payloads(leaves, len(leaves)))
        # the server: the chain with the 8,160-tx block, as the jac
        # push_block left it
        fresh_runtime(dev, "the txid phases")
        server = NodeThread(dev, str(workdir / "push_jac.db"), "jac")
        try:
            synced = sync_path(dev, workdir, server)
            reorged = reorg_path(dev, kit, workdir, server)
        finally:
            server.close()
        fresh_runtime(dev, "sync and reorg")
        gossiped = gossip_path(dev, kit, workdir, leaves, content)
        degrade_clean("gossip_path")
        shared = shared_card_path(dev, workdir, leaves, content, card)
        fresh_runtime(dev, "shared_card")
        traced = tracing_cost_path(dev, workdir, leaves, content)
        degrade_clean("tracing_cost")
        runtime = runtime_path(dev, leaf_checks(leaves, kit.pub), mix, card)
        fresh_runtime(dev, "runtime_path")
        swarm = swarm_path(dev)
        fresh_runtime(dev, "swarm_path")
        swarm["entry_s"] = swarm_entry_points(swarm["host_fp"])
        degrade_clean("the swarm's entry points")
    clock.reset()
    txid_record["launches"] = synced["b5"]
    for rec in window_records:
        rec["launches"] = res_windows[rec["window"]]["by_window"][
            rec["window"]]
    probe_record["launches"] = resident["b6"]
    record["launches"] = res["launches"]
    # the paths' own counts beside each record's: the HTTP push_block to
    # the node on the PostgreSQL backend runs B6, kernel 1 and B5
    probe_record["launches_by_path"] = {"accept_resident": resident["b6"],
                                        "pg_push_block": pg["b6"],
                                        "snapshot_restored_block": snap["b6"],
                                        "archive": arch["all"]["b6"],
                                        "swarm": swarm["all"]["b6"]}
    record["launches_by_path"] = {"main_path": res["launches"],
                                  "pg_push_block": pg["jac"],
                                  "wallet_sends": wal["jac"],
                                  "snapshot_restored_block": snap["jac"],
                                  "archive": arch["all"]["jac"],
                                  "swarm": swarm["all"]["jac"]}
    txid_record["launches_by_path"] = {"sync_path": synced["b5"],
                                       "pg_push_block": pg["b5"],
                                       "snapshot_restored_block": snap["b5"],
                                       "archive": arch["all"]["b5"],
                                       "swarm": swarm["all"]["b5"]}
    sha_record["launches"] = nres["miner"]["launches"]
    sha_record["launches_by_path"] = {"miner_run": nres["miner"]["launches"],
                                      "wallet_block": wal["b2"],
                                      "archive": arch["all"]["b2"]}
    # one path's own count (the 8,160-tx push_block under complete), and
    # each path's count beside it: the paths are reset and read apart
    complete_record["launches"] = pushes["complete"]["complete"]
    complete_record["launches_by_path"] = {
        "node_burst": nres["complete"],
        "miner_run": nres["miner"]["complete"],
        "node_push_block_complete": pushes["complete"]["complete"],
        "swarm": swarm["all"]["complete"]}
    blocks = kit.mined
    phase("chain_mining", blocks=len(blocks), difficulty=res["difficulty"],
          start_difficulty=START_DIFFICULTY,
          hashes=sum(b.hashes_tried for b in blocks),
          seconds=round(sum(b.elapsed for b in blocks), 3))
    phase("main_path", txs=res["txs"], accept_s=round(res["accept_s"], 3),
          tx_per_s=round(res["txs"] / res["accept_s"], 1),
          launches=res["launches"], exception_lanes=res["exception_lanes"],
          txid_launches=res["txid_launches"],
          chain_setup_s=round(setup_s, 1),
          rejected=json.dumps(res["rejected"]), card=json.dumps(card))
    phase("accept_breakdown", **res["breakdown"])
    device_phase("device_profile", res["device"], res["accept_s"])
    for w, out in res_windows.items():
        phase("main_path_windows", txs=out["txs"], verify_window=w,
              accept_s=round(out["accept_s"], 3),
              tx_per_s=round(out["txs"] / out["accept_s"], 1),
              launches=out["by_window"][w],
              other_windows=sum(v for k, v in out["by_window"].items()
                                if k != w),
              exception_lanes=out["exception_lanes"],
              same_utxo_hash_as_w4=True, card=json.dumps(card))
        device_phase(f"device_profile_w{w}", out["device"], out["accept_s"])
    phase("node_push_block_w13", txs=len(leaves), verify_window=13,
          ready_s=round(node_w13["ready_s"], 3),
          wall_s=round(node_w13["wall_s"], 3),
          tx_per_s=round(len(leaves) / node_w13["wall_s"], 1),
          block_accept_s=round(node_w13["accept_s"], 3),
          w13_launches=node_w13["launches"],
          warm_launches_w13=node_w13["warm"],
          jac_batches=node_w13["batches"],
          arm_s=node_w13["arm"].get("probe_seconds"),
          warmed=json.dumps(node_w13["arm"].get("warmed")),
          same_utxo_hash_as_w4=True, card=json.dumps(card))
    phase("node_burst", verify_kernel="complete", push_tx=nres["burst"],
          accepted=nres["burst"], seconds=round(nres["burst_s"], 3),
          tx_per_s=round(nres["burst"] / nres["burst_s"], 1),
          complete_launches=nres["complete"], jac_launches=nres["jac"],
          intake_batches=sum(nres["batches"].values()),
          batch_sizes=json.dumps(sorted(nres["batches"].items())),
          rejected=json.dumps(nres["rejected"]))
    mined = nres["miner"]
    phase("miner_run", node="port", accepted=True, tip=mined["tip"],
          txs=mined["txs"], pending=json.dumps(mined["pending"]),
          difficulty=mined["difficulty"], launches=mined["launches"],
          complete_launches=mined["complete"],
          txid_launches=mined["txid_launches"],
          seconds=round(mined["run_s"], 3))
    phase("wallet_path", walls="host", sends=WALLET_SENDS,
          amount=WALLET_AMOUNT, sends_s=round(wal["sends_s"], 3),
          s_a_send=round(wal["sends_s"] / WALLET_SENDS, 4),
          cli_send_s=round(wal["cli_s"], 3),
          nodeless_send_s=round(wal["nodeless_s"], 3), pool=wal["pool"],
          intake_batches=wal["intake_batches"], jac_launches=wal["jac"],
          host_batches=wal["host_batches"], mined_height=wal["height"],
          block_txs=wal["block_txs"], miner_s=round(wal["miner_s"], 3),
          b2_launches=wal["b2"], recipient_balance=wal["balance"],
          card=json.dumps(card))
    for kernel, out in pushes.items():
        busy = out["device"].get("busy_s")
        phase(f"node_push_block_{kernel}", txs=len(leaves),
              body_bytes=out["bytes"], wall_s=round(out["wall_s"], 3),
              tx_per_s=round(len(leaves) / out["wall_s"], 1),
              complete_launches=out["complete"], jac_launches=out["jac"],
              exception_lanes=out["exception_lanes"],
              txid_launches=out["txid_launches"],
              busy_s="not_measured" if busy is None else round(busy, 4),
              idle_share="not_measured" if busy is None
              else round(1 - busy / out["wall_s"], 4),
              rejected=json.dumps(out.get("rejected")), card=json.dumps(card))

    phase("sync_path", blocks=synced["blocks"], txs=synced["txs"],
          wall_s=round(synced["wall_s"], 3),
          tx_per_s=round(synced["txs"] / synced["wall_s"], 1),
          txid_launches=synced["b5"], jac_launches=synced["jac"],
          page_txid_batches=synced["pages"]["sync.page_txids"],
          page_sig_verifies=synced["pages"]["sync.page_sig_prefill"],
          sample_mismatch=synced["counters"]["txid.sample_mismatch"],
          host_txid_retry=synced["counters"]["sync.host_txid_retry"],
          tip=synced["tip"][:16], card=json.dumps(card))
    device_phase("sync_device_profile", synced["device"], synced["wall_s"])
    phase("reorg_path", fork_block=reorged["fork_id"],
          removed_from=json.dumps(reorged["removed"]),
          wall_s=round(reorged["wall_s"], 3),
          txid_launches=reorged["b5"], jac_launches=reorged["jac"],
          txid_backend="auto", tip=reorged["tip"][:16],
          card=json.dumps(card))

    g = gossiped
    phase("gossip_path", rate_limits=g["rate_limits"],
          b_start_s=round(g["b_start_s"], 3),
          c_start_s=round(g["c_start_s"], 3),
          hop_s=round(g["hop_s"], 3),
          b_accept_s=round(g["b_block"]["block_accept"], 3),
          b_jac_batches=g["b_block"]["p256_verify"],
          b_txid_batches=g["b_block"]["sha256_txid"],
          a_jac_launches=g["a_jac"], burst=GOSSIP_BURST,
          burst_push_s=round(g["burst_push_s"], 3),
          burst_hop_s=round(g["burst_hop_s"], 3),
          b_burst_jac_batches=g["b_burst"]["p256_verify"]
          - g["b_block"]["p256_verify"],
          dead_breaker=json.dumps(g["breakers"]["peers"][g["dead"]]),
          state_counts=json.dumps(g["breakers"]["state_counts"]),
          propagate_timeouts=g["propagate_timeouts"],
          c_bootstrap_to_tip_s=round(g["c_bootstrap_s"], 3),
          c_jac_batches=g["c"]["p256_verify"],
          c_txid_batches=g["c"]["sha256_txid"],
          c_page_txids_s=round(g["c"]["sync.page_txids"], 4),
          c_page_sig_prefill_s=round(g["c"]["sync.page_sig_prefill"], 4),
          sample_mismatch=0, host_txid_retry=0, tip=g["tip"][:16],
          card=json.dumps(card))
    tel = g["telemetry"]
    phase("telemetry_path", trace_id=tel["trace_id"],
          a_client_s=round(tel["client_s"], 3),
          a_root_s=round(tel["a_tree"]["root_ms"] / 1e3, 3),
          b_root_s=round(tel["b_tree"]["root_ms"] / 1e3, 3),
          hop_s=round(tel["hop_s"], 3), launches=tel["launches"],
          lanes=tel["lanes"], a_lanes_real=tel["a_lanes_real"],
          b_lanes_real=tel["b_lanes_real"],
          a_runtime_dispatches=tel["a_runtime_dispatches"],
          a_runtime_count=tel["a_runtime_count"],
          b_runtime_dispatches=tel["b_runtime_dispatches"],
          b_kernel1_launches=tel["b_launches"],
          b_profile_kernel1=tel["b_profile_kernels"][0],
          b_profile_lanes=f"{tel['b_profile_kernels'][1]}-"
          f"{tel['b_profile_kernels'][2]}",
          b_profile_s=tel["b_profile_s"],
          b_profile_bytes=tel["b_profile_bytes"],
          b_card_memory=json.dumps({k[len("upow_device_gpu_0_"):]: int(v)
                                    for k, v in tel["memory"].items()}),
          cpu_node_memory_gauges=0, scrapes_valid=True,
          card=json.dumps(card))
    phase("surfaces", node_burst_tx_frames=nres["ws"]["tx_frames"],
          node_burst_s_subscribed=round(nres["burst_s"], 3),
          node_block_frames=nres["ws"]["block_frames"],
          node_dropped=nres["ws"]["dropped"],
          a_block_frames=g["ws"]["block_frames"],
          a_burst_tx_frames=g["ws"]["tx_frames"],
          a_burst_push_s_subscribed=round(g["burst_push_s"], 3),
          a_dropped=g["ws"]["dropped"],
          cache_hits=g["cache"]["hits"], cache_misses=g["cache"]["misses"],
          cache_generation=json.dumps(g["cache"]["generation"]),
          alert_evaluations=g["alerts"]["evaluations"],
          alert_eval_lag_seconds=g["alerts"]["eval_lag_seconds"],
          alert_pending=json.dumps(g["alerts"]["pending"]), alert_firing=0,
          probe_errors=g["alerts"]["probe_errors"], card=json.dumps(card))
    for where, tree in (("a_push_block", tel["a_tree"]),
                        ("b_gossiped_push_block", tel["b_tree"]),
                        ("shared_push_block", shared["trees"]["push"]),
                        ("shared_sync", shared["trees"]["sync"])):
        phase("trace_split", node=where, root_ms=tree["root_ms"],
              spans=json.dumps(tree["spans"], sort_keys=True),
              card=json.dumps(card))
    burst_on, burst_off = ([w[0] for w in traced[k]] for k in (True, False))
    push_on, push_off = ([w[1] for w in traced[k]] for k in (True, False))
    phase("tracing_cost", turns=len(burst_on) + len(burst_off),
          order="on,off,off,on", burst=BURST,
          burst_on_s=json.dumps([round(x, 3) for x in burst_on]),
          burst_off_s=json.dumps([round(x, 3) for x in burst_off]),
          push_block_on_s=json.dumps([round(x, 3) for x in push_on]),
          push_block_off_s=json.dumps([round(x, 3) for x in push_off]),
          burst_median_on_off=f"{round(statistics.median(burst_on), 3)}/"
          f"{round(statistics.median(burst_off), 3)}",
          push_block_median_on_off=f"{round(statistics.median(push_on), 3)}/"
          f"{round(statistics.median(push_off), 3)}",
          card=json.dumps(card))

    stats = resident["stats"]
    phase("accept_resident", txs=resident["txs"],
          entries=stats["entries"], capacity=stats["capacity"],
          resident_mb=round(stats["resident_bytes"] / 1e6, 1),
          setup_s=round(resident["setup_s"], 3),
          arm_s=round(resident["arm_s"], 3),
          upload_ms=round(resident["upload_s"] * 1e3, 3),
          upload_after_block_ms="not_measured"
          if resident["upload_after_block_s"] is None
          else round(resident["upload_after_block_s"] * 1e3, 3),
          accept_s=round(resident["accept_s"], 3),
          tx_per_s=round(resident["txs"] / resident["accept_s"], 1),
          accept_probe_s=round(resident["accept_probe_s"], 4),
          sql_scan_accept_s=round(resident["sql_accept_s"], 3),
          probe_launches=resident["b6"], jac_launches=resident["jac"],
          txid_launches=resident["b5"], index_probes=resident["probes"],
          probe_outpoints=resident["probe_outpoints"],
          shadow_consults=resident["shadow_consults"],
          parity_sample=resident["sample"], parity="accept,reorg,reaccept",
          probe_vs_plain=json.dumps(resident["probe_checks"]),
          card=json.dumps(card))
    device_phase("accept_resident_device_profile", resident["device"],
                 resident["accept_s"])
    phase("node_push_block_resident", txs=len(leaves),
          wall_s=round(pushed_resident["wall_s"], 3),
          tx_per_s=round(len(leaves) / pushed_resident["wall_s"], 1),
          probe_launches=pushed_resident["b6"],
          jac_launches=pushed_resident["jac"],
          txid_launches=pushed_resident["b5"],
          shadow_consults=pushed_resident["consults"],
          sample_mismatch=pushed_resident["counters"]["txid.sample_mismatch"],
          host_txid_retry=pushed_resident["counters"]["sync.host_txid_retry"],
          rejected=json.dumps(pushed_resident["rejected"]),
          card=json.dumps(card))
    phase("snapshot", walls="host", chunk_bytes=SNAPSHOT_CHUNK,
          build_s=round(snap["build_s"], 3), chunks=snap["chunks"],
          payload_bytes=snap["bytes"], restore_s=round(snap["restore_s"], 3),
          rearm_s=round(snap["rearm_s"], 4),
          method="snapshot", fingerprints_equal=True,
          probe_vs_plain=json.dumps([snap["probe_check"],
                                     snap["probe_check_after"]]),
          rejected=json.dumps(REJECTED), honest_txs=HONEST,
          honest_push_s=round(snap["push_s"], 3),
          probe_launches=snap["b6"], jac_launches=snap["jac"],
          txid_launches=snap["b5"], shadow_consults=snap["consults"],
          card=json.dumps(card))
    st = arch["stats"]
    phase("archive", walls="host", segment_blocks=ARCHIVE_SEGMENT,
          safety_window=ARCHIVE_WINDOW, height=arch["height"],
          difficulty=arch["difficulty"], spend_txs=arch["spend_txs"],
          extension_s=round(arch["extension_s"], 3),
          snapshot_s=round(arch["snapshot_s"], 3),
          compact_s=round(arch["compact_s"], 3),
          archived_through=st["archived_through"],
          pruned_blocks=st["pruned_blocks"], pruned_txs=st["pruned_txs"],
          hot_rows=f"{json.dumps(arch['hot_before'])}->"
          f"{json.dumps(arch['hot_after'])}",
          segment_bytes=arch["segment_bytes"],
          segment_json_bytes=arch["segment_json_bytes"],
          segment_txs=arch["segment_txs"], reads_twin_equal=True,
          reads_s=round(arch["reads_s"], 3),
          fallthrough_reads=arch["fallthrough_reads"],
          probe_vs_plain=json.dumps([arch["probe_check"],
                                     arch["probe_check_after"]]),
          honest_txs=arch["honest_txs"],
          honest_push_s=round(arch["honest_push_s"], 3),
          honest_launches=json.dumps(arch["honest"]),
          extension_launches=json.dumps(arch["extension"]),
          j_sync_s=round(arch["sync_s"], 3), j_blocks=arch["sync_blocks"],
          j_sync_launches=json.dumps(arch["sync"]),
          sample_mismatch=arch["sync_counters"]["txid.sample_mismatch"],
          host_txid_retry=arch["sync_counters"]["sync.host_txid_retry"],
          m_mirror_s=round(arch["mirror_s"], 3), m_files_equal=True,
          path_launches=json.dumps(arch["all"]), card=json.dumps(card))
    phase("pg", backend="PgChainState over MockPgDriver (sqlite)",
          txid_backend="device",
          walls="host, mock driver over sqlite, not a PostgreSQL server",
          txs=len(leaves), load_s=round(pg["load_s"], 3),
          arm_s=round(pg["arm_s"], 3), admitted=PG_ADMIT,
          admit_s=round(pg["admit_s"], 3), push_wall_s=round(pg["push_s"], 3),
          tx_per_s=round(len(leaves) / pg["push_s"], 1),
          probe_launches=pg["b6"], jac_launches=pg["jac"],
          txid_launches=pg["b5"], shadow_consults=pg["consults"],
          sample_mismatch=pg["counters"]["txid.sample_mismatch"],
          host_txid_retry=pg["counters"]["sync.host_txid_retry"],
          hashes_equal_sqlite_resident=pg["hashes_equal"],
          rejected=json.dumps(REJECTED), parity="accept,replay,reorg",
          probe_vs_plain=json.dumps(pg["probe_checks"]),
          replay_equal=pg["replay_equal"], replay_s=round(pg["replay_s"], 3),
          remove_blocks_s=round(pg["remove_s"], 3),
          reindex_check_rc=pg["reindex_rc"],
          reindex_s=round(pg["reindex_s"], 3), card=json.dumps(card))

    swarm_line(swarm, card)

    rate = hashrate_phase(key)
    phase("hashrate", hashes=rate["tried"], seconds=round(rate["seconds"], 4),
          mh_s=round(rate["tried"] / rate["seconds"] / 1e6, 1),
          launches=rate["launches"], hit=rate["hit"], card=json.dumps(card),
          torch=torch.__version__, cuda=torch.version.cuda)
    phase("hashrate_turns", profiled_runtime_gh_s=round(
        rate["tried"] / rate["seconds"] / 1e9, 4),
          turns_gh_s=json.dumps(rate["turns"]), card=json.dumps(card))
    device_phase("hashrate_device_profile", rate["device"], rate["seconds"])
    phase("difficulty_6_3", nonce=rate["nonce_6_3"], hashlib_checked=True,
          hashes=rate["tried_6_3"], seconds=round(rate["seconds_6_3"], 4))
    fresh_runtime(dev, "hashrate")
    multihost_phase(point_to_string(key[1]))
    degrade_clean("multihost")
    walls = {"accept_s": res["accept_s"], "node_burst_s": nres["burst_s"],
             "push_block_jac_s": pushes["jac"]["wall_s"],
             "sync_s": synced["wall_s"], "gossip_hop_s": g["hop_s"]}
    phase("walls_vs_before_runtime",
          **{k: f"{round(v, 3)}/{BEFORE_RUNTIME[k]}"
             for k, v in walls.items()},
          accept_resident_s=round(resident["accept_s"], 3),
          sweep_gh_s=round(rate["tried"] / rate["seconds"] / 1e9, 4),
          runtime_us_a_dispatch=round(runtime["cost"]["runtime_us"], 2),
          push_block_swept_s=round(shared["swept"]["push_s"], 3),
          sync_swept_s=round(shared["swept"]["sync_s"], 3),
          card=json.dumps(card))

    # kernels 3 and 4 of the TPU package are one CUDA kernel: one record
    # for each TPU kernel it replaces, with the same measurements
    stacked_record = dict(complete_record,
                          replaces="upow_tpu/crypto/p256.py:468",
                          same_kernel_as="upow_tpu/crypto/p256.py:548")
    # the mesh programs (ROADMAP B8): each shard one launch of B1 or B2;
    # their bounds are the unsharded kernel's for the same work.  The
    # JAX package's two mesh searches (:74 fixed target, :101 resident)
    # are one wrapper here, so one measurement serves both records
    verify_sharded_record = {
        "name": "p256_verify_sharded", "route": "cuda",
        "source": "upow_tpu_torch/csrc/p256_verify.cu",
        "replaces": "upow_tpu/crypto/p256.py:1289",
        "launches": mverify["launches"],
        "max_abs_err": mverify["max_abs_err"], "ms": mverify["ms"],
        "plain_ms": record["plain_ms"], "bound_ms": record["bound_ms"],
        "bound_by": record["bound_by"], "library_ms": None}
    search_mesh_record = {
        "name": "sha256_search_mesh", "route": "cuda",
        "source": "upow_tpu_torch/csrc/sha256_search.cu",
        "replaces": "upow_tpu/parallel/mesh.py:101",
        "launches": msearch["launches"],
        "max_abs_err": msearch["max_abs_err"], "ms": msearch["ms"],
        "plain_ms": msearch["plain_ms"], "bound_ms": sha_record["bound_ms"],
        "bound_by": sha_record["bound_by"], "library_ms": None,
        "one_launch_ms": msearch["one_launch_ms"]}
    search_sharded_record = dict(
        search_mesh_record, name="sha256_search_sharded",
        replaces="upow_tpu/parallel/mesh.py:74",
        same_kernel_as="upow_tpu/parallel/mesh.py:101")
    print(json.dumps({"kernels": [
        record, *window_records, complete_record,
        stacked_record, sha_record,
        txid_record, probe_record, verify_sharded_record, search_mesh_record,
        search_sharded_record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
