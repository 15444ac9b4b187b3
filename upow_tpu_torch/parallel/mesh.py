"""Device-mesh scale-out of the two hot kernels: the counterpart of the
JAX package's ``parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` and runs one SPMD program
over it (``shard_map``), with a ``pmin`` collective for the search's
hit.  Here a mesh is a tuple of ``torch.device``s and a shard is one
launch of an existing kernel on its device (the two device programs of
ROADMAP B8):

* **Nonce search** (B8b, the JAX ``_pow_search_mesh_resident`` and
  ``_pow_search_mesh``): shard i launches kernel B2
  (``csrc/sha256_search.cu`` through ``crypto.sha256.pow_search``, which
  takes its target at run time and masks lanes past its count) over
  ``[bases[i], min(limits[i], bases[i] + batch_per_device))``.  An empty
  shard launches nothing; lanes that would wrap past 2^32 drop out, as
  the JAX mask drops them.  The ``pmin`` is one ``min`` over the shards'
  hits on the first device, which the caller reads once.
* **Batch signature verify** (B8a, the JAX
  ``_prep_and_verify_pallas_jac_sharded``): the packed (42, N) lanes are
  split into contiguous shards, one a device; each runs the Jacobian
  kernel (B1, or B7 at w = 5) and the verdicts come back in lane order.
  There is no power-of-two padding (ROADMAP §C): the JAX package pads to
  128 x n_dev; verdicts and exception bits are the same.

A mesh may name a device more than once: the tests hold the sharded
paths with eight shards on the CPU (the plain versions), chip_smoke.py
with four on one card.  Across processes, ``parallel.multihost`` plans
each process's nonce range first.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..crypto import p256, sha256 as tsha
from ..device import DeviceLike, resolve

NONCE_SPACE = 1 << 32
Mesh = Tuple[torch.device, ...]

# Plain integers, read by chip_smoke.py: the kernel launches the two
# sharded wrappers made (each is also a launch of its kernel, counted in
# crypto.sha256.LAUNCHES or crypto.p256.LAUNCHES).
SEARCH_LAUNCHES = 0
VERIFY_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def reset_counts() -> None:
    global SEARCH_LAUNCHES, VERIFY_LAUNCHES
    with _COUNT_LOCK:
        SEARCH_LAUNCHES = 0
        VERIFY_LAUNCHES = 0


def visible_cards() -> List[torch.device]:
    """Every card PyTorch sees; raises without one."""
    resolve("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def plan_devices(mesh_devices: int, device: DeviceLike = None
                 ) -> List[torch.device]:
    """The devices of a mesh of ``mesh_devices`` (config
    ``device.mesh_devices``).  On the cards (``device`` None or cuda):
    every visible card for 0, else the first N (at most all, as in the
    JAX package).  With ``device="cpu"``: N shards on the host (one for
    0), the plain versions, which is how the tests hold a mesh against
    the JAX package's 8-device CPU mesh."""
    if mesh_devices < 0:
        raise ValueError(f"mesh_devices must be >= 0, not {mesh_devices}")
    if resolve(device).type == "cpu":
        return [torch.device("cpu")] * max(1, mesh_devices)
    cards = visible_cards()
    return cards if mesh_devices == 0 else cards[:mesh_devices]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh: the given devices in order (a device may repeat), by
    default every visible card.  Raises without a device."""
    if devices is None:
        devices = visible_cards()
    mesh = []
    for d in devices:
        d = resolve(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise RuntimeError("a mesh needs at least one device")
    return tuple(mesh)


def shard_bounds(total_lo: int, total_hi: int, index: int, count: int
                 ) -> Tuple[int, int]:
    """Disjoint [lo, hi) range of shard ``index`` of ``count``: contiguous
    blocks, the JAX package's split."""
    span = total_hi - total_lo
    return (total_lo + span * index // count,
            total_lo + span * (index + 1) // count)


def pow_search_resident(midstate, tail_words, bases, limits, target,
                        batch_per_device: int, nonce_spec,
                        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Search each shard's range for the least nonce that meets
    ``target`` (the 7-word ``crypto.sha256.pack_target`` vector): shard i
    covers ``[bases[i], min(limits[i], bases[i] + batch_per_device))``.
    Returns the least hit over the shards (or SENTINEL) as a 0-d int64
    tensor on the mesh's first device; ``int()`` of it is the one host
    read.  The launches are queued and not waited for."""
    global SEARCH_LAUNCHES
    mesh = mesh or make_mesh()
    if len(bases) != len(mesh) or len(limits) != len(mesh):
        raise ValueError(f"{len(bases)} bases and {len(limits)} limits "
                         f"for a mesh of {len(mesh)}")
    template = tsha.SearchTemplate(
        np.asarray(midstate, dtype=np.uint32),
        np.asarray(tail_words, dtype=np.uint32),
        tuple((int(w), int(s)) for w, s in nonce_spec))
    hits, launched = [], 0
    for dev, base, limit in zip(mesh, bases, limits):
        base, limit = int(base), int(limit)
        end = min(limit, base + batch_per_device, NONCE_SPACE)
        if end <= base:
            continue  # an empty shard launches nothing
        hits.append(tsha.pow_search(template, target, base, end - base,
                                    device=dev))
        launched += dev.type == "cuda"
    with _COUNT_LOCK:
        SEARCH_LAUNCHES += launched
    if not hits:
        return torch.full((), int(tsha.SENTINEL), dtype=torch.int64,
                          device=mesh[0])
    return torch.stack([h.to(mesh[0]) for h in hits]).min()


def pow_search_sharded(template: tsha.SearchTemplate, target, nonce_base: int,
                       batch_per_device: int,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Search ``len(mesh) * batch_per_device`` nonces from ``nonce_base``,
    one contiguous block a device; the least hit or SENTINEL (a 0-d
    tensor on the first device).  The range must stay inside the 32-bit
    nonce space (the JAX program would wrap its last lanes round)."""
    mesh = mesh or make_mesh()
    end = nonce_base + len(mesh) * batch_per_device
    if nonce_base < 0 or batch_per_device < 0 or end > NONCE_SPACE:
        raise ValueError(f"nonce range [{nonce_base}, {end}) leaves the "
                         "32-bit nonce space")
    bases = [nonce_base + i * batch_per_device for i in range(len(mesh))]
    return pow_search_resident(
        template.midstate, template.tail_words, bases,
        [b + batch_per_device for b in bases], target, batch_per_device,
        template.nonce_spec, mesh)


def shard_batch_arrays(mesh: Mesh, *arrays: torch.Tensor) -> tuple:
    """For each array, its contiguous shards along the last (lane) axis,
    shard i copied to ``mesh[i]``: a list per array."""
    out = []
    for a in arrays:
        n = a.shape[-1]
        out.append([
            a[..., lo:hi].contiguous().to(dev)
            for i, dev in enumerate(mesh)
            for lo, hi in [shard_bounds(0, n, i, len(mesh))]])
    return tuple(out)


def verify_packed_sharded(packed: torch.Tensor, mesh: Optional[Mesh] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """``crypto.p256.verify_packed`` with its (42, N) lanes split over the
    mesh: one launch of the Jacobian kernel (at ``window``, by default
    ``p256.VERIFY_WINDOW``) on each non-empty shard's device, queued in
    turn; the (N,) int32 results in lane order on the first device."""
    global VERIFY_LAUNCHES
    mesh = mesh or make_mesh()
    shards, = shard_batch_arrays(mesh, packed)
    outs, launched = [], 0
    for part in shards:
        if part.shape[-1] == 0:
            continue
        outs.append(p256.verify_packed(part, window))
        launched += part.device.type == "cuda"
    with _COUNT_LOCK:
        VERIFY_LAUNCHES += launched
    if not outs:
        return torch.empty(0, dtype=torch.int32, device=mesh[0])
    return torch.cat([o.to(mesh[0]) for o in outs])
