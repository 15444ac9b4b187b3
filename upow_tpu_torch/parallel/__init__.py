"""Nonce-range planning across processes (the JAX package's
``parallel/multihost.py``, less its ``jax.distributed`` bring-up)."""

from .multihost import initialize, plan_nonce_ranges
