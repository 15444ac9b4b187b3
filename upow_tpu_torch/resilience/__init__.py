"""Resilience: retry and backoff of outbound RPC, per-peer circuit
breakers, the device path's degrade state machine (``degrade.py``) and
deterministic fault injection (the port's copy of the JAX package's
``resilience/``).

:class:`ResilienceContext` is what the node builds once from
``ResilienceConfig`` and hands to every ``NodeInterface``.  Nothing here
touches chain state.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

from .breaker import (BreakerRegistry, CircuitBreaker, CircuitOpenError,
                      CLOSED, HALF_OPEN, OPEN)
from .degrade import DEGRADED, OK, POISONED, DegradeManager, DeviceBlocked
from .faultinject import (FaultInjected, FaultInjector, get_injector,
                          install, uninstall)
from .policy import DeadlineExceeded, RetryPolicy, call_with_retry

__all__ = [
    "BreakerRegistry", "CircuitBreaker", "CircuitOpenError",
    "CLOSED", "HALF_OPEN", "OPEN",
    "DegradeManager", "DeviceBlocked", "DEGRADED", "OK", "POISONED",
    "FaultInjected", "FaultInjector", "get_injector", "install",
    "uninstall",
    "DeadlineExceeded", "RetryPolicy", "call_with_retry",
    "ResilienceContext",
]


@dataclass
class ResilienceContext:
    """What an outbound-RPC wrapper needs, built once per node."""

    policy: RetryPolicy
    breakers: BreakerRegistry
    rng: Optional[random.Random] = None

    @classmethod
    def from_config(cls, rcfg, breakers: Optional[BreakerRegistry] = None
                    ) -> "ResilienceContext":
        policy = RetryPolicy(
            attempts=rcfg.rpc_attempts,
            base_delay=rcfg.rpc_backoff_base,
            max_delay=rcfg.rpc_backoff_max,
            multiplier=rcfg.rpc_backoff_multiplier,
            jitter=rcfg.rpc_jitter,
            deadline=rcfg.rpc_deadline,
        )
        if breakers is None:
            breakers = BreakerRegistry(
                failure_threshold=rcfg.breaker_failure_threshold,
                open_secs=rcfg.breaker_open_secs,
                half_open_max=rcfg.breaker_half_open_max,
            )
        return cls(policy=policy, breakers=breakers,
                   rng=random.Random(rcfg.faults_seed))
