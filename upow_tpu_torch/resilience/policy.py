"""Retry with jittered exponential backoff under a total deadline (the
port's copy of the JAX package's ``resilience/policy.py``).

One policy describes how a *logical* call may be retried: ``attempts``
tries, spaced ``base_delay`` x ``multiplier``^n apart (capped at
``max_delay``), each delay jittered by +/- ``jitter``, all inside
``deadline`` seconds.  The jitter draws from a ``random.Random`` that the
caller passes, so a seeded caller replays the exact schedule.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


class DeadlineExceeded(TimeoutError):
    """The policy's total deadline ran out (before or between attempts)."""


@dataclass
class RetryPolicy:
    attempts: int = 3           # total tries (1 = no retry)
    base_delay: float = 0.25    # delay before the first retry
    max_delay: float = 2.0      # per-delay ceiling
    multiplier: float = 2.0     # exponential growth factor
    jitter: float = 0.5         # each delay scaled by [1-j, 1+j]
    deadline: float = 45.0      # total budget in seconds; 0 = unbounded

    def delay_for(self, retry_no: int, rng: random.Random) -> float:
        """Backoff before retry ``retry_no`` (1-based), jittered."""
        delay = min(self.max_delay,
                    self.base_delay * self.multiplier ** (retry_no - 1))
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, delay)


async def call_with_retry(fn: Callable, policy: RetryPolicy, *,
                          rng: random.Random,
                          retry_on: Tuple[Type[BaseException], ...] = (
                              Exception,),
                          on_retry: Optional[Callable] = None,
                          clock: Callable[[], float] = time.monotonic,
                          sleep: Callable = asyncio.sleep):
    """Await ``fn()`` (a zero-argument coroutine factory) under the
    policy: each attempt is cut at the remaining deadline, exceptions not
    in ``retry_on`` propagate at once, and ``on_retry(exc, retry_no)``
    runs before each backoff sleep."""
    start = clock()
    retry_no = 0
    while True:
        remaining = None
        if policy.deadline:
            remaining = policy.deadline - (clock() - start)
            if remaining <= 0:
                raise DeadlineExceeded(
                    f"retry deadline {policy.deadline}s exceeded")
        try:
            if remaining is not None:
                return await asyncio.wait_for(fn(), remaining)
            return await fn()
        except retry_on as e:
            retry_no += 1
            if retry_no >= policy.attempts:
                raise
            delay = policy.delay_for(retry_no, rng)
            if policy.deadline:
                budget = policy.deadline - (clock() - start)
                if budget <= 0:
                    raise
                delay = min(delay, budget)
            if on_retry is not None:
                on_retry(e, retry_no)
            await sleep(delay)
