"""Shared fault-tolerance primitives: backoff, retry, liveness, strikes.

The JAX package's ``ft/backoff.py``, numpy only and copied as it is, so
a seeded schedule gives the reference's delays bit for bit:

* :class:`Backoff` -- jittered exponential delay schedule, deterministic
  under a seed (fault-injection tests replay identical schedules);
* :func:`retry_call` -- call-with-retries around a ``Backoff``, with an
  injectable ``sleep`` so simulated components never block a test;
* :class:`HeartbeatTracker` -- last-beat bookkeeping + timeout expiry;
* :class:`StrikeCounter` -- N-strikes-and-out accumulator (straggler
  eviction, poisoned-mirror demotion, any "repeated offender" policy);
* :class:`TokenBucket` -- rate/burst admission bucket on an injectable
  clock (the serving plane's per-tenant backpressure; deterministic
  under the engine's tick counter, no wall-clock reads).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np


class Backoff:
    """Jittered exponential backoff schedule.

    ``delay(attempt)`` returns ``min(base * factor**attempt, max_delay)``
    scaled by a uniform jitter in ``[1 - jitter, 1 + jitter]``.  Jitter
    draws come from a seeded generator, so a seeded schedule is exactly
    reproducible (the fault-injection tests assert on it) while still
    decorrelating real retry storms.
    """

    def __init__(self, base: float = 0.05, factor: float = 2.0,
                 max_delay: float = 2.0, jitter: float = 0.5,
                 seed: Optional[int] = None):
        if base < 0 or factor < 1.0 or not (0.0 <= jitter < 1.0):
            raise ValueError("want base >= 0, factor >= 1, 0 <= jitter < 1")
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self._rng = np.random.default_rng(seed)

    def delay(self, attempt: int) -> float:
        d = min(self.base * self.factor ** attempt, self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return d

    def delays(self) -> Iterator[float]:
        """Infinite generator of successive delays (attempt 0, 1, ...)."""
        attempt = 0
        while True:
            yield self.delay(attempt)
            attempt += 1


def retry_call(fn: Callable, retries: int = 5,
               backoff: Optional[Backoff] = None,
               sleep: Callable[[float], None] = time.sleep,
               retry_on: Tuple[type, ...] = (Exception,),
               on_retry: Optional[Callable] = None):
    """Call ``fn()``; on a retryable exception sleep the next backoff
    delay and try again, up to ``retries`` retries (``retries + 1``
    attempts total).  The final failure propagates.

    ``sleep`` is injectable so simulated components (tests, the in-process
    compaction runner) record delays instead of blocking; ``on_retry``
    (``attempt, delay, exc``) observes each retry decision.
    """
    bo = backoff if backoff is not None else Backoff()
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on as e:
            if attempt == retries:
                raise
            d = bo.delay(attempt)
            if on_retry is not None:
                on_retry(attempt, d, e)
            sleep(d)


class HeartbeatTracker:
    """Last-beat bookkeeping and timeout detection for a set of members.

    The clock is injectable (the coordinator tests drive a fake clock);
    ``expired(now)`` names members whose last beat is older than
    ``timeout`` -- detection only, acting on it is the caller's policy.
    """

    def __init__(self, timeout: float, clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self._last: Dict[object, float] = {}

    def register(self, member, now: Optional[float] = None) -> None:
        self._last[member] = self.clock() if now is None else now

    def beat(self, member, now: Optional[float] = None) -> None:
        self._last[member] = self.clock() if now is None else now

    def last(self, member) -> float:
        return self._last[member]

    def drop(self, member) -> None:
        self._last.pop(member, None)

    def is_expired(self, member, now: Optional[float] = None) -> bool:
        now = self.clock() if now is None else now
        return now - self._last[member] > self.timeout

    def expired(self, now: Optional[float] = None) -> list:
        now = self.clock() if now is None else now
        return [m for m, t in self._last.items() if now - t > self.timeout]


class TokenBucket:
    """Rate/burst token bucket over an *explicit* clock.

    Every operation takes ``now`` (any monotone number -- the serving
    plane passes its tick counter), so a bucket's behavior is a pure
    function of the (config, operation sequence) pair: replaying the
    same submits at the same ticks yields the same admit/reject
    decisions and the same retry hints.  No wall-clock reads anywhere.

    ``try_take(now)`` refills ``rate * elapsed`` (capped at ``burst``)
    and either takes ``cost`` tokens or reports how long until the
    refill covers the deficit -- the caller's typed retry-after.
    """

    def __init__(self, rate: float, burst: float, now: float = 0.0):
        if rate < 0 or burst <= 0:
            raise ValueError("want rate >= 0 and burst > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)     # a fresh bucket is full
        self.last = float(now)

    def refill(self, now: float) -> None:
        if now > self.last:
            self.level = min(self.burst,
                             self.level + (now - self.last) * self.rate)
            self.last = now

    def try_take(self, now: float, cost: float = 1.0) -> Tuple[bool, float]:
        """``(True, 0.0)`` when ``cost`` tokens were taken; otherwise
        ``(False, wait)`` with ``wait`` = time until the refill covers
        the deficit (``inf`` for a zero-rate bucket)."""
        self.refill(now)
        if self.level + 1e-9 >= cost:
            self.level -= cost
            return True, 0.0
        deficit = cost - self.level
        wait = deficit / self.rate if self.rate > 0 else float("inf")
        return False, wait


class StrikeCounter:
    """N-strikes-and-out: ``strike()`` accumulates, ``clear()`` forgives,
    ``tripped`` reports whether the limit has been reached."""

    def __init__(self, limit: int):
        if limit < 1:
            raise ValueError("limit must be >= 1")
        self.limit = limit
        self.strikes = 0

    def strike(self) -> bool:
        self.strikes += 1
        return self.tripped

    def clear(self) -> None:
        self.strikes = 0

    @property
    def tripped(self) -> bool:
        return self.strikes >= self.limit

    def __repr__(self) -> str:
        return f"StrikeCounter({self.strikes}/{self.limit})"
