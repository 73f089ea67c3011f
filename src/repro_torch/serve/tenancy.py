"""Multi-tenant admission control for the serving plane.

The engine's single unbounded FIFO becomes, per tenant, a **token-bucket
admission gate** over a **bounded queue**, scheduled into free slots by
**deficit-weighted round-robin** (DWRR) -- backpressure, isolation, and
fairness as typed, testable mechanisms instead of a queue that grows
until the host dies:

* :class:`TenantConfig` -- one tenant's weight, rate/burst, queue bound,
  and default deadline;
* :func:`TenantScheduler.submit` returns a typed :class:`SubmitOutcome`:
  ``ADMITTED``, or ``REJECTED`` with a ``retry_after`` computed from the
  bucket's refill (rate rejection) or the queue bound (shed rejection) --
  the caller is *told* when trying again can work, it never just blocks;
* :meth:`TenantScheduler.pop` serves queued requests into free slots by
  DWRR: each visit credits ``quantum * weight`` deficit and serves one
  request per unit.  With every tenant backlogged, a full round serves
  *exactly* ``weight`` requests per tenant -- fairness is an equality the
  tests assert, not an emergent hope -- and any tenant with pending work
  is visited every round (starvation-free), while idle tenants donate
  their share (work-conserving);
* :meth:`TenantScheduler.peek` previews the next ``k`` pops without
  mutating anything, so the pipelined engine's speculative prefetch can
  predict the DWRR admission order exactly (a wrong prediction is caught
  by the engine's snapshot/rollback).

All clocks are the engine's **tick counter** -- no wall-clock reads, so
every admission decision replays deterministically under a seeded test.
The JAX package's ``serve/tenancy.py``: pure Python, copied as it is.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from collections import deque
from typing import Dict, List, Optional, Sequence

from repro_torch.ft.backoff import TokenBucket


class SubmitStatus(enum.Enum):
    ADMITTED = "admitted"
    REJECTED = "rejected"


class RejectReason(enum.Enum):
    RATE_LIMITED = "rate_limited"    # token bucket empty
    QUEUE_FULL = "queue_full"        # bounded tenant queue at capacity
    UNKNOWN_TENANT = "unknown_tenant"


class RequestStatus(enum.Enum):
    """Terminal status of a request that entered the engine."""
    OK = "ok"                               # finished generating
    DEADLINE_EXCEEDED = "deadline_exceeded"  # expired (queued or in-slot)
    REJECTED = "rejected"                   # never admitted (shed at submit)


@dataclasses.dataclass(frozen=True)
class SubmitOutcome:
    """Typed result of ``submit``: admitted, or rejected with a reason
    and a ``retry_after`` hint in ticks (rate rejections compute it from
    the bucket's refill; ``None`` means retrying cannot help)."""
    status: SubmitStatus
    tenant: str
    reason: Optional[RejectReason] = None
    retry_after: Optional[float] = None

    @property
    def admitted(self) -> bool:
        return self.status is SubmitStatus.ADMITTED


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's admission contract.

    ``weight``    -- DWRR share (integer >= 1): with all tenants
                     backlogged, tenant i receives weight_i / sum(weights)
                     of the admitted slots;
    ``rate``      -- token-bucket refill in requests/tick (``None`` =
                     unmetered: admission limited only by the queue bound);
    ``burst``     -- bucket capacity (defaults to ``max(rate, 1)``);
    ``max_queue`` -- bounded queue depth; submits beyond it shed with
                     ``QUEUE_FULL`` (backpressure to the client, not an
                     unbounded backlog);
    ``deadline_ticks`` -- default per-request deadline (ticks from
                     submission to completion); ``None`` = no deadline.
    """
    name: str
    weight: int = 1
    rate: Optional[float] = None
    burst: Optional[float] = None
    max_queue: int = 64
    deadline_ticks: Optional[int] = None

    def __post_init__(self):
        if self.weight < 1:
            raise ValueError("weight must be >= 1")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.rate is not None and self.rate <= 0:
            raise ValueError("rate must be > 0 (None for unmetered)")


class _TenantState:
    """Scheduler-internal per-tenant state: bounded queue, bucket,
    counters."""

    def __init__(self, cfg: TenantConfig, now: float):
        self.cfg = cfg
        self.queue: deque = deque()
        self.bucket = (TokenBucket(cfg.rate, cfg.burst or max(cfg.rate, 1.0),
                                   now=now)
                       if cfg.rate is not None else None)
        self.deficit = 0.0
        self.submitted = 0
        self.admitted = 0
        self.rejected_rate = 0
        self.rejected_queue = 0
        self.expired = 0
        self.popped = 0
        self.finished_ok = 0
        self.finished_failed = 0


class TenantScheduler:
    """Per-tenant token-bucket admission + DWRR scheduling (see module
    docstring).  The clock is whatever monotone counter the caller
    passes (the engine's tick number)."""

    def __init__(self, tenants: Sequence[TenantConfig],
                 quantum: float = 1.0, now: float = 0.0):
        if not tenants:
            raise ValueError("need at least one TenantConfig")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        if quantum <= 0:
            raise ValueError("quantum must be > 0")
        self.quantum = float(quantum)
        self._state: Dict[str, _TenantState] = {
            t.name: _TenantState(t, now) for t in tenants}
        #: tenants with pending work, in DWRR visit order
        self._active: deque = deque()
        #: True while the head tenant's current visit has already been
        #: credited its quantum -- a pop() that fills k mid-visit resumes
        #: the visit on the next call *without* crediting again (else a
        #: stream of pop(1) calls would grant the head unbounded credit)
        self._head_credited = False

    # -- admission gate --------------------------------------------------------
    def submit(self, req, now: float) -> SubmitOutcome:
        """Gate ``req`` (an engine ``Request`` with a ``tenant`` field)
        through its tenant's bucket and queue bound at tick ``now``.
        On admission the request's ``submitted_tick``/``deadline_at``
        are stamped and it joins the tenant's queue."""
        name = getattr(req, "tenant", None) or "default"
        st = self._state.get(name)
        if st is None:
            return SubmitOutcome(SubmitStatus.REJECTED, name,
                                 RejectReason.UNKNOWN_TENANT, None)
        st.submitted += 1
        if len(st.queue) >= st.cfg.max_queue:
            st.rejected_queue += 1
            # the queue drains at most one request per tick per slot; the
            # honest hint is the bucket-style one: one refill period (or
            # one tick when unmetered) before a slot can have opened
            wait = 1.0 / st.cfg.rate if st.cfg.rate else 1.0
            return SubmitOutcome(SubmitStatus.REJECTED, name,
                                 RejectReason.QUEUE_FULL,
                                 math.ceil(wait))
        if st.bucket is not None:
            ok, wait = st.bucket.try_take(now)
            if not ok:
                st.rejected_rate += 1
                return SubmitOutcome(
                    SubmitStatus.REJECTED, name, RejectReason.RATE_LIMITED,
                    math.ceil(wait) if math.isfinite(wait) else None)
        req.submitted_tick = now
        dl = (req.deadline_ticks if req.deadline_ticks is not None
              else st.cfg.deadline_ticks)
        if dl is not None:
            req.deadline_at = now + dl
        st.admitted += 1
        if not st.queue:
            self._active.append(name)
        st.queue.append(req)
        return SubmitOutcome(SubmitStatus.ADMITTED, name)

    # -- deadline expiry -------------------------------------------------------
    def expire(self, now: float) -> List:
        """Remove and return queued requests whose deadline has passed
        (``now > deadline_at``: the request had every tick up to and
        including its budget) -- they finish with a typed
        ``DEADLINE_EXCEEDED`` status without ever occupying a slot."""
        out = []
        for name, st in self._state.items():
            if not st.queue:
                continue
            kept = deque()
            for req in st.queue:
                da = getattr(req, "deadline_at", None)
                if da is not None and now > da:
                    st.expired += 1
                    out.append(req)
                else:
                    kept.append(req)
            if len(kept) != len(st.queue):
                st.queue = kept
                if not kept:
                    st.deficit = 0.0
                    if self._active and self._active[0] == name:
                        # the mid-visit head vanished: its residual
                        # credit dies with it
                        self._head_credited = False
                    self._active = deque(n for n in self._active
                                         if n != name)
        return out

    # -- DWRR service ----------------------------------------------------------
    def pop(self, k: int, now: Optional[float] = None) -> List:
        """Serve up to ``k`` requests by deficit-weighted round-robin.
        Work-conserving: returns ``min(k, pending())`` requests."""
        out: List = []
        while len(out) < k and self._active:
            name = self._active[0]
            st = self._state[name]
            if not self._head_credited:
                st.deficit += self.quantum * st.cfg.weight
                self._head_credited = True
            while st.queue and st.deficit >= 1.0 and len(out) < k:
                out.append(st.queue.popleft())
                st.deficit -= 1.0
                st.popped += 1
            if not st.queue:
                # an emptied tenant forfeits residual deficit -- credit
                # must not accumulate while idle (classic DWRR)
                st.deficit = 0.0
                self._active.popleft()
                self._head_credited = False
            elif st.deficit < 1.0:
                self._active.rotate(-1)
                self._head_credited = False
            # else: k filled mid-visit (queue and deficit both remain) --
            # the tenant stays at the head, still credited; the next pop
            # resumes exactly here without granting a second quantum
        return out

    def peek(self, k: int) -> List:
        """The next ``k`` requests :meth:`pop` would return, without
        mutating any state -- the pipelined engine's speculative
        admission preview."""
        deficit = {n: st.deficit for n, st in self._state.items()}
        active = deque(self._active)
        idx = {n: 0 for n in self._state}
        credited = self._head_credited    # resume state of the head visit
        out: List = []
        while len(out) < k and active:
            name = active[0]
            st = self._state[name]
            q = st.queue
            if not credited:
                deficit[name] += self.quantum * st.cfg.weight
            credited = False              # later visits are fresh
            while idx[name] < len(q) and deficit[name] >= 1.0 \
                    and len(out) < k:
                out.append(q[idx[name]])
                idx[name] += 1
                deficit[name] -= 1.0
            if idx[name] >= len(q):
                active.popleft()
            elif deficit[name] < 1.0:
                active.rotate(-1)
            else:
                break                     # k filled mid-visit
        return out

    # -- introspection ---------------------------------------------------------
    def pending(self) -> int:
        return sum(len(st.queue) for st in self._state.values())

    def pending_ids(self) -> List[int]:
        return [req.request_id for st in self._state.values()
                for req in st.queue]

    def queue_depth(self, tenant: str) -> int:
        return len(self._state[tenant].queue)

    def configs(self) -> Dict[str, TenantConfig]:
        return {n: st.cfg for n, st in self._state.items()}

    def note_finished(self, req, status: RequestStatus) -> None:
        """Engine callback at retirement: per-tenant outcome counters."""
        st = self._state.get(getattr(req, "tenant", None) or "default")
        if st is None:
            return
        if status is RequestStatus.OK:
            st.finished_ok += 1
        else:
            st.finished_failed += 1

    def stats(self) -> Dict[str, Dict[str, object]]:
        """Per-tenant admission/fairness counters (``stats()["tenants"]``)."""
        out: Dict[str, Dict[str, object]] = {}
        for name, st in self._state.items():
            out[name] = {
                "weight": st.cfg.weight,
                "rate": st.cfg.rate,
                "max_queue": st.cfg.max_queue,
                "queue_depth": len(st.queue),
                "bucket_level": (round(st.bucket.level, 3)
                                 if st.bucket is not None else None),
                "deficit": round(st.deficit, 3),
                "submitted": st.submitted,
                "admitted": st.admitted,
                "rejected_rate": st.rejected_rate,
                "rejected_queue_full": st.rejected_queue,
                "expired": st.expired,
                "scheduled": st.popped,
                "finished_ok": st.finished_ok,
                "finished_failed": st.finished_failed,
            }
        return out
