"""Fault-tolerance coordinator: heartbeats, failure detection, restart.

Models the control plane of a multi-pod training job.  Worker processes
(simulated in-process here; separate hosts in production) report
heartbeats per step; the coordinator:

* declares a worker failed after ``heartbeat_timeout`` without progress,
* on failure, halts the step barrier, selects the restart plan
  (same-size restart from the latest *committed* checkpoint, or an
  elastic scale-down onto the surviving mesh via checkpoint/reshard.py),
* tracks stragglers: workers whose step latency exceeds
  ``straggler_factor`` x the cluster median get flagged; persistent
  stragglers trigger (simulated) hot-spare promotion -- the scheduling
  decision is real, the hardware swap is the cluster's job.

The same class drives the tests and the trainer loop's failure hooks --
the trainer calls ``tick`` each step and obeys the actions returned.  The
JAX package's ``ft/coordinator.py``, as it is, over the port's
``ft/backoff.py``.

Liveness and strike bookkeeping live in :mod:`repro_torch.ft.backoff`
(:class:`~repro_torch.ft.backoff.HeartbeatTracker`,
:class:`~repro_torch.ft.backoff.StrikeCounter`) -- shared with the mutable
graph plane's compaction runner, which retries via the same module's
:class:`~repro_torch.ft.backoff.Backoff`.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional

from .backoff import HeartbeatTracker, StrikeCounter


class WorkerState(enum.Enum):
    HEALTHY = "healthy"
    STRAGGLING = "straggling"
    FAILED = "failed"
    EVICTED = "evicted"


class Action(enum.Enum):
    CONTINUE = "continue"
    RESTART_FROM_CHECKPOINT = "restart"
    ELASTIC_SCALE_DOWN = "elastic_scale_down"
    PROMOTE_SPARE = "promote_spare"


@dataclasses.dataclass
class Worker:
    worker_id: int
    state: WorkerState = WorkerState.HEALTHY
    last_step: int = -1
    step_latencies: List[float] = dataclasses.field(default_factory=list)
    strikes: StrikeCounter = dataclasses.field(
        default_factory=lambda: StrikeCounter(3))

    @property
    def slow_strikes(self) -> int:
        return self.strikes.strikes


@dataclasses.dataclass
class Decision:
    action: Action
    failed_workers: List[int]
    stragglers: List[int]
    restore_step: Optional[int] = None
    surviving_workers: Optional[List[int]] = None


class Coordinator:
    def __init__(self, num_workers: int, heartbeat_timeout: float = 30.0,
                 straggler_factor: float = 2.0, strike_limit: int = 3,
                 spares: int = 1, clock=time.monotonic):
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_factor = straggler_factor
        self.strike_limit = strike_limit
        self.spares = spares
        self.clock = clock
        self.beats = HeartbeatTracker(heartbeat_timeout, clock)
        self.workers = {i: self._new_worker(i) for i in range(num_workers)}

    def _new_worker(self, wid: int) -> Worker:
        self.beats.register(wid)
        return Worker(wid, strikes=StrikeCounter(self.strike_limit))

    # ---- worker-side API ----------------------------------------------------
    def heartbeat(self, worker_id: int, step: int,
                  step_latency: Optional[float] = None) -> None:
        w = self.workers[worker_id]
        if w.state in (WorkerState.FAILED, WorkerState.EVICTED):
            return
        self.beats.beat(worker_id)
        w.last_step = max(w.last_step, step)
        if step_latency is not None:
            w.step_latencies.append(step_latency)
            if len(w.step_latencies) > 32:
                w.step_latencies = w.step_latencies[-32:]

    # ---- control plane ------------------------------------------------------
    def _median_latency(self) -> Optional[float]:
        lats = [w.step_latencies[-1] for w in self.workers.values()
                if w.step_latencies
                and w.state not in (WorkerState.FAILED, WorkerState.EVICTED)]
        if not lats:
            return None
        lats = sorted(lats)
        return lats[len(lats) // 2]

    def tick(self, latest_committed_step: Optional[int]) -> Decision:
        now = self.clock()
        failed, stragglers = [], []
        median = self._median_latency()
        for w in self.workers.values():
            if w.state in (WorkerState.FAILED, WorkerState.EVICTED):
                continue
            if self.beats.is_expired(w.worker_id, now):
                w.state = WorkerState.FAILED
                failed.append(w.worker_id)
                continue
            if median and w.step_latencies and \
                    w.step_latencies[-1] > self.straggler_factor * median:
                w.strikes.strike()
                w.state = WorkerState.STRAGGLING
                stragglers.append(w.worker_id)
            elif w.state == WorkerState.STRAGGLING:
                w.state = WorkerState.HEALTHY
                w.strikes.clear()

        # persistent stragglers: promote a spare (hot swap)
        for wid in list(stragglers):
            w = self.workers[wid]
            if w.strikes.tripped and self.spares > 0:
                self.spares -= 1
                w.state = WorkerState.EVICTED
                nid = max(self.workers) + 1
                self.workers[nid] = self._new_worker(nid)
                return Decision(Action.PROMOTE_SPARE, failed, stragglers,
                                restore_step=latest_committed_step)

        if failed:
            survivors = [w.worker_id for w in self.workers.values()
                         if w.state == WorkerState.HEALTHY
                         or w.state == WorkerState.STRAGGLING]
            if self.spares >= len(failed):
                self.spares -= len(failed)
                for _ in failed:
                    nid = max(self.workers) + 1
                    self.workers[nid] = self._new_worker(nid)
                return Decision(Action.RESTART_FROM_CHECKPOINT, failed,
                                stragglers,
                                restore_step=latest_committed_step)
            return Decision(Action.ELASTIC_SCALE_DOWN, failed, stragglers,
                            restore_step=latest_committed_step,
                            surviving_workers=survivors)
        return Decision(Action.CONTINUE, [], stragglers)

    def healthy_count(self) -> int:
        return sum(1 for w in self.workers.values()
                   if w.state in (WorkerState.HEALTHY,
                                  WorkerState.STRAGGLING))
