"""Deterministic fault-injection harness (the JAX package's
``ft/faults.py``, numpy only; the same seed gives the same trips).

Components on the write path (delta-segment ingest, the compaction
runner, durable storage writes) call :func:`check` at **named
boundaries**; an armed :class:`FaultPlan` raises :class:`InjectedFault`
there a configured number of times, simulating a crash at exactly that
point.  Because a plan is just per-boundary trip counts, a run under any
plan is deterministic and replayable -- the invariant tests assert that
serving results are bit-identical to a fault-free run for *every*
boundary.

Boundaries (the write path's crash points, checked by
:mod:`repro_torch.core.delta_segment`, :mod:`repro_torch.core.compaction`
and :mod:`repro_torch.core.storage`):

* ``ingest.append``      -- mid segment append, before the batch publishes
                            (an ingest batch is all-or-nothing);
* ``compact.merge``      -- while merging base + delta into the new layout;
* ``compact.pre_swap``   -- new generation built/persisted, swap not yet
                            committed (the manifest still names the old
                            generation);
* ``compact.post_swap``  -- swap committed, superseded files not yet
                            collected;
* ``compact.mid_gc``     -- between garbage-collection unlinks;
* ``store.write``        -- mid table write (the temp file is torn, the
                            destination untouched).

Serving-plane boundaries -- the engine's per-tick crash points,
checked by :class:`~repro_torch.serve.engine.ServeEngine` when a plan is
attached.  The serving chaos invariant rides on them: under any
boundary x seed, every admitted request either finishes bit-identical
to an unthrottled sequential oracle or carries a typed failure status,
and the engine keeps ticking:

* ``serve.retrieval``    -- around the tick's batched context retrieval
                            (pre-dispatch and at commit; a commit-side
                            fault rewinds the retrieval plane's snapshot
                            before the retry so meter/LRU accounting
                            replays exactly once);
* ``serve.prefill``      -- around the grouped admission prefill (the
                            forward is pure, so a retry recomputes the
                            same logits/cache rows);
* ``serve.spec_commit``  -- at the speculative prefetch's commit point
                            (a fault restores the snapshot and degrades
                            that tick to the synchronous path -- the
                            speculation is optional work, never retried);
* ``serve.ingest``       -- before an ingest-during-serve batch is
                            forwarded to the mutable plane.

``REPRO_FAULT_SEED`` seeds :meth:`FaultPlan.from_env` -- the CI
fault-injection matrix runs the ingest/compaction suites under several
seeds, each deriving a different trip pattern over these boundaries;
the serving-chaos matrix does the same over ``SERVE_BOUNDARIES``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

ENV_SEED = "REPRO_FAULT_SEED"

BOUNDARIES = (
    "ingest.append",
    "compact.merge",
    "compact.pre_swap",
    "compact.post_swap",
    "compact.mid_gc",
    "store.write",
)

#: serving-plane boundaries: the engine's per-tick crash points.
SERVE_BOUNDARIES = (
    "serve.retrieval",
    "serve.prefill",
    "serve.spec_commit",
    "serve.ingest",
)

ALL_BOUNDARIES = BOUNDARIES + SERVE_BOUNDARIES


class InjectedFault(RuntimeError):
    """A simulated crash at a named boundary."""

    def __init__(self, boundary: str, hit: int):
        super().__init__(f"injected fault at {boundary!r} (hit {hit})")
        self.boundary = boundary
        self.hit = hit


class FaultPlan:
    """Per-boundary trip counts; ``check(b)`` raises while trips remain.

    A plan is consumed: each check at an armed boundary decrements its
    remaining trips, so retry loops make progress and every run
    terminates.  ``history`` records the order faults actually fired.
    """

    def __init__(self, trips: Optional[Mapping[str, int]] = None):
        self.trips: Dict[str, int] = {k: int(v) for k, v in
                                      (trips or {}).items() if int(v) > 0}
        self.fired: Dict[str, int] = {}
        self.history: List[str] = []

    @classmethod
    def from_seed(cls, seed: int, boundaries: Sequence[str] = BOUNDARIES,
                  max_trips: int = 2) -> "FaultPlan":
        """Deterministic plan: each boundary gets 0..max_trips trips."""
        rng = np.random.default_rng(seed)
        return cls({b: int(rng.integers(0, max_trips + 1))
                    for b in boundaries})

    @classmethod
    def from_env(cls, default_seed: Optional[int] = None,
                 **kw) -> "Optional[FaultPlan]":
        """Plan from ``REPRO_FAULT_SEED`` (or ``default_seed``); None when
        neither is set -- the unfaulted configuration."""
        raw = os.environ.get(ENV_SEED, "").strip()
        if raw:
            return cls.from_seed(int(raw), **kw)
        if default_seed is not None:
            return cls.from_seed(default_seed, **kw)
        return None

    def check(self, boundary: str) -> None:
        remaining = self.trips.get(boundary, 0)
        if remaining > 0:
            self.trips[boundary] = remaining - 1
            hit = self.fired.get(boundary, 0) + 1
            self.fired[boundary] = hit
            self.history.append(boundary)
            raise InjectedFault(boundary, hit)

    def total_fired(self) -> int:
        return sum(self.fired.values())

    def remaining(self) -> int:
        return sum(self.trips.values())

    def stats(self) -> Dict[str, object]:
        return {"fired": dict(self.fired), "remaining": self.remaining(),
                "history": list(self.history)}

    def __repr__(self) -> str:
        return f"FaultPlan(trips={self.trips}, fired={self.fired})"


def check(plan: "Optional[FaultPlan]", boundary: str) -> None:
    """None-safe boundary check (components hold ``faults=None`` by
    default -- production configuration, no injection overhead)."""
    if plan is not None:
        plan.check(boundary)
