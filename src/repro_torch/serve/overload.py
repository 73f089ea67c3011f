"""Overload control: graceful, counted, reversible degradation.

Admission control bounds the queues; the overload controller bounds the
*tick*.  It watches the engine's per-tick latency (the tick breakdown's
``tick_ms``) over a sliding window and, when the window's p99 exceeds
the configured target for ``patience`` consecutive ticks, steps down a
fixed degradation ladder -- each step a named, reversible knob turn that
trades context quality for tick latency:

1. ``cap_hops``       -- deep retrieval collapses to 1 hop (the k-hop
                         traversal is the most expensive optional work a
                         tick does);
2. ``no_speculation`` -- the speculative prefetch is skipped (under
                         overload mis-speculation rollbacks are pure
                         waste);
3. ``shrink_context`` -- the retriever's per-request neighbor budget is
                         halved (smaller decodes, smaller prompts).

When the window's p99 falls back below ``recovery * target`` for
``patience`` ticks, the most recent step is reverted -- the ladder is a
stack, climbed back up one rung at a time.  Every transition is counted
and timestamped (``stats()["overload"]``) so a saturation bench can
assert the controller engaged and disengaged rather than hope it did.

The controller never reads a wall clock of its own: it observes the
latencies the engine hands it, so a recorded sequence of tick latencies
replays to the same degradation trace.  The JAX package's
``serve/overload.py``, numpy only, copied as it is.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """``target_p99_ms`` is the tick-latency objective; ``window`` the
    sliding sample count the p99 is estimated over; ``patience`` the
    consecutive over/under observations required before acting (debounce
    -- a single slow tick, e.g. a compile, must not shed work)."""
    target_p99_ms: float
    window: int = 32
    patience: int = 4
    recovery: float = 0.6     # revert threshold, as a fraction of target

    def __post_init__(self):
        if self.target_p99_ms <= 0:
            raise ValueError("target_p99_ms must be > 0")
        if self.window < 4 or self.patience < 1:
            raise ValueError("want window >= 4 and patience >= 1")
        if not (0.0 < self.recovery < 1.0):
            raise ValueError("recovery must be in (0, 1)")


LADDER = ("cap_hops", "no_speculation", "shrink_context")


class OverloadController:
    """Applies/reverts the degradation ladder on a live engine.

    Constructed by :class:`~repro_torch.serve.engine.ServeEngine` when an
    :class:`OverloadConfig` is passed; ``observe(tick_ms)`` is called at
    the end of every tick.
    """

    def __init__(self, engine, cfg: OverloadConfig):
        self.engine = engine
        self.cfg = cfg
        self._lat: deque = deque(maxlen=cfg.window)
        self.level = 0                  # rungs currently applied
        self.degrade_steps = 0          # transitions down, cumulative
        self.restore_steps = 0          # transitions up, cumulative
        self._over = 0
        self._under = 0
        self._saved: Dict[str, object] = {}
        self.history: List[Dict[str, object]] = []
        self.last_p99 = 0.0

    def observe(self, tick_ms: float) -> None:
        self._lat.append(float(tick_ms))
        if len(self._lat) < max(4, self.cfg.window // 4):
            return
        p99 = float(np.percentile(np.asarray(self._lat), 99))
        self.last_p99 = p99
        # the windowed p99 holds a single spike over target for a full
        # window -- require the *current* tick to also be slow, so the
        # patience counter measures consecutive slow ticks, not the
        # echo of one outlier
        if p99 > self.cfg.target_p99_ms and tick_ms > self.cfg.target_p99_ms:
            self._over += 1
            self._under = 0
            if self._over >= self.cfg.patience and self.level < len(LADDER):
                self._apply(LADDER[self.level])
                self._over = 0
                # degraded work changes the latency mix: restart the
                # window so the next decision reflects the new regime
                self._lat.clear()
        elif p99 < self.cfg.recovery * self.cfg.target_p99_ms:
            self._under += 1
            self._over = 0
            if self._under >= self.cfg.patience and self.level > 0:
                self._revert(LADDER[self.level - 1])
                self._under = 0
                self._lat.clear()
        else:
            self._over = self._under = 0

    # -- the ladder ------------------------------------------------------------
    def _retr(self):
        """The degradable retrieval plane, if the engine has one."""
        fn = self.engine.context_fn
        return fn if fn is not None and hasattr(fn, "set_knob") else None

    def _apply(self, step: str) -> None:
        # any in-flight speculative contexts were computed under the
        # old knobs -- discard (and rewind) before changing them
        self.engine._discard_prefetch()
        retr = self._retr()
        if step == "cap_hops":
            self._saved[step] = (retr.set_knob("hops", 1)
                                 if retr is not None else None)
        elif step == "no_speculation":
            self._saved[step] = self.engine.spec_disabled
            self.engine.spec_disabled = True
        elif step == "shrink_context":
            if retr is not None:
                old = retr.max_neighbors
                self._saved[step] = retr.set_knob(
                    "max_neighbors", max(1, old // 2))
            else:
                self._saved[step] = None
        self.level += 1
        self.degrade_steps += 1
        self.history.append({"tick": self.engine.tick_no, "step": step,
                             "dir": "degrade", "p99_ms": round(self.last_p99, 3)})

    def _revert(self, step: str) -> None:
        self.engine._discard_prefetch()
        retr = self._retr()
        saved = self._saved.pop(step, None)
        if step == "cap_hops":
            if retr is not None and saved is not None:
                retr.set_knob("hops", saved)
        elif step == "no_speculation":
            self.engine.spec_disabled = bool(saved)
        elif step == "shrink_context":
            if retr is not None and saved is not None:
                retr.set_knob("max_neighbors", saved)
        self.level -= 1
        self.restore_steps += 1
        self.history.append({"tick": self.engine.tick_no, "step": step,
                             "dir": "restore", "p99_ms": round(self.last_p99, 3)})

    def stats(self) -> Dict[str, object]:
        return {
            "level": self.level,
            "active_steps": list(LADDER[:self.level]),
            "degrade_steps": self.degrade_steps,
            "restore_steps": self.restore_steps,
            "p99_ms": round(self.last_p99, 3),
            "target_p99_ms": self.cfg.target_p99_ms,
            "transitions": list(self.history),
        }
