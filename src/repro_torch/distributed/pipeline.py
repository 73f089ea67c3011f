"""1F1B pipeline-parallel schedule (an optional axis, for capacity
planning of deeper meshes).

The JAX package's ``distributed/pipeline.py``, as it is: pure Python,
with nothing of either framework.  What's real here: the 1F1B schedule
generator with bubble accounting, and a host-level executor that runs the
schedule over callables and is tested equal to their sequential
composition.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Tick:
    stage: int
    micro: int
    phase: str  # "fwd" | "bwd"


def schedule_1f1b(n_stages: int, n_micro: int) -> List[List[Tick]]:
    """Per-timestep ticks of the 1F1B schedule.

    Returns a list of timesteps; each timestep lists the (stage, micro,
    phase) work items running in parallel.  Verified properties (tests):
    every (stage, micro) runs fwd exactly once and bwd exactly once; fwd
    of (s, m) precedes fwd of (s+1, m); bwd of (s+1, m) precedes bwd of
    (s, m); steady-state has one fwd + one bwd in flight per stage.
    """
    # event-driven simulation with 1F1B priority
    fwd_done = set()
    bwd_done = set()
    next_fwd = [0] * n_stages
    next_bwd = [0] * n_stages
    in_flight_fwd = [0] * n_stages  # fwd count not yet bwd'd per stage
    timeline: List[List[Tick]] = []
    total = 2 * n_stages * n_micro
    while len(fwd_done) + len(bwd_done) < total:
        ticks: List[Tick] = []
        busy = set()
        for s in range(n_stages):
            if s in busy:
                continue
            # 1F1B: prefer bwd when warmed up (limit in-flight to depth)
            m_b = next_bwd[s]
            can_bwd = (m_b < n_micro
                       and (s == n_stages - 1 and (s, m_b) in fwd_done
                            or (s + 1, m_b) in bwd_done)
                       and (s, m_b) in fwd_done)
            m_f = next_fwd[s]
            can_fwd = (m_f < n_micro
                       and (s == 0 or (s - 1, m_f) in fwd_done)
                       and in_flight_fwd[s] < (n_stages - s))
            if can_bwd and (in_flight_fwd[s] >= (n_stages - s) or not can_fwd):
                ticks.append(Tick(s, m_b, "bwd"))
                busy.add(s)
            elif can_fwd:
                ticks.append(Tick(s, m_f, "fwd"))
                busy.add(s)
        if not ticks:
            raise RuntimeError("schedule deadlock")
        for t in ticks:
            if t.phase == "fwd":
                fwd_done.add((t.stage, t.micro))
                next_fwd[t.stage] += 1
                in_flight_fwd[t.stage] += 1
            else:
                bwd_done.add((t.stage, t.micro))
                next_bwd[t.stage] += 1
                in_flight_fwd[t.stage] -= 1
        timeline.append(ticks)
    return timeline


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the classic 1F1B pipeline: (S-1)/(S-1+M) per
    direction -- the capacity-planning number."""
    timeline = schedule_1f1b(n_stages, n_micro)
    used = sum(len(t) for t in timeline)
    return 1.0 - used / (len(timeline) * n_stages)


def run_pipelined(stages: Sequence[Callable], micro_inputs: Sequence,
                  n_stages: int = None):
    """Host executor: runs the 1F1B schedule over callables; returns
    per-microbatch outputs (tested equal to sequential composition)."""
    n_stages = n_stages or len(stages)
    n_micro = len(micro_inputs)
    acts: Dict[Tuple[int, int], object] = {}
    outs: Dict[int, object] = {}
    for ticks in schedule_1f1b(n_stages, n_micro):
        for t in ticks:
            if t.phase != "fwd":
                continue
            x = (micro_inputs[t.micro] if t.stage == 0
                 else acts[(t.stage - 1, t.micro)])
            y = stages[t.stage](x)
            acts[(t.stage, t.micro)] = y
            if t.stage == n_stages - 1:
                outs[t.micro] = y
    return [outs[m] for m in range(n_micro)]
