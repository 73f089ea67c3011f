"""Crash-consistent compaction of the mutable graph plane.

Folds pending delta-segment rows (:mod:`repro_torch.core.delta_segment`) into
new packed partitions while serving continues, committing through a
single atomic manifest flip:

* :mod:`.policy` -- when to compact (pending rows vs. row-group size /
  base fraction);
* :mod:`.runner` -- the resumable merge -> persist -> swap -> gc stage
  machine, retried with jittered exponential backoff under injected
  faults (:mod:`repro_torch.ft.faults`);
* :mod:`.gc` -- removal of files orphaned by a crash or superseded by a
  committed generation.
"""
from .gc import collect_garbage
from .policy import MAX_DELTA_FRACTION, should_compact
from .runner import CompactionRunner

__all__ = ["CompactionRunner", "MAX_DELTA_FRACTION", "collect_garbage",
           "should_compact"]
