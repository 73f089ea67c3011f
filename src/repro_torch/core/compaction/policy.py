"""When to compact: pending delta rows vs. the packed base.

The memtable (delta segments) serves reads RAM-resident, so small
backlogs are cheap; compaction pays one full re-encode to restore the
write-once fast paths (fused traversal plans, device-resident zero
retraces).  The policy triggers when the backlog reaches a row-group's
worth of rows -- the natural flush unit -- or an outsized fraction of
the base.
"""
from __future__ import annotations

#: relative trigger: pending >= this fraction of the base rows
MAX_DELTA_FRACTION = 0.5


def should_compact(pending_rows: int, base_rows: int,
                   row_group_rows: int) -> bool:
    """True when ``pending_rows`` reach one row group
    (``DeltaSegments.row_group_rows``) or ``MAX_DELTA_FRACTION`` of
    ``base_rows``."""
    if pending_rows <= 0:
        return False
    if pending_rows >= row_group_rows:
        return True
    return base_rows > 0 and pending_rows >= MAX_DELTA_FRACTION * base_rows
