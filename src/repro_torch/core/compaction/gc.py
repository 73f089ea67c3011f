"""Garbage collection for a :class:`~repro_torch.core.storage.GraphStore`.

After a committed compaction (or a crash partway through one) the store
root can hold files no reader will ever follow: ``.tmp-*`` staging files
from interrupted atomic writes, generation files that never made it into
the manifest, and legacy / older-generation files superseded by the
committed manifest.  Collection is idempotent -- a crash mid-GC
(``compact.mid_gc`` fault boundary, checked before every unlink) leaves
a subset removed and the next run removes the rest.
"""
from __future__ import annotations

import os
from typing import List, Optional

from repro_torch.ft import faults as ft_faults

from ..storage import _GEN_RE, GraphStore


def collect_garbage(store: GraphStore,
                    faults: "Optional[ft_faults.FaultPlan]" = None
                    ) -> List[str]:
    """Remove unreferenced files from the store root; returns their names.

    Only files the committed manifest renders unreachable are touched:

    * ``*.tmp-*`` -- interrupted atomic-write staging files;
    * generation files (``<name>.g<gen>.gar``) the manifest does not
      reference -- staged by a compaction that never committed, or
      superseded by a later generation;
    * legacy ``<name>.gar`` files whose logical name the manifest now
      maps to a generation file.

    ``graph.yaml``, the manifest itself, and legacy tables outside the
    manifest (e.g. vertex/token tables of a write-once store) survive.
    """
    removed: List[str] = []
    if not os.path.isdir(store.root):
        return removed
    manifest = store.manifest()
    tables = {} if manifest is None else manifest.get("tables", {})
    referenced = set(tables.values())
    for fname in sorted(os.listdir(store.root)):
        if ".tmp-" in fname:
            dead = True
        elif fname in referenced:
            dead = False
        elif _GEN_RE.search(fname):
            dead = True
        elif fname.endswith(".gar") and fname[:-4] in tables:
            dead = True  # legacy file superseded by a committed generation
        else:
            dead = False
        if not dead:
            continue
        ft_faults.check(faults, "compact.mid_gc")
        os.unlink(os.path.join(store.root, fname))
        removed.append(fname)
    return removed
