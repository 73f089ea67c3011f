"""The compaction runner: merge -> persist -> swap -> gc, crash-safely.

One compaction folds a frozen snapshot of the pending delta rows into a
freshly built packed layout (the exact :func:`~repro_torch.core.edge.build_adjacency`
pipeline, so the compacted layout is bit-identical to a from-scratch
rebuild over base + snapshot) and swaps it in **under the version
counter** while serving continues:

* the swap mutates the live column objects in place (pages, counts,
  offsets) and bumps ``DeltaColumn.version`` -- every derived cache
  (decoded-page LRU, the packed column and its device plan, fused
  traversal plans) keys on the version and rebuilds lazily, so no
  reader ever holds a stale reference.  The swap drops the old
  ``PackedPages``, and its device plan with it; the traversal plane frees
  a stale plan's tensors when the new version's plan is built
  (:func:`repro_torch.kernels.traversal.ops.traversal_plan`), so a
  compaction leaves the card holding one copy of each, not two;
* on durable stores the new generation files are staged first and the
  committed state flips with **one** atomic manifest write -- the
  single commit point; a crash on either side of it leaves the store
  serving a consistent generation;
* the runner is a resumable stage machine retried with jittered
  exponential backoff (:mod:`repro_torch.ft.backoff`); each injected fault
  (:mod:`repro_torch.ft.faults` boundaries ``compact.merge`` /
  ``compact.pre_swap`` / ``compact.post_swap`` / ``compact.mid_gc`` /
  ``store.write``) aborts the current attempt at a well-defined point
  and the retry resumes from the last completed stage.  While a
  compaction is failing, the delta path keeps serving -- graceful
  degradation, never wrong answers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.ft import faults as ft_faults
from repro_torch.ft.backoff import Backoff, retry_call

from ..delta_segment import base_edges, live_delta
from ..edge import BY_SRC, AdjacencyTable, build_adjacency
from .gc import collect_garbage
from .policy import should_compact


class CompactionRunner:
    """Compacts one adjacency's mutable plane into new packed partitions.

    ``store`` is optional: without one the compaction is purely
    in-memory (swap only); with one, generation files are staged and the
    manifest flip is the durable commit point.  ``sleep`` is injectable
    so tests observe the backoff schedule without waiting it out.
    """

    def __init__(self, adj: AdjacencyTable, store=None,
                 faults: "Optional[ft_faults.FaultPlan]" = None,
                 backoff: Optional[Backoff] = None,
                 max_attempts: int = 5, sleep=None):
        self.adj = adj
        self.store = store
        self.faults = faults
        self.backoff = backoff or Backoff(base=0.01, max_delay=0.25, seed=0)
        self.max_attempts = int(max_attempts)
        self.sleep = sleep if sleep is not None else (lambda _s: None)
        self._job: Optional[Dict[str, object]] = None
        self.compactions = 0   # completed merge->swap cycles
        self.attempts = 0      # _run invocations (first tries + retries)
        self.faults_hit = 0    # injected faults absorbed by retry
        self.gave_up = 0       # compact() calls that exhausted retries

    # -- policy gate -------------------------------------------------------
    def maybe_compact(self) -> bool:
        """Compact iff the policy says the backlog warrants it."""
        delta = live_delta(self.adj)
        if delta is None:
            return False
        if not should_compact(delta.pending_rows(), self.adj.num_edges,
                              delta.row_group_rows):
            return False
        return self.compact()

    # -- the resumable stage machine ---------------------------------------
    def compact(self) -> bool:
        """Run one full compaction; True when the swap committed.

        Injected faults are retried with backoff; after
        ``max_attempts`` total attempts the runner gives up gracefully
        -- the job (and its completed stages) is retained for a later
        ``compact()`` call and the delta path keeps serving meanwhile.
        """
        if live_delta(self.adj) is None and self._job is None:
            return False
        if self._job is None:
            self._job = {"stage": "merge"}
        try:
            retry_call(lambda: self._run(self._job),
                       retries=self.max_attempts - 1,
                       backoff=self.backoff, sleep=self.sleep,
                       retry_on=(ft_faults.InjectedFault,),
                       on_retry=self._note_fault)
        except ft_faults.InjectedFault:
            self.faults_hit += 1
            self.gave_up += 1
            return False
        self._job = None
        self.compactions += 1
        return True

    def _note_fault(self, attempt, delay, exc) -> None:
        self.faults_hit += 1

    def _run(self, job: Dict[str, object]) -> None:
        self.attempts += 1
        if job["stage"] == "merge":
            self._merge(job)
            job["stage"] = "persist"
        if job["stage"] == "persist":
            self._persist(job)
            job["stage"] = "swap"
        if job["stage"] == "swap":
            ft_faults.check(self.faults, "compact.pre_swap")
            self._swap(job)
            # swap is committed: a fault past this point must NOT redo it
            job["stage"] = "gc"
            ft_faults.check(self.faults, "compact.post_swap")
        if job["stage"] == "gc":
            if self.store is not None:
                collect_garbage(self.store, self.faults)
            job["stage"] = "done"

    def _merge(self, job: Dict[str, object]) -> None:
        """Snapshot the backlog and rebuild the packed layout over
        base + snapshot -- the identical ``build_adjacency`` pipeline a
        from-scratch rebuild runs, so pages come out bit-identical."""
        ft_faults.check(self.faults, "compact.merge")
        adj = self.adj
        delta = adj.delta
        frozen = delta.snapshot()
        ks = [k for k, _ in frozen.values()]
        vs = [v for _, v in frozen.values()]
        dk = np.concatenate(ks) if ks else np.zeros(0, np.int64)
        dv = np.concatenate(vs) if vs else np.zeros(0, np.int64)
        dsrc, ddst = (dk, dv) if adj.order == BY_SRC else (dv, dk)
        bsrc, bdst = base_edges(adj)
        nkey = adj.num_key_vertices
        nval = adj.num_value_vertices
        if adj.order == BY_SRC:
            num_src, num_dst = nkey, (nval if nval is not None else
                                      int(max(bdst.max(initial=0),
                                              ddst.max(initial=0))) + 1)
        else:
            num_dst, num_src = nkey, (nval if nval is not None else
                                      int(max(bsrc.max(initial=0),
                                              dsrc.max(initial=0))) + 1)
        new = build_adjacency(
            np.concatenate([bsrc, dsrc]), np.concatenate([bdst, ddst]),
            num_src, num_dst, order=adj.order, encoding=adj.encoding,
            page_size=adj.table.page_size)
        job["frozen"] = frozen
        job["new"] = new

    def _persist(self, job: Dict[str, object]) -> None:
        """Stage generation files -- invisible until the manifest flip.
        Idempotent: a retry rewrites the same staged files atomically."""
        if self.store is None:
            return
        new: AdjacencyTable = job["new"]  # type: ignore[assignment]
        if "generation" not in job:
            job["generation"] = self.store.current_generation() + 1
        gen = job["generation"]
        old = self.adj
        tables = {}
        manifest = self.store.manifest()
        if manifest is not None:
            tables.update(manifest.get("tables", {}))
        for logical, table in ((old.table.name, new.table),
                               (old.offsets.name, new.offsets)):
            # shallow rename so the store files carry the serving
            # table's logical name (columns shared by reference)
            staged = dataclasses.replace(table, name=logical)
            tables[logical] = self.store.write_generation(staged, gen)
        job["tables"] = tables

    def _swap(self, job: Dict[str, object]) -> None:
        """The commit: one atomic manifest flip (durable stores), then
        the in-place pointer swap under the version counter, then drop
        of exactly the frozen rows.  No fault boundary interleaves the
        in-memory steps, so readers see before-or-after, never between."""
        if self.store is not None:
            self.store.commit_manifest(job["tables"], job["generation"])
        adj = self.adj
        new: AdjacencyTable = job["new"]  # type: ignore[assignment]
        for name in ("<src>", "<dst>"):
            oldc = adj.table[name]
            newc = new.table[name]
            enc = oldc.encoded
            enc.pages = newc.encoded.pages
            enc.count = newc.encoded.count
            enc.packed_cache = None      # frees the device plan; re-ships
            enc.bump_version()           # every derived cache re-keys
            oldc.count = newc.count
        adj.table.num_rows = new.table.num_rows
        off = adj.offsets["<offset>"]
        off.values = new.offsets["<offset>"].values
        off._stats = None
        adj.delta.drop_rows(job["frozen"])
