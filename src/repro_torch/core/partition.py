"""Explicit graph partitions over delta columns (GraphAr chunk style).

GraphAr's layout is partitioned: vertex chunks and edge chunks are keyed
by contiguous source-vertex ranges, and because edges are sorted by
source vertex, a source range maps to a contiguous edge-row range -- a
contiguous **page range** of the edge value column.  A :class:`Partition`
is a page-aligned contiguous slice of a
:class:`~repro_torch.core.encoding.DeltaColumn` with its own packed-page
batch arrays (:func:`~repro_torch.core.encoding.build_packed` over the
slice) and value statistics; a :class:`PartitionedColumn` is the ordered
list of partitions covering the whole column.

The partition is the unit of device placement.  The partitions' unpack
plans are stacked partition-major into one plan (row ``k * pmax + j`` is
partition ``k``'s page ``j``).  On one device the retrieval plane runs
the monolithic resident kernels over that stack (the single-shard tail);
over a mesh -- a tuple of ``torch.device``, ``g`` entries -- mesh entry
``i`` holds the block of ``n_parts / g`` partitions ``[i * ppd, (i + 1) *
ppd)`` and takes one launch over it, and the ``g`` bitmap planes are
OR-merged (:mod:`repro_torch.kernels.shard`).  The monolithic path is
the 1-partition case (``partition_column(col, 1)`` routes back to it).

Partition pruning:

* **range pruning** -- partitions holding none of a dispatch's pages are
  skipped (counted only: a pruned partition had nothing to charge);
* **statistics pruning** -- each partition records the min/max id hull
  of its values; with a label filter pushed down, partitions whose hull
  cannot intersect the predicate's qualifying id range are skipped too,
  neither decoded nor charged (ids stay bit-identical).

Both kinds are counted in :attr:`PartitionedColumn.partitions_pruned`
(and ``stats_pruned`` for the second), surfaced through
``GraphRetriever.stats()`` / ``ServeEngine.stats()``.

The JAX package's ``core/partition.py``: the host-side numpy code is its
own copy; the device placements hold ``torch`` tensors.
"""
from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .encoding import DeltaColumn, PackedPages, build_packed, hull_intersects

#: ``REPRO_PARTITIONS=N`` partitions every column the retrieval plane
#: packs (0 / unset keeps the monolithic column; an explicit
#: ``partition_column`` / ``partitions=`` overrides it).
DEFAULT_PARTITIONS = int(os.environ.get("REPRO_PARTITIONS", "0") or 0)


@dataclasses.dataclass
class Partition:
    """One page-aligned contiguous slice of a column.

    ``page_lo``/``page_hi`` are global page indices (half-open);
    ``row_lo``/``row_hi`` the covered rows; ``vmin``/``vmax`` the value
    hull over the slice's pages (empty hull = (0, -1)).  ``packed`` holds
    the slice's own batch arrays with **local** page numbering.
    """

    index: int
    page_lo: int
    page_hi: int
    row_lo: int
    row_hi: int
    vmin: int
    vmax: int
    packed: PackedPages
    #: False when any non-empty page in the slice carries the empty-hull
    #: sentinel (a column read from a file written without statistics):
    #: unknown statistics never prune.
    stats_known: bool = True
    #: the ``torch.device`` this partition's plan block was placed on
    #: (set when a device plan is placed; informational).
    device: "torch.device | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_pages(self) -> int:
        return self.page_hi - self.page_lo

    def intersects_range(self, lo: int, hi: int) -> bool:
        """Whether the value hull can intersect half-open ``[lo, hi)``; an
        unknown hull intersects everything."""
        if not self.stats_known:
            return True
        return hull_intersects(self.vmin, self.vmax, lo, hi)


def partition_bounds(n_pages: int, n_parts: int) -> np.ndarray:
    """Even page split: ``n_parts + 1`` boundaries over ``[0, n_pages]``.

    Every partition gets ``ceil(n_pages / n_parts)`` pages except a short
    tail; with fewer pages than partitions the trailing ones are empty.
    """
    span = -(-max(n_pages, 1) // n_parts)
    return np.minimum(np.arange(n_parts + 1, dtype=np.int64) * span, n_pages)


Mesh = Tuple[torch.device, ...]


@dataclasses.dataclass
class PartitionedColumn:
    """A delta column as an ordered list of page-aligned partitions.

    Built once per ``(column version, n_parts)`` by
    :func:`partition_column` and cached on the column.  Holds the
    per-partition :class:`~repro_torch.core.encoding.PackedPages`, the
    pruning/dispatch counters and the device placements of the stacked
    plan.  Its column is held by a weak reference (the column holds the
    plane in ``partition_cache``), so a column its caller drops frees its
    partitions' pages and device placements at once, with no cyclic
    collection.
    """

    _col: "weakref.ReferenceType[DeltaColumn]"
    bounds: np.ndarray              # int64 [n_parts + 1], page units
    parts: List[Partition]
    version: int = 0
    # -- dispatch counters (reset via reset_stats) --------------------------
    dispatches: int = dataclasses.field(default=0, compare=False)
    partitions_pruned: int = dataclasses.field(default=0, compare=False)
    stats_pruned: int = dataclasses.field(default=0, compare=False)
    #: ("single", device) -> (arrays, pmax); ("mesh", devices) -> tuple of
    #: per-entry block arrays.
    _device_plans: Dict[Tuple, Tuple] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    #: host->device placements of plan bytes.
    device_transfers: int = dataclasses.field(
        default=0, repr=False, compare=False)
    _mesh_sizes: Dict[int, int] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def __post_init__(self) -> None:
        if not isinstance(self._col, weakref.ReferenceType):
            self._col = weakref.ref(self._col)

    @property
    def col(self) -> DeltaColumn:
        col = self._col()
        if col is None:
            raise ReferenceError("the partitioned column was dropped")
        return col

    @property
    def n_parts(self) -> int:
        return len(self.parts)

    @property
    def page_size(self) -> int:
        return self.col.page_size

    @property
    def pmax(self) -> int:
        """Pages per partition slot in the stacked plan (the largest
        partition's page count)."""
        return max((p.n_pages for p in self.parts), default=0) or 1

    @property
    def stack_rows(self) -> int:
        """Rows of the stacked plan (``n_parts * pmax``), the upper bound
        of any dispatch's page-padding class."""
        return self.n_parts * self.pmax

    # -- page bookkeeping ---------------------------------------------------
    def part_of_pages(self, pages: np.ndarray) -> np.ndarray:
        """Partition index of each global page (vectorized)."""
        pages = np.asarray(pages, np.int64)
        return np.searchsorted(self.bounds, pages, side="right") - 1

    def prune(self, pages: np.ndarray,
              qual_range: Optional[Tuple[int, int]] = None,
              owner: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """One dispatch's partition pruning (and counters).

        Returns ``(owner, mask)``: each kept page's partition index and a
        kept-page mask, or ``mask=None`` when every page survives.
        Partitions holding none of ``pages`` are range-pruned (counted
        only); with ``qual_range`` (a predicate's qualifying id hull,
        half-open) partitions whose value hull cannot intersect it are
        statistics-pruned and their pages drop out of the mask.
        """
        self.dispatches += 1
        if owner is None:
            owner = self.part_of_pages(pages)
        present = np.unique(owner)
        if qual_range is not None:
            lo, hi = qual_range
            keep = np.asarray([self.parts[int(k)].intersects_range(lo, hi)
                               for k in present], bool)
            self.stats_pruned += int((~keep).sum())
            live = present[keep]
            self.partitions_pruned += self.n_parts - int(live.size)
            if live.size < present.size:
                mask = np.isin(owner, live)
                return owner[mask], mask
            return owner, None
        self.partitions_pruned += self.n_parts - int(present.size)
        return owner, None

    # -- device plane -------------------------------------------------------
    def mesh_size(self, n_devices: int) -> int:
        """Mesh width for this partition count: the largest divisor ``g``
        of ``n_parts`` with ``g <= n_devices``, so every mesh entry owns
        ``n_parts / g`` partitions (memoized)."""
        g = self._mesh_sizes.get(n_devices)
        if g is None:
            n = self.n_parts
            g = max(d for d in range(1, n_devices + 1) if n % d == 0)
            self._mesh_sizes[n_devices] = g
        return g

    def mesh_devices(self, devices: Sequence[torch.device]) -> Mesh:
        """The partition mesh's entries (see :meth:`mesh_size`)."""
        return tuple(devices[:self.mesh_size(len(devices))])

    def stacked_plan_host(self) -> Tuple[np.ndarray, ...]:
        """All partitions' unpack plans stacked partition-major, as the
        four int32 arrays ``(first, pos, mind, packed)`` (the packed words
        as their int32 bit patterns).  Row ``k * pmax + j`` is partition
        ``k``'s plan row ``j``; zero rows pad shorter partitions."""
        pmax = self.pmax
        plans = [p.packed.unpack_plan() for p in self.parts]
        out = []
        for a_idx in range(4):  # (first, pos, mind, packed)
            ref = plans[0][a_idx]
            stack = np.zeros((self.n_parts * pmax,) + ref.shape[1:],
                             ref.dtype)
            for k, pl in enumerate(plans):
                stack[k * pmax: k * pmax + pl[a_idx].shape[0]] = pl[a_idx]
            out.append(stack.view(np.int32))
        return tuple(out)

    def device_plan_single(self, device) -> Tuple[Tuple[torch.Tensor, ...],
                                                  int]:
        """The stacked plan on one device: ``(arrays, pmax)``, placed once
        per device.  The single-shard tail runs the monolithic resident
        kernels over it with stacked page indices."""
        dev = torch.device(device)
        key = ("single", str(dev))
        plan = self._device_plans.get(key)
        if plan is None:
            plan = (tuple(torch.from_numpy(a).to(dev)
                          for a in self.stacked_plan_host()), self.pmax)
            self.device_transfers += 1
            if self.parts and self.parts[0].device is None:
                for p in self.parts:
                    p.device = dev
            self._device_plans[key] = plan
        return plan

    def device_plan(self, mesh: Mesh) -> Tuple[Tuple[torch.Tensor, ...],
                                               ...]:
        """Mesh entry ``i``'s block of the stacked plan -- the
        ``ppd * pmax`` rows of partitions ``[i * ppd, (i + 1) * ppd)`` --
        on ``mesh[i]``, one tuple of four tensors per entry, placed once
        per mesh.  A mesh that names one device only takes its blocks as
        row views of that device's single placement (the same bytes, no
        second copy); distinct devices each get their block's bytes.
        Records each partition's device."""
        mesh = tuple(torch.device(d) for d in mesh)
        key = ("mesh", tuple(str(d) for d in mesh))
        blocks = self._device_plans.get(key)
        if blocks is None:
            g = len(mesh)
            if self.n_parts % g:
                raise ValueError(f"a mesh of {g} entries does not divide "
                                 f"{self.n_parts} partitions")
            ppd = self.n_parts // g
            rows = ppd * self.pmax
            if len(set(key[1])) == 1:
                arrays, _ = self.device_plan_single(mesh[0])
                blocks = tuple(tuple(a[i * rows:(i + 1) * rows]
                                     for a in arrays) for i in range(g))
            else:
                host = self.stacked_plan_host()
                blocks = tuple(
                    tuple(torch.from_numpy(
                        np.ascontiguousarray(a[i * rows:(i + 1) * rows]))
                        .to(mesh[i]) for a in host) for i in range(g))
                self.device_transfers += 1
            for p in self.parts:
                p.device = mesh[p.index // ppd]
            self._device_plans[key] = blocks
        return blocks

    # -- observability ------------------------------------------------------
    def reset_stats(self) -> None:
        self.dispatches = 0
        self.partitions_pruned = 0
        self.stats_pruned = 0

    def stats(self) -> Dict[str, object]:
        return {
            "n_parts": self.n_parts,
            "dispatches": self.dispatches,
            "partitions_pruned": self.partitions_pruned,
            "stats_pruned": self.stats_pruned,
            "devices": sorted({str(p.device) for p in self.parts
                               if p.device is not None}),
            "transfers": self.device_transfers,
            "version": self.version,
        }


def partition_column(col: DeltaColumn, n_parts: int
                     ) -> "PartitionedColumn | None":
    """Partition ``col`` into ``n_parts`` page-aligned slices (cached).

    Sets the column's requested partition count and builds (or returns)
    the cached :class:`PartitionedColumn` for the current version.
    ``n_parts <= 1`` detaches the partition plane -- the monolithic path
    is the 1-partition case -- and returns None.
    """
    if n_parts <= 1:
        col.partitions = 0
        col.partition_cache = None
        return None
    col.partitions = int(n_parts)
    return live_partitions(col)


def ensure_default_partitions(col: DeltaColumn) -> None:
    """Attach the ``REPRO_PARTITIONS`` default to a column with no
    explicit partitioning (an explicit :func:`partition_column` wins)."""
    if DEFAULT_PARTITIONS > 1 and not getattr(col, "partitions", 0):
        partition_column(col, DEFAULT_PARTITIONS)


def live_partitions(col: DeltaColumn) -> "PartitionedColumn | None":
    """The column's partition plane, coherent with its current version.

    Rebuilds lazily after a version bump, as ``pack_column`` does.
    Returns None when partitioning is off.
    """
    n_parts = getattr(col, "partitions", 0)
    if n_parts <= 1:
        return None
    cached = col.partition_cache
    if cached is not None and cached.version == col.version \
            and cached.n_parts == n_parts:
        return cached
    n_pages = len(col.pages)
    bounds = partition_bounds(n_pages, n_parts)
    ps = col.page_size
    parts: List[Partition] = []
    for k in range(n_parts):
        p0, p1 = int(bounds[k]), int(bounds[k + 1])
        pages = col.pages[p0:p1]
        packed = build_packed(pages, ps, version=col.version)
        nonempty = [p for p in pages if p.count]
        vmin = min((p.vmin for p in nonempty), default=0)
        vmax = max((p.vmax for p in nonempty), default=-1)
        # a non-empty page with the empty-hull sentinel has unrecorded
        # statistics: the partition's hull is unknown
        known = all(p.vmax >= p.vmin for p in nonempty)
        row_hi = p1 * ps if p1 < n_pages else col.count
        parts.append(Partition(k, p0, p1, p0 * ps, row_hi, vmin, vmax,
                               packed, stats_known=known))
    col.partition_cache = PartitionedColumn(col, bounds, parts,
                                            version=col.version)
    return col.partition_cache
