"""Mutable graph plane: per-partition append-friendly delta segments.

The lake's packed columns are write-once; this module gives an
:class:`~repro_torch.core.edge.AdjacencyTable` a numpy-side **memtable**: one
row-group-sized :class:`DeltaSegment` per partition of the value column,
holding the edges ingested since the last compaction as sorted
``(key, value)`` arrays.  Batched retrieval unions a batch's delta
neighbors with the device-resident base at dispatch time; the background
compactor (:mod:`repro_torch.core.compaction`) merges the segments back into a
canonical packed layout and atomically swaps it in under the version
counter.

The JAX package's ``core/delta_segment.py``, on the port's storage plane:
a partitioned value column (:mod:`repro_torch.core.partition`) gives one
segment per partition, an unpartitioned one the single segment 0.

Design points:

* **Append-friendly, read-sorted.**  An ingest batch is merged into each
  touched segment's sorted order immediately (segments are row-group
  sized, so the re-sort is O(rows log rows) over a bounded array); every
  lookup is then a pair of ``searchsorted`` probes -- no per-read sort.
* **Zone maps maintained incrementally.**  Each segment tracks the
  min/max hull of its value ids, updated on every ingest; filtered
  retrieval prunes whole segments whose hull cannot intersect the
  predicate's qualifying range (the delta-side mirror of the partition
  plane's statistics pushdown), then exact-filters the survivors.
* **Crash-consistent ingest.**  A batch is staged fully before anything
  publishes; the ``ingest.append`` fault boundary sits between staging
  and publish, so an injected crash mid-append leaves the plane exactly
  as it was -- a retried batch can never half-apply or double-apply.
* **RAM-resident accounting.**  Delta reads charge no lake I/O (the
  memtable is the write buffer, not the lake -- the same convention the
  decoded-page LRU uses for hits).  The lake bytes are charged when the
  compactor rewrites the packed partitions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.ft import faults as ft_faults

from .edge import BY_SRC, AdjacencyTable
from .encoding import hull_intersects
from .labels import intervals_to_ids
from .partition import live_partitions
from .table import DeltaIntColumn


@dataclasses.dataclass
class DeltaSegment:
    """Sorted ``(key, value)`` edge rows pending for one partition."""

    index: int
    keys: np.ndarray   # int64 [n], lexicographically sorted by (key, val)
    vals: np.ndarray   # int64 [n]
    #: incremental zone map over ``vals`` (empty hull = (0, -1)).
    vmin: int = 0
    vmax: int = -1

    def __len__(self) -> int:
        return len(self.keys)

    def nbytes(self) -> int:
        return self.keys.nbytes + self.vals.nbytes


def _sorted_merge(keys: np.ndarray, vals: np.ndarray,
                  add_k: np.ndarray, add_v: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    k = np.concatenate([keys, add_k])
    v = np.concatenate([vals, add_v])
    order = np.lexsort((v, k))
    return k[order], v[order]


class DeltaSegments:
    """The mutable plane of one adjacency: partitioned delta segments.

    Attached via :func:`attach_delta`; the retrieval paths consult it
    through :func:`live_delta` (which reports None while the plane is
    drained, so the write-once fast paths -- including the fused
    traversal plan -- stay byte-for-byte untouched until the first
    ingest).
    """

    def __init__(self, adj: AdjacencyTable,
                 faults: "Optional[ft_faults.FaultPlan]" = None):
        if adj.offsets is None:
            raise ValueError("the mutable plane requires the sorted "
                             "<offset> layout (graphar/offset encodings)")
        col = adj.table[adj.value_col]
        extra = [n for n in adj.table.columns
                 if n not in ("<src>", "<dst>")]
        if extra:
            raise ValueError(f"ingest supports topology-only edge tables; "
                             f"{extra} have no delta representation yet")
        self.adj = adj
        #: compaction-pressure unit: a segment holding this many rows is
        #: one row group -- the column's page size, so a compacted
        #: segment fills whole pages.
        self.row_group_rows = int(col.page_size)
        self.faults = faults
        self.segments: Dict[int, DeltaSegment] = {}
        #: bumps on every published ingest batch and every compaction
        #: drain -- derived delta-side caches key on it.
        self.version = 0
        self.ingests = 0
        self.ingested_rows = 0
        self.lookups = 0
        self.segments_pruned = 0
        self.compactions = 0
        self._flat: "Optional[Tuple]" = None  # (version, ids, base, K, V)

    # -- geometry ----------------------------------------------------------

    def _part_of_keys(self, keys: np.ndarray) -> np.ndarray:
        """Owning segment of each key vertex: the partition holding the
        first base edge row of that key (partitions are page-aligned over
        the value column, immutable between compactions).  Unpartitioned
        columns use the single segment 0."""
        col = self.adj.table[self.adj.value_col]
        parts = live_partitions(col.encoded) \
            if isinstance(col, DeltaIntColumn) else None
        if parts is None:
            return np.zeros(len(keys), np.int64)
        off = self.adj.offsets["<offset>"].values
        pages = off[keys] // col.page_size
        return parts.part_of_pages(np.minimum(
            pages, parts.bounds[-1] - 1).astype(np.int64))

    # -- writes ------------------------------------------------------------

    def ingest(self, src, dst) -> int:
        """Append a batch of edges; returns rows ingested.

        All-or-nothing: the batch is staged against every touched
        segment first, the ``ingest.append`` fault boundary fires before
        anything publishes, and only then do the staged segments replace
        the live ones (plus one version bump).  An injected crash leaves
        the plane untouched, so the caller's retry is exact.
        """
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError("src/dst must be equal-length 1-D arrays")
        if src.size == 0:
            return 0
        adj = self.adj
        keys, vals = (src, dst) if adj.order == BY_SRC else (dst, src)
        if keys.min() < 0 or keys.max() >= adj.num_key_vertices:
            raise ValueError("ingest names unknown key vertices (vertex "
                             "ingest is a separate plane)")
        if vals.min() < 0 or (adj.num_value_vertices is not None
                              and vals.max() >= adj.num_value_vertices):
            raise ValueError("ingest names unknown value vertices")
        owner = self._part_of_keys(keys)
        staged: List[DeltaSegment] = []
        for p in np.unique(owner):
            m = owner == p
            kp, vp = keys[m], vals[m]
            seg = self.segments.get(int(p))
            if seg is None:
                order = np.lexsort((vp, kp))
                k2, v2 = kp[order], vp[order]
                vmin, vmax = int(vp.min()), int(vp.max())
            else:
                k2, v2 = _sorted_merge(seg.keys, seg.vals, kp, vp)
                vmin = min(seg.vmin, int(vp.min())) if len(seg) \
                    else int(vp.min())
                vmax = max(seg.vmax, int(vp.max())) if len(seg) \
                    else int(vp.max())
            staged.append(DeltaSegment(int(p), k2, v2, vmin, vmax))
        # crash point: everything above is scratch state -- a fault here
        # (or anywhere earlier) publishes nothing
        ft_faults.check(self.faults, "ingest.append")
        for seg in staged:
            self.segments[seg.index] = seg
        self.ingests += 1
        self.ingested_rows += int(src.size)
        self.version += 1
        self._flat = None
        return int(src.size)

    # -- reads -------------------------------------------------------------

    def pending_rows(self) -> int:
        return sum(len(s) for s in self.segments.values())

    def nbytes(self) -> int:
        return sum(s.nbytes() for s in self.segments.values())

    def _flat_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
        """(segment ids, segment base offsets, flat keys, flat vals) --
        one concatenation per plane version, shared by every lookup."""
        if self._flat is not None and self._flat[0] == self.version:
            return self._flat[1:]
        ids = np.asarray(sorted(self.segments), np.int64)
        sizes = np.asarray([len(self.segments[int(p)]) for p in ids],
                           np.int64)
        base = np.zeros(len(ids) + 1, np.int64)
        np.cumsum(sizes, out=base[1:])
        if len(ids):
            K = np.concatenate([self.segments[int(p)].keys for p in ids])
            V = np.concatenate([self.segments[int(p)].vals for p in ids])
        else:
            K = V = np.zeros(0, np.int64)
        self._flat = (self.version, ids, base, K, V)
        return ids, base, K, V

    def lookup_batch(self, vs) -> Tuple[np.ndarray, np.ndarray]:
        """Per-vertex pending neighbor lists, in ``vs`` order.

        Returns ``(vals, lengths)`` -- the concatenation of each vertex's
        sorted delta values (multiplicity preserved) plus per-vertex
        lengths, mirroring the shape contract of the base plane's
        multi-range decode.  RAM-resident: charges no lake I/O.
        """
        vs = np.asarray(vs, np.int64)
        self.lookups += 1
        if vs.size == 0 or not self.segments:
            return np.zeros(0, np.int64), np.zeros(len(vs), np.int64)
        ids, base, K, V = self._flat_arrays()
        owner = self._part_of_keys(vs)
        seg_of = np.searchsorted(ids, owner)
        # vertices owned by a partition with no pending segment probe an
        # empty range (searchsorted may point at another segment's slot;
        # the equality mask voids it)
        seg_of = np.minimum(seg_of, len(ids) - 1)
        live = ids[seg_of] == owner
        lo = np.zeros(len(vs), np.int64)
        hi = np.zeros(len(vs), np.int64)
        for si in np.unique(seg_of[live]):
            m = live & (seg_of == si)
            b, e = base[si], base[si + 1]
            lo[m] = b + np.searchsorted(K[b:e], vs[m], "left")
            hi[m] = b + np.searchsorted(K[b:e], vs[m], "right")
        vals = V[intervals_to_ids((lo, hi))]
        return vals, hi - lo

    def unique_ids(self, vs, qual: Optional[Tuple[int, int]] = None
                   ) -> np.ndarray:
        """Sorted unique pending neighbor ids of the batch.

        ``qual`` -- a predicate's half-open qualifying ``[lo, hi)`` id
        hull (see ``LabelFilter.qual_range``) -- prunes whole segments
        whose zone map cannot intersect it (the shared
        :func:`repro_torch.core.encoding.hull_intersects`, same predicate as
        partition and page pruning); surviving ids still need the
        caller's exact filter.  Pruning is counted in
        ``segments_pruned``.
        """
        vs = np.asarray(vs, np.int64)
        self.lookups += 1
        if vs.size == 0 or not self.segments:
            return np.zeros(0, np.int64)
        out: List[np.ndarray] = []
        owner = self._part_of_keys(vs)
        for p, seg in self.segments.items():
            if qual is not None and not hull_intersects(
                    seg.vmin, seg.vmax, qual[0], qual[1]):
                self.segments_pruned += 1
                continue
            sel = vs[owner == p]
            if sel.size == 0:
                continue
            lo = np.searchsorted(seg.keys, sel, "left")
            hi = np.searchsorted(seg.keys, sel, "right")
            out.append(seg.vals[intervals_to_ids((lo, hi))])
        if not out:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(out))

    # -- compactor interface ----------------------------------------------

    def snapshot(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """Frozen copy of every segment's rows (the compaction input).
        Serving keeps ingesting into the live segments meanwhile."""
        return {p: (s.keys.copy(), s.vals.copy())
                for p, s in self.segments.items() if len(s)}

    def drop_rows(self, frozen: Dict[int, Tuple[np.ndarray, np.ndarray]]
                  ) -> None:
        """Remove exactly the snapshotted rows (multiset difference per
        segment) -- rows ingested after the snapshot survive, already in
        sorted order, and keep serving from the delta path."""
        for p, (fk, fv) in frozen.items():
            seg = self.segments.get(p)
            if seg is None:
                continue
            lim = max(int(seg.vals.max()), int(fv.max())) + 1 \
                if len(seg) else 1
            cur = seg.keys * lim + seg.vals
            sub = fk * lim + fv
            uc, cc = np.unique(cur, return_counts=True)
            uf, cf = np.unique(sub, return_counts=True)
            pos = np.searchsorted(uc, uf)
            if (pos >= len(uc)).any() or (uc[pos] != uf).any():
                raise ValueError("snapshot rows missing from live segment"
                                 " (snapshot/drop mismatch)")
            cc[pos] -= cf
            if (cc < 0).any():
                raise ValueError("snapshot holds more copies than live "
                                 "segment (snapshot/drop mismatch)")
            kept = np.repeat(uc, cc)
            if kept.size == 0:
                del self.segments[p]
                continue
            k2, v2 = kept // lim, kept % lim
            self.segments[p] = DeltaSegment(
                p, k2, v2, int(v2.min()), int(v2.max()))
        self.compactions += 1
        self.version += 1
        self._flat = None

    def stats(self) -> Dict[str, object]:
        return {"segments": len(self.segments),
                "pending_rows": self.pending_rows(),
                "row_group_rows": self.row_group_rows,
                "ingests": self.ingests,
                "ingested_rows": self.ingested_rows,
                "lookups": self.lookups,
                "segments_pruned": self.segments_pruned,
                "compactions": self.compactions,
                "version": self.version}

    def __repr__(self) -> str:
        return (f"DeltaSegments(segments={len(self.segments)}, "
                f"pending={self.pending_rows()}, v{self.version})")


# --------------------------------------------------------------------------
# attachment + plane-wide helpers
# --------------------------------------------------------------------------

def attach_delta(adj: AdjacencyTable, faults=None) -> DeltaSegments:
    """Attach (or return the attached) mutable plane of an adjacency."""
    if adj.delta is None:
        adj.delta = DeltaSegments(adj, faults)
    return adj.delta


def live_delta(adj: AdjacencyTable) -> Optional[DeltaSegments]:
    """The adjacency's mutable plane iff it has pending rows -- the hot
    paths' single branch: None keeps the write-once code byte-identical
    (fused traversal plans, zero-retrace steady state) until the next
    ingest."""
    d = adj.delta
    if d is not None and d.segments:
        return d
    return None


def ingest_edges(adj: AdjacencyTable, src, dst) -> int:
    """Convenience: attach-if-needed + ingest one batch of (src, dst)."""
    return attach_delta(adj).ingest(src, dst)


def merge_rows(ids: np.ndarray, lengths: np.ndarray, dvals: np.ndarray,
               dlens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-vertex sorted merge of base rows (``ids`` in runs of
    ``lengths``) with pending rows (``dvals`` in runs of ``dlens``, as
    :meth:`DeltaSegments.lookup_batch` gives them): the concatenated
    merged lists, multiplicity kept, and each vertex's merged length --
    the per-vertex lists a rebuilt layout would decode."""
    seg = np.concatenate([np.repeat(np.arange(lengths.size), lengths),
                          np.repeat(np.arange(dlens.size), dlens)])
    allv = np.concatenate([ids, dvals])
    return allv[np.lexsort((allv, seg))], lengths + dlens


def base_edges(adj: AdjacencyTable) -> Tuple[np.ndarray, np.ndarray]:
    """The packed base's (src, dst) edge list (physical row order)."""
    src = np.asarray(adj.table["<src>"].read_all(), np.int64)
    dst = np.asarray(adj.table["<dst>"].read_all(), np.int64)
    return src, dst


def all_edges(adj: AdjacencyTable) -> Tuple[np.ndarray, np.ndarray]:
    """Base + pending delta edges -- the edge list a from-scratch rebuild
    (and the compactor) starts from."""
    src, dst = base_edges(adj)
    d = adj.delta
    if d is None or not d.segments:
        return src, dst
    ks = [s.keys for s in d.segments.values()]
    vs = [s.vals for s in d.segments.values()]
    dk = np.concatenate(ks)
    dv = np.concatenate(vs)
    dsrc, ddst = (dk, dv) if adj.order == BY_SRC else (dv, dk)
    return np.concatenate([src, dsrc]), np.concatenate([dst, ddst])
