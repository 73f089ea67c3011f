"""Batched RAG context retrieval from a GraphAr lake.

The serving engine admits several requests per tick; each may name a seed
vertex whose neighborhood provides context passages.  A
:class:`GraphRetriever` turns the whole admitted batch into **one** batched
neighbor retrieval (vectorized offsets gather + page-deduplicated decode)
plus one batched token fetch -- the per-tick unit of work of the batched
retrieval plane, instead of a per-request Python loop over the lake.

Two cross-tick layers ride on top:

* a **decoded-page LRU** on the adjacency value column
  (:mod:`repro_torch.core.page_cache`): serving re-touches the same hot
  pages tick after tick, so every decode after the first consults the
  cache and IOMeter-charges only the miss pages;
* the token fetch reads each **unique** neighbor once and fans the lists
  back out per request, so pages shared between requests are charged
  once.

The JAX package's ``serve/retrieval.py`` on the port's decode, filter,
traversal and mutable-plane entries: :meth:`GraphRetriever.ingest` lands
edges in the adjacency's delta segments, served from the next call on.
``partitions=`` partitions the adjacency's value column
(:mod:`repro_torch.core.partition`), and ``stats()`` reports the
partition plane's counters.  The engine defaults to ``cuda``, the port's rule, and raises without a card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.delta_segment import attach_delta, live_delta, merge_rows
from repro_torch.core.edge import AdjacencyTable
from repro_torch.core.labels import Cond, LabelFilter
from repro_torch.core.neighbor import decode_edge_ranges, k_hop
from repro_torch.core.page_cache import DecodedPageCache, attach_page_cache
from repro_torch.core.partition import live_partitions, partition_column
from repro_torch.core.table import DeltaIntColumn, TokensColumn
from repro_torch.kernels.traversal.ops import traversal_stats


class GraphRetriever:
    """Callable ``vs -> per-request context token arrays``.

    Per call (= per engine tick): one vectorized offsets gather over all
    seed vertices, one multi-range decode of the adjacency value column
    (cache-miss pages only, once the LRU is warm), one batched read of the
    unique neighbors' token lists, then a cheap per-request assembly.

    Label-scoped retrieval: with ``filter_cond`` (a label
    :class:`~repro_torch.core.labels.Cond` over ``filter_vt``, the
    value-side vertex table) only neighbors satisfying the predicate
    contribute context.  The predicate's whole-table bitmap is evaluated on
    the configured engine at first use and cached across ticks (the
    metadata I/O is charged once), and each tick's decoded neighbors are
    masked by a vectorized bitmap probe.  ``stats()`` reports
    considered/kept counters.
    """

    def __init__(self, adj: AdjacencyTable, tokens_col: TokensColumn,
                 max_neighbors: int = 2, tokens_per_neighbor: int = 16,
                 meter=None, engine: str = "cuda",
                 page_cache_pages: Optional[int] = 256,
                 filter_vt=None, filter_cond: Optional[Cond] = None,
                 partitions: Optional[int] = None,
                 hops: int = 1):
        self.adj = adj
        self.tokens_col = tokens_col
        self.max_neighbors = max_neighbors
        self.tokens_per_neighbor = tokens_per_neighbor
        self.meter = meter
        self.engine = engine
        # deep context: with hops > 1 each tick also runs ONE k-hop
        # traversal over the whole admitted batch (fused on the kernel
        # engines), and requests with spare neighbor slots draw from that
        # shared deep pool
        self.hops = int(hops)
        self.deep_pool_last = 0  # deep-context pool size of the last tick
        self.calls = 0          # batched retrievals issued (one per tick)
        self.vertices_seen = 0  # requests served across all calls
        self.ingest_calls = 0   # ingest() batches accepted
        self.ingest_rows = 0    # edges ingested across all batches
        self.knob_changes = 0   # overload-ladder knob turns (set_knob)
        if filter_cond is not None and filter_vt is None:
            raise ValueError("filter_cond requires filter_vt (the "
                             "value-side vertex table)")
        self.label_filter = (LabelFilter(filter_vt, filter_cond)
                             if filter_cond is not None else None)
        self._filter_charged = False
        self.filter_considered = 0  # neighbors decoded while filtering
        self.filter_kept = 0        # neighbors that passed the predicate
        col = adj.table[adj.value_col]
        self._cache_col = col if isinstance(col, DeltaIntColumn) else None
        if self._cache_col is not None:
            if partitions is not None:
                # explicit partition count for the value column: every
                # decode this retriever issues runs through the partition
                # plane (None keeps what is attached, or the
                # REPRO_PARTITIONS default)
                partition_column(self._cache_col.encoded, partitions)
            if page_cache_pages is not None:
                attach_page_cache(self._cache_col, page_cache_pages)
            else:
                # explicit opt-out detaches: the decode paths consult the
                # column's cache, so leaving one attached would silently
                # keep serving (and under-charging) from it
                self._cache_col.encoded.page_cache = None

    @property
    def page_cache(self) -> Optional[DecodedPageCache]:
        """The cache the decode paths actually consult *now* -- read from
        the column so a later re-attach (e.g. with another capacity)
        doesn't leave stats() reporting a detached object's counters."""
        if self._cache_col is None:
            return None
        return self._cache_col.encoded.page_cache

    def __call__(self, vs: np.ndarray) -> List[np.ndarray]:
        vs = np.asarray(vs, np.int64)
        self.calls += 1
        self.vertices_seen += int(vs.size)
        if vs.size == 0:
            return []
        los, his = self.adj.edge_ranges_batch(vs, self.meter)
        his = np.minimum(his, los + self.max_neighbors)
        nbrs = decode_edge_ranges(self.adj, los, his, self.meter,
                                  self.engine)
        lengths = np.maximum(his - los, 0)
        delta = live_delta(self.adj)
        if delta is not None:
            # mutable plane: merge each request's pending delta neighbors
            # into its (sorted) base list, then keep the first
            # ``max_neighbors`` of the merge -- correct because the first
            # k of a merge of sorted lists draws only from the first k of
            # each input, and the base list is already clamped to k above
            dvals, dlens = delta.lookup_batch(vs)
            if dvals.size:
                allv, counts = merge_rows(nbrs, lengths, dvals, dlens)
                starts = np.concatenate(
                    [[0], np.cumsum(counts)[:-1]]).astype(np.int64)
                within = np.arange(allv.size) - np.repeat(starts, counts)
                nbrs = allv[within < self.max_neighbors]
                lengths = np.minimum(counts, self.max_neighbors)
        if self.label_filter is not None and nbrs.size:
            if not self._filter_charged:
                # charged once: the bitmap is evaluated at first use and
                # cached across ticks (miss-only convention, like the LRU)
                self.label_filter.charge(self.meter)
                self._filter_charged = True
            keep = self.label_filter.mask_ids(nbrs, self.engine)
            self.filter_considered += int(nbrs.size)
            self.filter_kept += int(keep.sum())
            seg = np.repeat(np.arange(lengths.size), lengths)
            nbrs = nbrs[keep]
            lengths = np.bincount(seg[keep], minlength=lengths.size)
        if self.hops > 1:
            # one fused k-hop over the whole tick's seeds; the per-hop
            # label predicate keeps the pool inside the filtered scope
            pool = k_hop(self.adj, vs, self.hops, self.meter, self.engine,
                         include_seeds=False, filter=self.label_filter)
            self.deep_pool_last = int(pool.size)
            if pool.size:
                seg = np.repeat(np.arange(lengths.size), lengths)
                per = [nbrs[seg == i] for i in range(lengths.size)]
                for i, own in enumerate(per):
                    need = self.max_neighbors - own.size
                    if need > 0:
                        per[i] = np.concatenate(
                            [own, pool[~np.isin(pool, own)][:need]])
                lengths = np.asarray([p.size for p in per], np.int64)
                nbrs = np.concatenate(per) if per \
                    else np.zeros(0, np.int64)
        if nbrs.size:
            # fetch each unique neighbor's tokens once for the whole tick
            uniq, inv = np.unique(nbrs, return_inverse=True)
            uniq_lists = self.tokens_col.read_rows(uniq, self.meter)
            token_lists = [uniq_lists[i] for i in inv]
        else:
            token_lists = []
        out: List[np.ndarray] = []
        pos = 0
        for k in lengths:
            parts = [np.asarray(t[:self.tokens_per_neighbor], np.int32)
                     for t in token_lists[pos:pos + int(k)]]
            pos += int(k)
            out.append(np.concatenate(parts) if parts
                       else np.zeros(0, np.int32))
        return out

    # -- overload degradation knobs -------------------------------------------
    #: knobs the overload controller may turn: each trades context
    #: quality for tick latency and is fully reversible (the controller
    #: saves and restores the old value)
    DEGRADABLE = ("hops", "max_neighbors")

    def set_knob(self, name: str, value: int) -> int:
        """Set a degradation knob, returning the previous value.  Only
        the knobs in :data:`DEGRADABLE` are legal -- the controller must
        not be able to silently mutate arbitrary retrieval state."""
        if name not in self.DEGRADABLE:
            raise ValueError(f"not a degradable knob: {name!r} "
                             f"(want one of {self.DEGRADABLE})")
        old = int(getattr(self, name))
        value = int(value)
        if value < 1:
            raise ValueError(f"{name} must stay >= 1 (got {value})")
        setattr(self, name, value)
        if value != old:
            self.knob_changes += 1
        return old

    # -- speculative prefetch support (pipelined serving) ---------------------
    def snapshot(self) -> Dict[str, object]:
        """Point-in-time state of everything a retrieval call mutates:
        the IOMeter, the decoded-page LRU (contents *and* recency order),
        and this retriever's counters.  The pipelined engine snapshots
        before every speculative prefetch; a mis-speculation restores and
        replays the synchronous path, so meter and cache evolve exactly
        as the sequential engine's would."""
        state: Dict[str, object] = {
            "calls": self.calls, "vertices_seen": self.vertices_seen,
            "filter_considered": self.filter_considered,
            "filter_kept": self.filter_kept,
            "filter_charged": self._filter_charged,
            "deep_pool_last": self.deep_pool_last,
        }
        if self.meter is not None:
            state["meter"] = (self.meter.nbytes, self.meter.nrequests)
        cache = self.page_cache
        if cache is not None:
            state["cache"] = cache.snapshot()
        return state

    def restore(self, state: Dict[str, object]) -> None:
        """Rewind to a :meth:`snapshot` (undo one speculative call)."""
        self.calls = state["calls"]
        self.vertices_seen = state["vertices_seen"]
        self.filter_considered = state["filter_considered"]
        self.filter_kept = state["filter_kept"]
        self._filter_charged = state["filter_charged"]
        self.deep_pool_last = state["deep_pool_last"]
        if self.meter is not None and "meter" in state:
            self.meter.nbytes, self.meter.nrequests = state["meter"]
        cache = self.page_cache
        if cache is not None and "cache" in state:
            cache.restore(state["cache"])

    def mutation_epoch(self) -> Tuple[int, int, int]:
        """Graph-state fingerprint a prefetched retrieval is only valid
        under: the adjacency column's write version, the mutable plane's
        pending row count, and the ingests routed through this retriever.
        Any movement between prefetch and consumption means the
        speculative contexts could be stale -- the engine falls back."""
        version = (self._cache_col.encoded.version
                   if self._cache_col is not None else 0)
        delta = live_delta(self.adj)
        pending = delta.pending_rows() if delta is not None else 0
        return (version, pending, self.ingest_calls)

    def ingest(self, src, dst):
        """Ingest an edge batch into the adjacency's mutable plane.

        Edges land in the delta segments (RAM-resident memtable) and are
        served from the very next tick, unioned with the packed base at
        dispatch time; a later compaction folds them into new packed
        pages without interrupting serving.  Returns the
        :class:`~repro_torch.core.delta_segment.DeltaSegments` plane.
        """
        delta = attach_delta(self.adj)
        delta.ingest(src, dst)
        self.ingest_calls += 1
        self.ingest_rows += int(np.asarray(src).size)
        return delta

    def stats(self) -> Dict[str, object]:
        """Per-tick batching + decoded-page cache + device-mirror
        counters (for ``ServeEngine.stats()``)."""
        s: Dict[str, object] = {"calls": self.calls,
                                "vertices_seen": self.vertices_seen}
        if self.knob_changes:
            # overload ladder engaged at least once: current knob values
            s["knobs"] = {"hops": self.hops,
                          "max_neighbors": self.max_neighbors,
                          "changes": self.knob_changes}
        if self.page_cache is not None:
            s["page_cache"] = self.page_cache.stats()
        delta = getattr(self.adj, "delta", None)
        if delta is not None:
            # mutable plane: pending rows, zone-map pruning, compactions
            mut = dict(delta.stats())
            mut["ingest_calls"] = self.ingest_calls
            mut["ingest_rows"] = self.ingest_rows
            s["mutable"] = mut
        if self._cache_col is not None:
            packed = self._cache_col.encoded.packed_cache
            if packed is not None and packed.device_transfers:
                # one transfer per device across ticks: the packed column
                # crosses to the device once per version, not once per
                # dispatch (kernel engines only)
                s["device_mirror"] = packed.device_stats()
            parts = live_partitions(self._cache_col.encoded)
            if parts is not None:
                # partition plane: partition count, dispatches, pruning
                # (partitions_pruned counts partitions skipped because
                # their range or statistics hull missed the batch)
                s["partitions"] = parts.stats()
        if self.label_filter is not None:
            s["filter"] = {"cond": repr(self.label_filter.cond),
                           "considered": self.filter_considered,
                           "kept": self.filter_kept}
        pruning = self._pruning_stats()
        if pruning is not None:
            s["pruning"] = pruning
        trav = traversal_stats(self.adj)
        if trav is not None:
            # traversal plane: fused dispatches, hops folded into them,
            # host round-trips, and the last dispatch's per-hop frontier
            # sizes
            trav["hops"] = self.hops
            trav["deep_pool_last"] = self.deep_pool_last
            s["traversal"] = trav
        return s

    def _pruning_stats(self) -> "Dict[str, object] | None":
        """The statistics pushdown's three granularities in one section:
        partition hulls that skipped whole partitions
        (``partitions_stats_pruned``), page zone maps that dropped pages
        before staging (``pages_*`` / ``io_saved_bytes``), and the mutable
        plane's segment zone maps that skipped pending-row segments
        (``delta_segments_pruned``).  ``None`` until a predicate pushes
        down."""
        if self._cache_col is None:
            return None
        out: Dict[str, object] = \
            dict(self._cache_col.encoded.prune_stats.as_dict())
        parts = live_partitions(self._cache_col.encoded)
        out["partitions_stats_pruned"] = \
            parts.stats_pruned if parts is not None else 0
        delta = getattr(self.adj, "delta", None)
        out["delta_segments_pruned"] = \
            delta.segments_pruned if delta is not None else 0
        if not any(out.values()):
            return None
        return out
