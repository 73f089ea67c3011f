"""Dispatch layer of the fused traversal plane.

A :class:`TraversalPlan` is the adjacency's device-resident expansion
structure: the whole edge value column decoded **once** through the
resident unpack plan (``pac_decode._decode_page_matrix`` -- on ``cuda``
the ``gather_decode`` kernel; on a partitioned column the partitioned
decode, so the plan build is a partition-plane dispatch), re-ordered so
edge rows group by value id (``key_sorted`` + the segment index
``voff``, see :func:`repro_torch.kernels.traversal.ref.expand_counts`).
The plan crosses to each device once per (column version, partition
count); traversal dispatches then ship only padded seed-id vectors, and
the per-hop predicate words come from each filter's resident plane
(``FilterPlan.device_bitmap``).

``k_hop_fused`` queues its k hops on the stream with no synchronisation
between them; with a partition plane attached and a mesh wide enough
(``_shard_width``) it takes the multi-device tail
(:func:`repro_torch.kernels.shard.sharded_khop`: one rank layout per mesh
entry, ``TraversalPlan.sharded_arrays``).  ``two_hop_pac`` (IC-8's
heterogeneous chain) and ``frontier_edge_counts`` (BI-2's counting
expansion) reuse the same plans.

Accounting: the host loop (``core.neighbor.k_hop`` with ``fused=False``)
is the bit-identical oracle.  When a meter or a decoded-page LRU is
attached, the fused path **replays** the oracle's I/O after its dispatch
-- per hop: predicate metadata charge, offsets gather, LRU split,
miss-page charge, cache backfill from the plan's host decode -- so meters
and cache evolution match the oracle exactly; with neither attached,
nothing but the final visited plane and the per-hop sizes cross back to
the host, in one copy.

Mutable plane: every plan covers the packed base only.  While delta rows
are pending, or the column's device mirror is poisoned, ``k_hop_fused``
degrades to the host loop (counted as ``fallbacks``); ``two_hop_pac``
and ``frontier_edge_counts`` read the base only, as the reference's do,
until a compaction folds the rows in.
A compaction bumps the column version, so the next call builds a new
plan; building it frees the tensors and host arrays of every plan of an
older version (the reference keeps them), which keeps their counters, so
:func:`traversal_stats` still equals the reference's.  A plan of the same
version for another partition count stays: switching counts back and
forth reuses both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import neighbor
from repro_torch.core.encoding import DeltaColumn, prune_page_list
from repro_torch.core.frontier import Frontier
from repro_torch.core.pac import PAC
from repro_torch.core.page_cache import live_cache
from repro_torch.core.partition import live_partitions
from repro_torch.core.table import DeltaIntColumn
from repro_torch.kernels._pad import size_class
from repro_torch.kernels.pac_decode import ops as pac_ops

from . import kernel as K

#: pow2 floor for the padded seed-id vector (same role as
#: ``pac_ops.RANGE_CLASS_MIN``: steady-state traversals with small,
#: varying seed batches share one size class).
SEED_CLASS_MIN = 64

#: pow2 floor for BI-2's padded interval vectors.
INTERVAL_CLASS_MIN = 8


def plan_supported(adj) -> bool:
    """Whether the fused traversal plane can serve this adjacency."""
    return (adj.offsets is not None
            and adj.num_value_vertices is not None
            and isinstance(adj.table[adj.value_col], DeltaIntColumn))


@dataclasses.dataclass
class TraversalPlan:
    """Device-resident expansion structure of one adjacency."""

    col: DeltaColumn
    n_key: int
    n_value: int
    host_vals: np.ndarray       # int64 [rows] -- decoded value column
    key_sorted: np.ndarray      # int32 [rows_pad] -- keys grouped by value
    voff: np.ndarray            # int32 [n_value+1] -- value segments
    offsets: np.ndarray         # int64 [n_key+1] -- the <offset> index
    #: device -> (key_sorted, voff) int32 tensors on that device.
    _device: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=dict, repr=False, compare=False)
    #: (partition version, n_parts, mesh) -> one (key_sorted, voff) per
    #: mesh entry, on its device.
    _sharded: Dict[Tuple, Tuple] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    device_transfers: int = 0
    # -- traversal counters (surfaced via traversal_stats) ------------------
    dispatches: int = 0
    hops_fused: int = 0
    device_roundtrips: int = 0
    last_frontier_sizes: "np.ndarray | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def rows(self) -> int:
        return len(self.host_vals)

    def device(self, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        key = str(torch.device(device))
        plan = self._device.get(key)
        if plan is None:
            plan = (torch.from_numpy(self.key_sorted).to(key),
                    torch.from_numpy(self.voff).to(key))
            self._device[key] = plan
            self.device_transfers += 1
        return plan

    def sharded_arrays(self, parts, mesh) -> Tuple[Tuple[torch.Tensor,
                                                          torch.Tensor], ...]:
        """One rank layout per mesh entry, on its device: ``(key_sorted,
        voff)`` over all rows of the entry's partitions (a contiguous row
        range) and the whole value space, so an entry holding several
        partitions still takes one expansion a hop.  Keys come from the
        ``<offset>`` index; padding keys ``n_key`` select nothing.  The
        rows are ordered by a stable sort on the entry's device (the
        whole-column plan's order restricted to the entry's rows).  Built
        once per (partition version, partition count, mesh).  (The
        reference stacks one layout per partition, which its expansion
        cannot read when an entry holds more than one.)"""
        key = (parts.version, parts.n_parts, tuple(str(d) for d in mesh))
        cached = self._sharded.get(key)
        if cached is None:
            ppd = parts.n_parts // len(mesh)
            layouts = []
            for i, dev in enumerate(mesh):
                lo = min(parts.parts[i * ppd].row_lo, self.rows)
                hi = min(max(parts.parts[(i + 1) * ppd - 1].row_hi, lo),
                         self.rows)
                vals = torch.from_numpy(self.host_vals[lo:hi]).to(dev)
                keys = torch.from_numpy(np.repeat(
                    np.arange(self.n_key, dtype=np.int32),
                    np.diff(np.clip(self.offsets, lo, hi)))).to(dev)
                order = torch.sort(vals, stable=True).indices
                ks = torch.full((-(-(hi - lo) // 32) * 32,), self.n_key,
                                dtype=torch.int32, device=dev)
                ks[:hi - lo] = keys[order]
                voff = torch.zeros(self.n_value + 1, dtype=torch.int32,
                                   device=dev)
                voff[1:] = torch.cumsum(torch.bincount(
                    vals, minlength=self.n_value), 0)
                layouts.append((ks, voff))
            cached = tuple(layouts)
            self._sharded[key] = cached
            self.device_transfers += 1
        return cached

    def release(self) -> None:
        """Free the device tensors and host arrays of a stale plan, keeping
        its counters for :func:`traversal_stats`."""
        self._device.clear()
        self._sharded.clear()
        empty = np.zeros(0, np.int32)
        self.host_vals = self.key_sorted = self.voff = self.offsets = empty


def traversal_plan(adj, engine: str) -> TraversalPlan:
    """The adjacency's plan, built once per (column version, partition
    count) -- a version bump or a new count builds another; the build's
    whole-column decode runs on ``engine``.  Building a plan first
    releases every plan of an older version (see
    :meth:`TraversalPlan.release`): the version only moves forward, so no
    caller asks for one again.  Plans of the current version for other
    partition counts stay."""
    col = neighbor._kernel_column(adj)
    key = (col.version, getattr(col, "partitions", 0) or 0)
    plans = getattr(adj, "_traversal_plans", None)
    if plans is None:
        plans = {}
        adj._traversal_plans = plans
    plan = plans.get(key)
    if plan is None:
        for (version, _), stale in plans.items():
            if version < col.version:
                stale.release()
        n_pages = len(col.pages)
        mat = pac_ops._decode_page_matrix(col, list(range(n_pages)), engine)
        counts = np.asarray([p.count for p in col.pages], np.int64)
        mask = np.arange(col.page_size)[None, :] < counts[:, None]
        host_vals = mat[mask]
        del mat
        off = np.asarray(adj.offsets["<offset>"].values, np.int64)
        if int(off[-1]) != len(host_vals):
            raise ValueError("offset index disagrees with value column "
                             f"({int(off[-1])} vs {len(host_vals)} rows)")
        n_key = int(adj.num_key_vertices)
        n_value = int(adj.num_value_vertices)
        # a plan of this version for another partition count decoded the
        # same values: its layout is this one's, so the sort is skipped
        sibling = next((p for (v, _), p in plans.items()
                        if v == col.version and p.rows
                        and np.array_equal(p.host_vals, host_vals)), None)
        if sibling is not None:
            key_sorted, voff = sibling.key_sorted, sibling.voff
        else:
            # the expansion layout: rows grouped by value id, padded to a
            # word multiple with keys that select nothing
            key_of_row = np.repeat(np.arange(n_key, dtype=np.int32),
                                   np.diff(off))
            order = np.argsort(host_vals, kind="stable")
            key_sorted = np.full(-(-len(host_vals) // 32) * 32, n_key,
                                 np.int32)
            key_sorted[:len(host_vals)] = key_of_row[order]
            del key_of_row, order
            voff = np.zeros(n_value + 1, np.int32)
            voff[1:] = np.cumsum(np.bincount(host_vals, minlength=n_value))
        plan = TraversalPlan(col, n_key, n_value, host_vals, key_sorted,
                             voff, off)
        plans[key] = plan
    return plan


def traversal_stats(adj) -> "Dict[str, object] | None":
    """Aggregated traversal counters across the adjacency's live plans,
    plus the host-loop fallbacks counted by
    :func:`note_traversal_fallback`."""
    plans = getattr(adj, "_traversal_plans", None)
    fallbacks = getattr(adj, "_traversal_fallbacks", 0)
    if not plans and not fallbacks:
        return None
    plans = plans or {}
    out = {"dispatches": sum(p.dispatches for p in plans.values()),
           "hops_fused": sum(p.hops_fused for p in plans.values()),
           "device_transfers": sum(p.device_transfers
                                   for p in plans.values()),
           "traversal_device_roundtrips": sum(p.device_roundtrips
                                              for p in plans.values()),
           "fallbacks": fallbacks}
    last = [p.last_frontier_sizes for p in plans.values()
            if p.last_frontier_sizes is not None]
    if last:
        out["frontier_sizes"] = [int(x) for x in last[-1]]
    return out


def _filter_words(filts: Sequence, hops: int, n_words: int, n: int,
                  device: torch.device) -> torch.Tensor:
    """Per-hop predicate words int32[hops, n_words] on ``device``
    (all-ones rows where unfiltered): each filter's resident plane, so no
    predicate crosses back to the host."""
    rows = []
    for h in range(hops):
        f = filts[h]
        if f is None:
            rows.append(torch.full((n_words,), -1, dtype=torch.int32,
                                   device=device))
            continue
        if f.vt.num_vertices != n:
            raise ValueError(
                f"hop-{h} filter covers {f.vt.num_vertices} vertices "
                f"but the traversal id space has {n}")
        rows.append(f.plan().device_bitmap(device, n_words))
    return torch.stack(rows)


def _seed_vector(seeds: np.ndarray, sentinel: int) -> np.ndarray:
    s_pad = size_class(len(seeds), SEED_CLASS_MIN)
    out = np.full(s_pad, sentinel, np.int32)
    out[:len(seeds)] = seeds
    return out


def _charge_ranges(col: DeltaColumn, plan: TraversalPlan,
                   los, his, meter, cache, parts, qual=None) -> None:
    """Replay the page I/O of decoding ``[los, his)`` exactly as the
    host oracle incurs it: page-granular statistics pruning against the
    hop predicate's qualifying hull ``qual``, LRU split (in the
    ``(partition, page)`` namespace when ``parts`` is attached),
    miss-page charge (bytes once, requests per contiguous run), cache
    backfill from the plan's host decode."""
    ps = col.page_size
    pages, _ = pac_ops.page_set_for_ranges(los, his, ps)
    pages, _ = prune_page_list(col, pages, qual)
    if not len(pages):
        return
    owner = parts.part_of_pages(pages) if parts is not None else None
    if cache is None:
        pac_ops._charge_pages(col, pages, meter)
        return
    _, miss = cache.split(pages, owner=owner)
    pac_ops._charge_pages(col, miss, meter)
    pos = {int(p): i for i, p in enumerate(pages)}
    for p in miss:
        rows = plan.host_vals[p * ps: p * ps + col.pages[p].count]
        cache.put(p, rows.copy(),
                  part=None if owner is None else int(owner[pos[p]]))


def _charge_expansion(adj, col: DeltaColumn, plan: TraversalPlan,
                      ids: np.ndarray, meter, cache, parts,
                      qual=None) -> None:
    """One hop's oracle I/O: offsets gather + value-page charges
    (zone-map-pruned by the hop predicate's hull, like the oracle's)."""
    los, his = adj.edge_ranges_batch(ids, meter)
    _charge_ranges(col, plan, los, his, meter, cache, parts, qual=qual)


def _shard_width(parts, engine: str) -> int:
    """Mesh width of a traversal dispatch: the partition plane's mesh,
    taken only when every entry's share of the column clears
    ``pac_ops.SHARD_MIN_PAGES`` (the retrieval plane's threshold, read at
    call time)."""
    g = parts.mesh_size(len(pac_ops._devices(engine)))
    if g <= 1:
        return 1
    if -(-len(parts.col.pages) // g) < pac_ops.SHARD_MIN_PAGES:
        return 1
    return g


def note_traversal_fallback(adj) -> None:
    """Count one degradation to the host-loop oracle (surfaced as
    ``fallbacks`` in :func:`traversal_stats`)."""
    adj._traversal_fallbacks = getattr(adj, "_traversal_fallbacks", 0) + 1


def k_hop_fused(adj, seeds, hops: int, filts: Sequence, meter=None,
                engine: str = "cuda",
                include_seeds: bool = True) -> np.ndarray:
    """Fused k-hop: the hops queued on the device with no host round trip
    between them, ids bit-identical to the host oracle
    (``core.neighbor.k_hop`` with ``fused=False``)."""
    from repro_torch.core.delta_segment import live_delta
    if live_delta(adj) is not None or neighbor._mirror_poisoned(adj):
        # graceful degradation, two flavors: the traversal plan covers
        # the packed base only, so while delta rows are pending the
        # bit-identical host loop serves (it unions the mutable plane per
        # hop); a poisoned device mirror routes the same way.  Once a
        # compaction drains the plane and bumps the version, the plan
        # rebuilds.  The one place the fused route is refused
        # (``core.neighbor.k_hop`` comes here); counted as ``fallbacks``,
        # invisible in ids and IOMeter.
        note_traversal_fallback(adj)
        return neighbor.k_hop(adj, seeds, hops, meter=meter, engine=engine,
                              include_seeds=include_seeds,
                              filter=list(filts), fused=False)
    col = neighbor._kernel_column(adj)
    device = pac_ops.engine_device(engine)
    plan = traversal_plan(adj, engine)
    n = plan.n_value
    seeds = np.unique(np.asarray(seeds, np.int64))
    if seeds.size == 0 or hops <= 0:
        return seeds if include_seeds else np.zeros(0, np.int64)
    n_words = -(-n // 32)
    parts = live_partitions(col)
    g = _shard_width(parts, engine) if parts is not None else 1
    if parts is not None:
        # the traversal runs over the partition plane's rows -- count it
        parts.dispatches += 1
    if g > 1:
        mesh = parts.mesh_devices(pac_ops._devices(engine))
        device = mesh[0]
    seed_ids = pac_ops._to_device(_seed_vector(seeds, n), device)
    fw = _filter_words(filts, hops, n_words, n, device)
    if g > 1:
        from repro_torch.kernels import shard
        vis, planes, sizes = shard.sharded_khop(
            mesh, plan.sharded_arrays(parts, mesh), seed_ids, fw, n)
    else:
        ks, voff = plan.device(device)
        vis, planes, sizes = K.khop_scan(ks, voff, seed_ids, fw, n_out=n)
    # the one round trip: the per-hop sizes and the visited plane in one
    # copy
    host = torch.cat([sizes, vis]).cpu().numpy()
    plan.dispatches += 1
    plan.hops_fused += int(hops)
    plan.device_roundtrips += 1
    plan.last_frontier_sizes = host[:hops].astype(np.int64)
    cache = live_cache(col)
    if meter is not None or cache is not None:
        # oracle-accounting replay: per-hop frontiers come back once
        planes_host = None
        ids = seeds
        for h in range(hops):
            if ids.size == 0:
                break
            if filts[h] is not None:
                filts[h].charge(meter)
            _charge_expansion(
                adj, col, plan, ids, meter, cache, parts,
                qual=filts[h].qual_range() if filts[h] is not None else None)
            if h + 1 < hops:
                if planes_host is None:
                    planes_host = planes.cpu().numpy()
                    plan.device_roundtrips += 1
                ids = np.flatnonzero(planes_host[h]).astype(np.int64)
    visited = Frontier.from_dense_plane(host[hops:], n)
    if not include_seeds:
        visited.andnot(Frontier.from_ids(seeds, n))
    return visited.to_ids()


def two_hop_pac(adj_a, adj_b, seeds, target_page_size: int, filt=None,
                meter=None, engine: str = "cuda") -> PAC:
    """IC-8's heterogeneous two-hop chain as one fused dispatch.

    Seeds (adjacency A's key space) expand through A into a mid plane
    (A's value space == B's key space), the mid plane expands through B,
    and the predicate bitmap ANDs the result; the host receives packed
    bitmap words and builds the merged PAC directly.  Accounting replays
    the staged host path (hop-1 decode, filter charge, hop-2 batched
    retrieval) when a meter or LRU is attached.
    """
    col_a = neighbor._kernel_column(adj_a)
    col_b = neighbor._kernel_column(adj_b)
    device = pac_ops.engine_device(engine)
    plan_a = traversal_plan(adj_a, engine)
    plan_b = traversal_plan(adj_b, engine)
    if plan_a.n_value != plan_b.n_key:
        raise ValueError("adjacencies do not chain: A's value space "
                         f"({plan_a.n_value}) != B's key space "
                         f"({plan_b.n_key})")
    n_out = plan_b.n_value
    n_words = -(-n_out // 32)
    seeds = np.unique(np.asarray(seeds, np.int64))
    if seeds.size == 0:
        return PAC(target_page_size)
    seed_ids = pac_ops._to_device(_seed_vector(seeds, plan_a.n_key), device)
    if filt is not None:
        if filt.vt.num_vertices != n_out:
            raise ValueError("filter id space mismatch")
        fwords = filt.plan().device_bitmap(device, n_words)
    else:
        fwords = torch.full((n_words,), -1, dtype=torch.int32,
                            device=device)
    mid, words = K.two_hop(*plan_a.device(device), *plan_b.device(device),
                           seed_ids, fwords, n_key=plan_a.n_key,
                           n_mid=plan_a.n_value, n_out=n_out,
                           n_words=n_words)
    host_words = words.cpu().numpy().view(np.uint32)
    for plan in (plan_a, plan_b):
        plan.dispatches += 1
        plan.hops_fused += 1
        plan.device_roundtrips += 1
    cache_a, cache_b = live_cache(col_a), live_cache(col_b)
    if meter is not None or cache_a is not None or cache_b is not None:
        _charge_expansion(adj_a, col_a, plan_a, seeds, meter, cache_a,
                          live_partitions(col_a))
        if filt is not None:
            filt.charge(meter)
        created = np.flatnonzero(mid.cpu().numpy()).astype(np.int64)
        if created.size:
            _charge_expansion(adj_b, col_b, plan_b, created, meter,
                              cache_b, live_partitions(col_b),
                              qual=filt.qual_range()
                              if filt is not None else None)
    return PAC.from_dense_bitmap(host_words, target_page_size)


def frontier_edge_counts(adj, starts, ends, los, his, meter=None,
                         engine: str = "cuda") -> np.ndarray:
    """BI-2's counting expansion: an interval frontier over the key
    space -> per-target **edge counts** (multiplicity preserved -- the
    expansion adds instead of ORing), one fused dispatch.  ``los``/``his``
    are the intervals' already-gathered edge-row ranges, used only to
    replay the oracle's page charges."""
    col = neighbor._kernel_column(adj)
    device = pac_ops.engine_device(engine)
    plan = traversal_plan(adj, engine)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    i_pad = size_class(len(starts), INTERVAL_CLASS_MIN)
    sentinel = plan.n_key + 1
    s = np.full(i_pad, sentinel, np.int32)
    e = np.full(i_pad, sentinel, np.int32)
    s[:len(starts)] = starts
    e[:len(ends)] = ends
    counts = K.count_hop(*plan.device(device),
                         pac_ops._to_device(s, device),
                         pac_ops._to_device(e, device),
                         n_key=plan.n_key, n_out=plan.n_value)
    counts = counts.cpu().numpy().astype(np.int64)
    plan.dispatches += 1
    plan.hops_fused += 1
    plan.device_roundtrips += 1
    cache = live_cache(col)
    if meter is not None or cache is not None:
        _charge_ranges(col, plan, los, his, meter, cache,
                       live_partitions(col))
    return counts
