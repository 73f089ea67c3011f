"""Neighbor retrieval (paper §4, Definitions 1-2) -- batched plane.

Given vertex ``v``:
  1. the ``<offset>`` index gives the edge-row range ``[lo, hi)``;
  2. only the delta pages of the value column overlapping that range are
     loaded and decoded (I/O metered);
  3. decoded neighbor IDs are grouped into a :class:`PAC` over the *target
     vertex table's* pages, each collection a bitmap.

The unit of work is a **batch of vertices**: ``retrieve_neighbors_batch``
performs one vectorized offsets gather, one page-deduplicated multi-range
decode, and returns a merged (unioned) PAC; ``k_hop`` expands whole
frontiers, fused on the device by default.

The decode step has three engines:
  * ``numpy`` -- the storage-plane oracle (encoding.py),
  * ``torch`` -- the kernels' plain PyTorch versions, on the CPU,
  * ``cuda``  -- the hand-written CUDA kernels, on ``cuda:0`` (default).
"""
from __future__ import annotations

import numpy as np

from .delta_segment import live_delta, merge_rows
from .edge import AdjacencyTable
from .pac import PAC
from .partition import ensure_default_partitions, partition_column
from .table import DeltaIntColumn
from .vertex import VertexTable


def _mirror_poisoned(adj: AdjacencyTable) -> bool:
    """True when the column's device mirror is marked poisoned (only an
    explicit ``PackedPages.poison()`` does that): kernel paths fall back
    to the host oracle -- ids and IOMeter are engine-identical by
    construction, so degradation is invisible to results.  The one route
    by which a kernel engine's reads run on the host (ROADMAP section 3).
    A compaction (or any version bump) rebuilds the mirror and heals the
    route: a poisoned mirror of an older version does not count, since
    the next kernel dispatch packs the column anew (the reference goes on
    routing to the host until something else repacks the column, so
    there a bare ``bump_version`` does not heal)."""
    col = adj.table[adj.value_col]
    if not isinstance(col, DeltaIntColumn):
        return False
    packed = col.encoded.packed_cache
    if packed is not None and packed.poisoned \
            and packed.version == col.encoded.version:
        packed.fallbacks += 1
        return True
    return False


def _kernel_column(adj: AdjacencyTable):
    col = adj.table[adj.value_col]
    if not isinstance(col, DeltaIntColumn):
        raise TypeError("kernel engines require a delta-encoded column")
    # the REPRO_PARTITIONS default: a column without explicit partitioning
    # takes the environment's count here, so every batched consumer
    # (k_hop, the queries, serving) routes through the partition plane
    ensure_default_partitions(col.encoded)
    return col.encoded


def decode_edge_ranges(adj: AdjacencyTable, los, his, meter=None,
                       engine: str = "cuda", qual=None) -> np.ndarray:
    """Concatenated neighbor IDs over many edge-row ranges (multiplicity
    preserved), decoding the deduplicated page set once.

    ``qual`` -- a predicate's half-open qualifying ``[lo, hi)`` id hull
    -- enables page-granular statistics pushdown: pages whose zone map
    cannot intersect it are neither decoded nor charged, and their rows
    (all of which fail the predicate) are dropped from the output.  Only
    callers that go on to filter by that predicate may pass it.
    """
    from repro_torch.kernels.pac_decode import ops as pac_ops
    if engine != "numpy" and _mirror_poisoned(adj):
        engine = "numpy"  # poisoned device mirror: host oracle decodes
    if engine == "numpy" and (qual is None or not isinstance(
            adj.table[adj.value_col], DeltaIntColumn)):
        return np.asarray(
            adj.table[adj.value_col].read_rows_concat(los, his, meter),
            np.int64)
    return pac_ops.decode_row_ranges(_kernel_column(adj), los, his,
                                     meter=meter, engine=engine, qual=qual)


def neighbor_ids_batch(adj: AdjacencyTable, vs, meter=None,
                       engine: str = "cuda",
                       unique: bool = True, qual=None) -> np.ndarray:
    """Neighbor IDs of a whole batch of vertices.

    One vectorized offsets gather + one multi-range decode; duplicate
    vertices in ``vs`` and empty adjacencies cost nothing extra.  With
    ``unique`` the result is the sorted union; otherwise the concatenation
    in ``vs`` order (multiplicity preserved).

    Pending delta rows (the mutable plane) are unioned in at this level,
    so every consumer -- the k-hop host loops included -- sees ingested
    edges immediately; delta reads are RAM-resident and charge no lake
    I/O.  The merged per-vertex lists equal a from-scratch rebuild's.

    ``qual`` (unique mode only) pushes a predicate's qualifying hull down
    for statistics pruning -- base pages *and* delta segments outside it
    are skipped; ids that survive still need the caller's exact filter.
    The non-unique merge path never prunes: its per-vertex alignment
    requires every row.
    """
    los, his = adj.edge_ranges_batch(vs, meter)
    ids = decode_edge_ranges(adj, los, his, meter, engine,
                             qual=qual if unique else None)
    delta = live_delta(adj)
    if delta is None:
        return np.unique(ids) if unique else ids
    if unique:
        return np.union1d(ids, delta.unique_ids(vs, qual))
    dvals, dlens = delta.lookup_batch(vs)
    return merge_rows(ids, np.maximum(his - los, 0), dvals, dlens)[0]


def retrieve_neighbors_batch(adj: AdjacencyTable, vs,
                             target_page_size: int,
                             meter=None,
                             engine: str = "cuda",
                             fused: bool | None = None,
                             filter=None,
                             resident: bool | None = None,
                             partitions: int | None = None) -> PAC:
    """Batched Definition 2: merged PAC of the neighbors of every ``v`` in
    ``vs`` (equal to the union of the per-vertex PACs).

    On the kernel engines the merged PAC comes straight from the fused
    decode->bitmap kernel whenever the adjacency knows its value-side
    vertex count and the batch has at least ``FUSED_MIN_RANGES`` vertices;
    ``fused=False`` forces the decode + ``PAC.from_ids`` host path.

    ``filter`` -- a :class:`repro_torch.core.labels.LabelFilter` over the
    value-side vertex table -- pushes a label predicate down: "neighbors
    of batch B having label L".  On the fused path the predicate plane is
    ANDed inside the same dispatch; the host path intersects with the
    filter's PAC.  The filter's label-metadata I/O is charged here, once,
    identically for every engine and path.

    ``resident`` picks the fused path's transfer regime: the resident
    unpack plan on the card, or the per-dispatch pack route that ships
    the miss pages packed with every dispatch (``resident=False``);
    None follows ``REPRO_DEVICE_RESIDENT``.  Ids, PAC and IOMeter are the
    same either way.

    Pending delta rows are unioned into the PAC after the base dispatch,
    filtered exactly by the predicate; they never reach a kernel.  A
    poisoned device mirror routes the base to the host oracle.

    ``partitions`` sets the value column's partition count first
    (:func:`repro_torch.core.partition.partition_column`; None keeps what
    is attached, 1 detaches); the JAX package takes it on
    ``neighbor_properties_batch`` and ``k_hop`` only."""
    _apply_partitions(adj, partitions)
    vs = np.asarray(vs, np.int64)
    if engine == "numpy" and fused:
        raise ValueError("fused path requires a kernel engine (torch/cuda)")
    if vs.size == 0:
        return PAC(target_page_size)
    if filter is not None:
        filter.charge(meter)
    los, his = adj.edge_ranges_batch(vs, meter)
    # mutable plane: the batch's pending neighbors, zone-map-pruned by
    # the predicate's qualifying hull then exact-filtered host-side
    # (exact, so base-side statistics pruning can never drop a delta id).
    # RAM-resident -- no lake I/O charged.
    delta = live_delta(adj)
    delta_ids = None
    if delta is not None:
        qual = filter.qual_range() if filter is not None else None
        delta_ids = delta.unique_ids(vs, qual)
        if filter is not None and delta_ids.size:
            delta_ids = delta_ids[filter.mask_ids(delta_ids, engine)]
    if engine != "numpy" and _mirror_poisoned(adj):
        engine = "numpy"  # graceful degradation: host oracle serves
    if engine == "numpy":
        qual = filter.qual_range() if filter is not None else None
        ids = decode_edge_ranges(adj, los, his, meter, engine, qual=qual)
        pac = PAC.from_ids(np.unique(ids), target_page_size) \
            if ids.size else PAC(target_page_size)
        if filter is not None:
            pac = pac.intersect(filter.pac(target_page_size))
        if delta_ids is not None and delta_ids.size:
            pac = pac.union(PAC.from_ids(delta_ids, target_page_size))
        return pac
    from repro_torch.kernels.pac_decode import ops as pac_ops
    return pac_ops.retrieve_pac_batch(_kernel_column(adj), los, his,
                                      target_page_size, meter, engine=engine,
                                      num_targets=adj.num_value_vertices,
                                      fused=fused, label_filter=filter,
                                      resident=resident,
                                      delta_ids=delta_ids)


def retrieve_neighbors(adj: AdjacencyTable, v: int,
                       target_page_size: int,
                       meter=None,
                       engine: str = "cuda") -> PAC:
    """Definition 2: PAC of the neighbor IDs of ``v``."""
    lo, hi = adj.edge_range(v, meter)
    if hi <= lo:
        return PAC(target_page_size)
    if engine == "numpy":
        ids = np.asarray(
            adj.table[adj.value_col].read_range(lo, hi, meter), np.int64)
        return PAC.from_ids(ids, target_page_size)
    from repro_torch.kernels.pac_decode import ops as pac_ops
    return pac_ops.retrieve_pac(_kernel_column(adj), lo, hi,
                                target_page_size, meter=meter, engine=engine)


def retrieve_neighbors_scan(adj: AdjacencyTable, v: int,
                            target_page_size: int, meter=None) -> PAC:
    """Baseline 'plain': no offset index -- scan the whole edge table."""
    ids = adj.neighbor_ids_scan(v, meter)
    return PAC.from_ids(ids, target_page_size)


def fetch_properties(pac: PAC, vt: VertexTable, prop: str,
                     meter=None) -> np.ndarray:
    """Selection pushdown: fetch ``prop`` for exactly the PAC's IDs.

    Works unchanged over merged PACs: a page shared by many vertices of a
    batch appears once in the page set and is fetched once.
    """
    pages = pac.pages()
    page_vals = vt.read_property_pages(prop, pages, meter)
    return pac.select(page_vals)


def fetch_properties_batch(pac: PAC, vt: VertexTable, props,
                           meter=None) -> dict:
    """Batched multi-property selection pushdown: every column in
    ``props`` fetched for exactly the PAC's ids in one deduplicated pass
    over the PAC's page set.  Per-column results equal
    :func:`fetch_properties`.
    """
    return vt.read_properties_batch(pac, props, meter)


def neighbor_properties(adj: AdjacencyTable, v: int, vt: VertexTable,
                        prop: str, meter=None,
                        engine: str = "cuda") -> np.ndarray:
    """End-to-end §4.1 workflow: ids -> PAC -> per-page pushdown fetch."""
    pac = retrieve_neighbors(adj, v, vt.page_size, meter, engine)
    return fetch_properties(pac, vt, prop, meter)


def neighbor_properties_batch(adj: AdjacencyTable, vs, vt: VertexTable,
                              prop: str, meter=None,
                              engine: str = "cuda",
                              filter=None,
                              resident: bool | None = None,
                              partitions: int | None = None) -> np.ndarray:
    """Batched §4.1 workflow: one retrieval + one pushdown fetch for the
    whole batch's merged PAC (values in ascending neighbor-id order).

    ``filter``, ``resident`` and ``partitions`` thread through to
    :func:`retrieve_neighbors_batch`: a label predicate pushed into the
    retrieval, the transfer regime, and an explicit partition count for
    the adjacency's value column."""
    pac = retrieve_neighbors_batch(adj, vs, vt.page_size, meter, engine,
                                   filter=filter, resident=resident,
                                   partitions=partitions)
    return fetch_properties(pac, vt, prop, meter)


def _apply_partitions(adj: AdjacencyTable, partitions: int | None) -> None:
    """Explicit partition count for the adjacency's value column (None
    keeps whatever is attached, or the ``REPRO_PARTITIONS`` default)."""
    if partitions is None:
        return
    col = adj.table[adj.value_col]
    if not isinstance(col, DeltaIntColumn):
        raise TypeError("partitions= requires a delta-encoded column")
    partition_column(col.encoded, partitions)


def _per_hop_filters(filter, hops: int) -> list:
    """Normalize ``filter=`` to one entry per hop: a single
    ``LabelFilter`` applies to every hop; a sequence gives hop ``h`` its
    own predicate (None entries leave that hop unfiltered)."""
    if filter is None:
        return [None] * hops
    if isinstance(filter, (list, tuple)):
        if len(filter) != hops:
            raise ValueError(f"filter sequence has {len(filter)} entries "
                             f"for {hops} hops")
        return list(filter)
    return [filter] * hops


def k_hop(adj: AdjacencyTable, seeds: np.ndarray, hops: int,
          meter=None, engine: str = "cuda",
          include_seeds: bool = True,
          filter=None,
          fused: bool | None = None,
          resident: bool | None = None,
          partitions: int | None = None) -> np.ndarray:
    """Multi-hop expansion (IC-8-style traversals). Returns unique IDs.

    On the kernel engines the k hops run **fused** over the
    device-resident frontier plane (:mod:`repro_torch.kernels.traversal`):
    the frontier is expanded, predicate-ANDed and visited-ANDNOTed on the
    device every hop, queued with no host round trip between hops.
    ``fused=False`` (and the numpy engine) keeps the **host-loop
    oracle**: each hop one batched retrieval over the current frontier
    with a boolean visited mask over the id space -- bit-identical ids and
    IOMeter to the fused path.

    ``include_seeds`` keeps the seed ids in the result;
    ``include_seeds=False`` returns only discovered vertices.  ``filter``
    -- a :class:`~repro_torch.core.labels.LabelFilter` over the value-side
    table, or a per-hop sequence of them -- drops non-qualifying ids from
    each hop's frontier (filtered ids stay unvisited and remain reachable
    via a later hop).  ``resident=False`` (or ``REPRO_DEVICE_RESIDENT=0``
    with ``resident`` None) takes the host loop, whose hops then run the
    per-dispatch pack route; ``partitions`` sets the value column's
    partition count (see :func:`retrieve_neighbors_batch`)."""
    _apply_partitions(adj, partitions)
    if engine == "numpy" and fused:
        raise ValueError("fused path requires a kernel engine (torch/cuda)")
    filts = _per_hop_filters(filter, hops)
    if fused is None:
        from repro_torch.kernels.pac_decode.ops import DEVICE_RESIDENT
        from repro_torch.kernels.traversal.ops import plan_supported
        fused = (engine != "numpy" and plan_supported(adj)
                 and adj.num_key_vertices == adj.num_value_vertices
                 and (resident if resident is not None
                      else DEVICE_RESIDENT))
    if fused:
        # the fused entry decides the degradation to this host loop (rows
        # pending, a poisoned mirror) and counts it
        from repro_torch.kernels.traversal.ops import k_hop_fused
        return k_hop_fused(adj, seeds, hops, filts, meter, engine,
                           include_seeds)
    seeds = np.unique(np.asarray(seeds, np.int64))
    if adj.num_value_vertices is None or adj.num_key_vertices is None:
        # no known id space: set-based bookkeeping
        frontier, seen = seeds, seeds
        for h in range(hops):
            if frontier.size == 0:
                break
            if filts[h] is not None:
                filts[h].charge(meter)
            nbrs = neighbor_ids_batch(
                adj, frontier, meter, engine=engine,
                qual=filts[h].qual_range() if filts[h] is not None else None)
            if filts[h] is not None and nbrs.size:
                nbrs = nbrs[filts[h].mask_ids(nbrs, engine)]
            frontier = np.setdiff1d(nbrs, seen, assume_unique=True)
            seen = np.union1d(seen, frontier)
        return seen if include_seeds \
            else seen[~np.isin(seen, seeds, assume_unique=True)]
    # host oracle: boolean visited mask over the id space -- O(ids) per
    # hop instead of the O(n log n) setdiff1d/union1d re-sorts
    m = max(int(adj.num_key_vertices), int(adj.num_value_vertices))
    visited = np.zeros(m, bool)
    visited[seeds] = True
    frontier = seeds
    for h in range(hops):
        if frontier.size == 0:
            break
        if filts[h] is not None:
            filts[h].charge(meter)
        nbrs = neighbor_ids_batch(
            adj, frontier, meter, engine=engine,
            qual=filts[h].qual_range() if filts[h] is not None else None)
        if filts[h] is not None and nbrs.size:
            nbrs = nbrs[filts[h].mask_ids(nbrs, engine)]
        frontier = nbrs[~visited[nbrs]]
        visited[frontier] = True
    if not include_seeds:
        visited[seeds] = False
    return np.flatnonzero(visited).astype(np.int64)


def degrees_topk(adj: AdjacencyTable, k: int = 1) -> np.ndarray:
    """Vertices with the largest degree (paper §6.2.2 queries these)."""
    deg = adj.degrees()
    if k == 1:
        return np.array([int(np.argmax(deg))])
    return np.argsort(deg)[::-1][:k].astype(np.int64)
