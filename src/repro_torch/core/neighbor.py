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

import os

import numpy as np

from .edge import AdjacencyTable
from .pac import PAC
from .table import DeltaIntColumn
from .vertex import VertexTable


def _kernel_column(adj: AdjacencyTable):
    col = adj.table[adj.value_col]
    if not isinstance(col, DeltaIntColumn):
        raise TypeError("kernel engines require a delta-encoded column")
    # the JAX package routes REPRO_PARTITIONS > 1 through its partition
    # plane; that plane is not ported, and ignoring the setting would
    # silently serve another route
    if int(os.environ.get("REPRO_PARTITIONS", "0") or 0) > 1:
        raise NotImplementedError(
            "the partition plane (REPRO_PARTITIONS > 1) is not ported")
    return col.encoded


def _require_write_once(adj: AdjacencyTable) -> None:
    if adj.delta is not None:
        raise NotImplementedError(
            "the mutable plane (pending delta edges) is not ported")


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
    in ``vs`` order (multiplicity preserved).  ``qual`` (unique mode only)
    pushes a predicate's qualifying hull down for statistics pruning.
    """
    _require_write_once(adj)
    los, his = adj.edge_ranges_batch(vs, meter)
    ids = decode_edge_ranges(adj, los, his, meter, engine,
                             qual=qual if unique else None)
    return np.unique(ids) if unique else ids


def retrieve_neighbors_batch(adj: AdjacencyTable, vs,
                             target_page_size: int,
                             meter=None,
                             engine: str = "cuda",
                             fused: bool | None = None,
                             filter=None,
                             resident: bool | None = None) -> PAC:
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
    same either way."""
    vs = np.asarray(vs, np.int64)
    if engine == "numpy" and fused:
        raise ValueError("fused path requires a kernel engine (torch/cuda)")
    _require_write_once(adj)
    if vs.size == 0:
        return PAC(target_page_size)
    if filter is not None:
        filter.charge(meter)
    los, his = adj.edge_ranges_batch(vs, meter)
    if engine == "numpy":
        qual = filter.qual_range() if filter is not None else None
        ids = decode_edge_ranges(adj, los, his, meter, engine, qual=qual)
        pac = PAC.from_ids(np.unique(ids), target_page_size) \
            if ids.size else PAC(target_page_size)
        if filter is not None:
            pac = pac.intersect(filter.pac(target_page_size))
        return pac
    from repro_torch.kernels.pac_decode import ops as pac_ops
    return pac_ops.retrieve_pac_batch(_kernel_column(adj), los, his,
                                      target_page_size, meter, engine=engine,
                                      num_targets=adj.num_value_vertices,
                                      fused=fused, label_filter=filter,
                                      resident=resident)


def retrieve_neighbors(adj: AdjacencyTable, v: int,
                       target_page_size: int,
                       meter=None,
                       engine: str = "cuda") -> PAC:
    """Definition 2: PAC of the neighbor IDs of ``v``."""
    _require_write_once(adj)
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

    ``filter`` and ``resident`` thread through to
    :func:`retrieve_neighbors_batch`; ``partitions`` is accepted for the
    JAX package's signature, and ``partitions > 1`` (the partition
    plane, not ported) raises."""
    _require_unpartitioned(partitions)
    pac = retrieve_neighbors_batch(adj, vs, vt.page_size, meter, engine,
                                   filter=filter, resident=resident)
    return fetch_properties(pac, vt, prop, meter)


def _require_unpartitioned(partitions: int | None) -> None:
    if partitions is not None and partitions > 1:
        raise NotImplementedError(
            "the partition plane (partitions > 1) is not ported")


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
    per-dispatch pack route; ``partitions`` is accepted for the JAX
    package's signature, and ``partitions > 1`` raises."""
    _require_unpartitioned(partitions)
    if engine == "numpy" and fused:
        raise ValueError("fused path requires a kernel engine (torch/cuda)")
    _require_write_once(adj)
    filts = _per_hop_filters(filter, hops)
    if fused is None:
        from repro_torch.kernels.pac_decode.ops import DEVICE_RESIDENT
        from repro_torch.kernels.traversal.ops import plan_supported
        fused = (engine != "numpy" and plan_supported(adj)
                 and adj.num_key_vertices == adj.num_value_vertices
                 and (resident if resident is not None
                      else DEVICE_RESIDENT))
    if fused:
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
