"""Storage-plane integration of the pac_decode kernels.

The batched neighbor-retrieval plane: an arbitrary set of row ranges is
decoded through **one** kernel dispatch over the page-deduplicated page
set.  Two entries:

* ``decode_row_ranges`` -- the concatenated rows (the ``gather_decode``
  kernel, then a host gather from the decoded page matrix);
* ``retrieve_pac_batch`` -- the merged PAC of the rows' ids: from
  ``FUSED_MIN_RANGES`` ranges up, the fused kernel decodes the pages and
  scatters the requested rows' ids straight into a target bitmap on the
  card, with a label predicate's plane ANDed in when one is pushed down.

Two single-range entries build one bitmap over a 32-aligned window:
``ids_to_bitmap`` from an id list, ``decode_range_to_bitmap`` from a
page-aligned row range of a delta column, with the ids kept on the card.

Two transfer regimes, with the same ids, PACs and IOMeter:

* **device-resident** (the default): the column crosses to the card
  once, as its unpack plan and its raw miniblock arrays
  (``PackedPages.device_plan`` and ``device_pages``, sharing the packed
  words); a dispatch ships one int32 vector and the pages are gathered
  and decoded there (``gather_decode`` from the miniblock arrays, the
  fused resident kernels from the plan);
* **per-dispatch pack** (``REPRO_DEVICE_RESIDENT=0``, or
  ``resident=False`` on the fused entries): the miss pages are gathered
  on the host and shipped packed with every dispatch (``delta_decode``,
  ``fused_decode_bitmap_batch`` and its filtered twin); LRU-hit rows
  ship already decoded, and a label predicate ships as its RLE lists.

With a decoded-page LRU attached (:mod:`repro_torch.core.page_cache`)
only the miss pages are charged to the ``IOMeter``, and the decoded
matrix comes back to the host only when misses need backfilling.

A column with a partition plane attached
(:mod:`repro_torch.core.partition`) takes the partitioned routes on the
resident regime: partition pruning (range and statistics) before the
page zone maps, the LRU in the ``(partition, page)`` namespace, and one
of two tails (``_shard_width``): the single-shard tail (the monolithic
kernels over the stacked partition plan on one device) or the
multi-device tail (:mod:`repro_torch.kernels.shard`: one launch per mesh
entry, then a merge).  The mesh comes from :func:`_devices`.

Engines: ``numpy`` (the host oracle), ``torch`` (the kernels' plain
PyTorch versions, on the CPU) and ``cuda`` (the kernels, on the current
CUDA device: ``cuda:0``, or a rank's own).
The staged vectors and their padding classes are the JAX package's.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.encoding import (DeltaColumn, delta_decode_page,
                                       pack_column, prune_page_list)
from repro_torch.core.labels import intervals_to_ids
from repro_torch.core.pac import PAC
from repro_torch.core.page_cache import live_cache, miss_runs
from repro_torch.core.partition import live_partitions
from repro_torch.kernels._pad import next_multiple, next_pow2, size_class

from . import kernel as K

ENGINES = ("numpy", "torch", "cuda")

#: below this many ranges the host path's O(neighbors) post-processing
#: beats the fused tail's O(num_targets) bitmap copy-out.
FUSED_MIN_RANGES = 16

#: the transfer regime of the kernel engines, the JAX package's switch:
#: on by default, ``REPRO_DEVICE_RESIDENT=0`` takes the per-dispatch pack
#: route everywhere (the fused entries' ``resident=`` overrides per call).
DEVICE_RESIDENT = os.environ.get("REPRO_DEVICE_RESIDENT", "1") \
    .strip().lower() not in ("0", "false", "no", "off")

#: pow2 size-class floors for the per-dispatch index/position vectors --
#: small frontiers share one bucket.
PAGE_CLASS_MIN = 8
RANGE_CLASS_MIN = 64

#: the partition plane's sharding threshold: a partitioned column takes
#: the multi-device tail (one launch per mesh entry, then a merge) only
#: when the busiest mesh entry gets at least this many pages to decode;
#: below it the **single-shard tail** runs -- the monolithic resident
#: kernels over the stacked partition plan on one device.  Results,
#: meters and pruning are identical either way.  ``REPRO_SHARD_MIN_PAGES=0``
#: takes the multi-device tail everywhere.
SHARD_MIN_PAGES = int(os.environ.get("REPRO_SHARD_MIN_PAGES", "48"))

#: (device, shape) -> ring of the two most recent dispatches' bitmap
#: buffers.  A dispatch writes into the *older* of two pooled buffers,
#: never the most recent output, so two dispatches in flight never share
#: one buffer; steady state settles at two buffers per class.
_WORDS_POOL: Dict[Tuple[str, int], "deque"] = {}


def engine_device(engine: str) -> torch.device:
    """The device a kernel engine runs on: ``torch`` -> the CPU (plain
    versions), ``cuda`` -> the current CUDA device (the kernels; ``cuda:0``
    unless a rank of a distributed world set its own,
    ``launch/mesh.py:init_world``).  ``cuda`` with no card raises:
    nothing falls back to the CPU."""
    if engine == "torch":
        return torch.device("cpu")
    if engine == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("engine='cuda' needs a CUDA device and none "
                               "is available (engine='torch' runs the "
                               "plain versions on the CPU)")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown engine {engine!r}; want one of {ENGINES}")


_DEVICES: Dict[str, Tuple[torch.device, ...]] = {}


def _devices(engine: str) -> Tuple[torch.device, ...]:
    """The devices an engine's partition mesh may span, resolved once:
    every CUDA device for ``cuda``, the CPU for ``torch``.  The one source
    of the mesh (tests replace it with a tuple naming one device several
    times, to drive the multi-device tail on one device)."""
    devs = _DEVICES.get(engine)
    if devs is None:
        first = engine_device(engine)
        devs = (tuple(torch.device("cuda", i)
                      for i in range(torch.cuda.device_count()))
                if first.type == "cuda" else (first,))
        _DEVICES[engine] = devs
    return devs


def _words_buffer(device: torch.device, n_words) -> torch.Tensor:
    """A pooled int32 buffer of shape ``n_words`` (an int, or a tuple for
    the rows of several mesh entries on one device)."""
    ring = _WORDS_POOL.get((str(device), n_words))
    if ring is not None and len(ring) >= 2:
        return ring.popleft()
    return torch.empty(n_words, dtype=torch.int32, device=device)


def _pool_words(device: torch.device, n_words, buf: torch.Tensor) -> None:
    ring = _WORDS_POOL.setdefault((str(device), n_words), deque())
    ring.append(buf)
    while len(ring) > 2:
        ring.popleft()


def reset_dispatch_pools() -> None:
    """Drop pooled device buffers (tests / bench isolation)."""
    _WORDS_POOL.clear()


def pack_pages(col: DeltaColumn, p0: int, p1: int
               ) -> Tuple[np.ndarray, ...]:
    """Views of pages [p0, p1) of the cached packed representation."""
    return pack_column(col).slice(p0, p1)


def pack_page_list(col: DeltaColumn, pages: Sequence[int]
                   ) -> Tuple[np.ndarray, ...]:
    """Row-gather of an arbitrary (sorted, deduplicated) page list."""
    return pack_column(col).gather(pages)


def _pad_pages(args: Tuple[np.ndarray, ...], rows: int
               ) -> Tuple[np.ndarray, ...]:
    """The six page arrays zero-padded to ``rows`` rows (all-zero pages
    decode to zeros)."""
    pad = rows - args[0].shape[0]
    if not pad:
        return args
    return tuple(np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                 for a in args)


def ship_pages(args: Tuple[np.ndarray, ...], device: torch.device
               ) -> Tuple[torch.Tensor, ...]:
    """The six page arrays as int32 tensors on ``device`` (the uint32
    words travel as their int32 bit patterns)."""
    return tuple(_to_device(np.ascontiguousarray(a).view(np.int32), device)
                 for a in args)


def decode_pages(col: DeltaColumn, p0: int, p1: int,
                 engine: str = "cuda") -> np.ndarray:
    """Decode pages [p0, p1) with ``delta_decode``; returns flat ids."""
    device = engine_device(engine)
    args = pack_pages(col, p0, p1)
    counts = args[5][:, 0]
    if not len(counts):
        return np.zeros(0, np.int32)
    ids = K.delta_decode(*ship_pages(args, device),
                         page_size=col.page_size).cpu().numpy()
    return np.concatenate([ids[i, :counts[i]] for i in range(len(counts))])


def _charge_pages(col: DeltaColumn, pages: Sequence[int], meter) -> None:
    """IOMeter charge for a (sorted) page list: each page's bytes once,
    requests per contiguous run (what a real ranged reader would issue)."""
    if meter is None or not len(pages):
        return
    meter.record(sum(col.pages[int(p)].nbytes() for p in pages),
                 miss_runs(pages))


def _page_class(n: int, stack_rows: int) -> int:
    """Page-padding class of a dispatch: the shared pow2 ladder, capped at
    the (PAGE_CLASS_MIN-rounded) whole plan -- ``stack_rows`` is the
    column's page count on the monolithic paths and the stacked partition
    plan's (or a mesh entry's block's) row count on the partitioned ones;
    a gather cannot name more distinct rows than the plan has."""
    return min(size_class(n, PAGE_CLASS_MIN),
               next_multiple(stack_rows, PAGE_CLASS_MIN))


def _stack_index(parts, pages: np.ndarray, owner: np.ndarray) -> np.ndarray:
    """Row of each global page in the partition-major stacked plan
    (``owner * pmax + offset within partition``); a mesh entry's
    block-local index is this minus its block's first row."""
    return (owner * parts.pmax
            + (pages - parts.bounds[owner])).astype(np.int32)


def _shard_width(parts, owner: np.ndarray, engine: str
                 ) -> Tuple[int, int, "np.ndarray | None",
                            "np.ndarray | None"]:
    """Mesh width of one dispatch: ``(g, ppd, dev_of_page, per_dev)``.

    ``g == 1`` selects the single-shard tail (a one-device mesh, or no
    mesh entry's page bucket reaches ``SHARD_MIN_PAGES``), and then the
    bucketing outputs are None.  The one home of the policy: the fused
    and non-fused paths shard under identical conditions."""
    g = parts.mesh_size(len(_devices(engine)))
    if g <= 1:
        return 1, 1, None, None
    ppd = parts.n_parts // g
    dev_of_page = owner // ppd
    per_dev = np.bincount(dev_of_page, minlength=g)
    if per_dev.max() < SHARD_MIN_PAGES:
        return 1, 1, None, None
    return g, ppd, dev_of_page, per_dev


def _sharded_decode_matrix(col: DeltaColumn, parts, pages: Sequence[int],
                           engine: str) -> np.ndarray:
    """Partitioned page-matrix decode (the non-fused batched path).

    Pages are re-addressed into the stacked partition plan; above the
    sharding threshold they are bucketed per mesh entry and decoded by
    one ``gather_decode`` launch per entry over its block
    (:func:`repro_torch.kernels.shard.sharded_decode`), below it by one
    launch over the single-device stacked plan.  Returns
    int64[len(pages), page_size]; the caller zeroes the tails."""
    pages_arr = np.asarray(pages, np.int64)
    owner, _ = parts.prune(pages_arr)  # dispatch/pruning counters only
    stack_idx = _stack_index(parts, pages_arr, owner)
    g, ppd, dev_of_page, per_dev = _shard_width(parts, owner, engine)
    if g == 1:
        device = engine_device(engine)
        idx = np.zeros(_page_class(len(pages_arr), parts.stack_rows),
                       np.int32)
        idx[:len(pages_arr)] = stack_idx
        ids = K.gather_decode(parts.device_pages_single(device),
                              _to_device(idx, device))
        return ids[:len(pages_arr)].cpu().numpy().astype(np.int64)
    from repro_torch.kernels import shard
    mesh = parts.mesh_devices(_devices(engine))
    blocks = parts.device_pages(mesh)
    block0 = dev_of_page * (ppd * parts.pmax)  # first stacked row a block
    local_idx = (stack_idx - block0).astype(np.int32)
    p_pad = _page_class(int(per_dev.max()), ppd * parts.pmax)
    idxmat = np.zeros((g, p_pad), np.int32)
    for i in range(g):
        sel = local_idx[dev_of_page == i]
        idxmat[i, :len(sel)] = sel
    mat = shard.sharded_decode(mesh, blocks, idxmat)  # [g, p_pad, ps]
    # row of page i = its order within its entry's bucket, the same masks
    # that filled idxmat
    within = np.empty(len(pages_arr), np.int64)
    for i in range(g):
        m = dev_of_page == i
        within[m] = np.arange(int(m.sum()))
    return mat[dev_of_page, within].astype(np.int64)


def _page_index_vector(pages: Sequence[int], total_pages: int) -> np.ndarray:
    """int32 page-index vector padded to its size class with page 0."""
    idx = np.zeros(_page_class(len(pages), total_pages), np.int32)
    idx[:len(pages)] = pages
    return idx


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def _decode_page_matrix(col: DeltaColumn, pages: Sequence[int],
                        engine: str) -> np.ndarray:
    """Engine dispatch only -- no cache, no metering (see
    :func:`decode_page_list`).  Returns int64[len(pages), page_size] with
    each row zeroed past its page's count.  The kernel engines follow
    ``DEVICE_RESIDENT`` (the per-call ``resident=`` exists on the fused
    entries only); a partitioned column decodes through
    :func:`_sharded_decode_matrix` on the resident route."""
    ps = col.page_size
    n = len(pages)
    parts = live_partitions(col)
    if engine == "numpy":
        if parts is not None:
            parts.prune(np.asarray(pages, np.int64))  # accounting only
        out = np.zeros((n, ps), np.int64)
        for i, p in enumerate(pages):
            d = delta_decode_page(col.pages[p])
            out[i, :len(d)] = d
        return out
    device = engine_device(engine)
    if parts is not None and DEVICE_RESIDENT:
        ids = _sharded_decode_matrix(col, parts, pages, engine)
        counts = np.asarray([col.pages[int(p)].count for p in pages],
                            np.int64)
        cols = np.arange(ps)[None, :]
        return np.where(cols < counts[:, None], ids, 0)
    if DEVICE_RESIDENT:
        packed = pack_column(col)
        idx = _page_index_vector(pages, len(col.pages))
        ids = K.gather_decode(packed.device_pages(device),
                              _to_device(idx, device))
        counts = packed.counts[np.asarray(pages, np.int64), 0]
    else:
        # per-dispatch pack: the pages ship packed, padded to a pow2 row
        # count so the launch shapes stay few
        args = _pad_pages(pack_page_list(col, pages), next_pow2(n))
        ids = K.delta_decode(*ship_pages(args, device), page_size=ps)
        counts = args[5][:n, 0]
    ids = ids[:n].cpu().numpy().astype(np.int64)
    cols = np.arange(ps)[None, :]
    return np.where(cols < counts[:, None], ids, 0)


def decode_page_list(col: DeltaColumn, pages: Sequence[int],
                     engine: str = "cuda", meter=None) -> np.ndarray:
    """Decode an arbitrary (sorted, deduplicated) page list, one dispatch.

    Returns ``int64[len(pages), page_size]``; rows are zero-padded past
    each page's count.  With a decoded-page LRU attached only the miss
    pages are decoded and IOMeter-charged; hit rows come from the cache.
    On a partitioned column the entries live in the ``(partition, page)``
    namespace, the one the fused partitioned path uses.
    """
    ps = col.page_size
    n = len(pages)
    if n == 0:
        return np.zeros((0, ps), np.int64)
    if engine != "numpy":
        engine_device(engine)   # an unusable engine raises before charging
    cache = live_cache(col)
    parts = live_partitions(col)
    pages_arr = np.asarray(pages, np.int64)
    owner = parts.part_of_pages(pages_arr) if parts is not None else None
    if cache is None:
        _charge_pages(col, pages, meter)
        return _decode_page_matrix(col, pages, engine)
    hits, miss = cache.split(pages, owner=owner)
    _charge_pages(col, miss, meter)
    out = np.zeros((n, ps), np.int64)
    if miss:
        mat = _decode_page_matrix(col, miss, engine)
        # miss preserves the sorted page order, so one fancy-index scatter
        # places every miss row
        is_miss = np.isin(pages_arr, np.asarray(miss, np.int64))
        miss_idx = np.flatnonzero(is_miss)
        out[miss_idx] = mat
        for i, p in enumerate(miss):
            cache.put(p, mat[i, :col.pages[p].count].copy(),
                      part=None if owner is None
                      else int(owner[miss_idx[i]]))
        hit_idx = np.flatnonzero(~is_miss)
    else:
        hit_idx = np.arange(n)
    if hit_idx.size:
        rows = [hits[int(pages_arr[i])] for i in hit_idx]
        lens = np.fromiter((len(r) for r in rows), np.int64, len(rows))
        full = lens == ps
        if full.any():   # full-width hits stack into one scatter
            out[hit_idx[full]] = [rows[j] for j in np.flatnonzero(full)]
        for j in np.flatnonzero(~full):  # at most the last partial page
            out[hit_idx[j], :lens[j]] = rows[j]
    return out


def page_set_for_ranges(los: np.ndarray, his: np.ndarray, page_size: int
                        ) -> Tuple[np.ndarray, int]:
    """(sorted unique pages, contiguous-run count) touched by the ranges.

    The run count models the read requests a real reader would issue:
    consecutive pages coalesce into one ranged GET.
    """
    los = np.asarray(los, np.int64)
    his = np.asarray(his, np.int64)
    keep = his > los
    if not keep.any():
        return np.zeros(0, np.int64), 0
    p0 = los[keep] // page_size
    p1 = his[keep] // page_size + ((his[keep] % page_size) != 0)
    pages = np.unique(intervals_to_ids((p0, p1)))
    return pages, miss_runs(pages)


def decode_row_ranges(col: DeltaColumn, los, his, meter=None,
                      engine: str = "cuda", qual=None) -> np.ndarray:
    """Concatenated rows over many [lo, hi) ranges, one decode dispatch.

    The deduplicated page set is decoded **once** (same IOMeter
    accounting on every engine: each cache-miss page's bytes charged
    once, requests per contiguous miss run), then every output element is
    gathered from the decoded page matrix.

    ``qual`` -- a predicate's half-open qualifying ``[lo, hi)`` id hull
    -- drops pages whose zone map cannot intersect it **before** the
    cache split and the decode: pruned pages are never decoded or
    charged, and the rows they held (all of which fail the predicate) are
    dropped from the output.
    """
    los = np.asarray(los, np.int64)
    his = np.asarray(his, np.int64)
    lengths = np.maximum(his - los, 0)
    if int(lengths.sum()) == 0:
        return np.zeros(0, np.int64)
    ps = col.page_size
    pages, _ = page_set_for_ranges(los, his, ps)
    pages, pmask = prune_page_list(col, pages, qual)
    if len(pages) == 0:
        return np.zeros(0, np.int64)
    mat = decode_page_list(col, pages, engine, meter=meter)
    rows = intervals_to_ids((los, his))
    page_of = rows // ps
    pidx = np.searchsorted(pages, page_of)
    if pmask is not None:
        # rows addressed at a pruned page cannot pass the predicate
        ok = pidx < len(pages)
        ok &= pages[np.minimum(pidx, len(pages) - 1)] == page_of
        rows, page_of, pidx = rows[ok], page_of[ok], pidx[ok]
    return mat[pidx, rows - page_of * ps]


def _gather_positions(pages: np.ndarray, base_of_page: np.ndarray,
                      los: np.ndarray, his: np.ndarray,
                      page_size: int, pruned: bool = False
                      ) -> Tuple[np.ndarray, int]:
    """Flat (row * page_size + offset) position of every requested row,
    zero-padded to a power of two.

    These are row *positions* (derivable from the <offset> index alone),
    not decoded ids: ``base_of_page[i]`` is the matrix row holding sorted
    page ``pages[i]``.  Returns ``(int32[t], total)``.  With ``pruned``,
    rows whose page was statistics-pruned are dropped, but the vector
    keeps the unpruned request's size class, so pruning never mints a new
    launch shape.
    """
    rows = intervals_to_ids((los, his))
    n_rows = len(rows)
    page_of = rows // page_size
    pidx = np.searchsorted(pages, page_of)
    if pruned:
        ok = pidx < len(pages)
        ok &= pages[np.minimum(pidx, len(pages) - 1)] == page_of
        if not ok.all():
            rows, page_of, pidx = rows[ok], page_of[ok], pidx[ok]
    total = len(rows)
    gidx = (base_of_page[pidx] * page_size + (rows - page_of * page_size)) \
        .astype(np.int32)
    pad = size_class(n_rows, RANGE_CLASS_MIN) - total
    if pad:
        gidx = np.concatenate([gidx, np.zeros(pad, np.int32)])
    return gidx, total


def stage_resident(col: DeltaColumn, los, his, pages: np.ndarray, pmask
                   ) -> Tuple[np.ndarray, int, int]:
    """The one staging vector ``[idx | gidx | total]`` of a resident fused
    dispatch over the sorted ``pages`` (``pmask``: as
    :func:`prune_page_list` returned it) -- one copy to the device.
    Returns ``(staged, p_pad, total)``."""
    # rows are in sorted-page order: base_of_page[i] == i
    gidx, total = _gather_positions(pages, np.arange(len(pages)), los, his,
                                    col.page_size, pruned=pmask is not None)
    p_pad = _page_class(len(pages), len(col.pages))
    staged = np.zeros(p_pad + len(gidx) + 1, np.int32)
    staged[:len(pages)] = pages
    staged[p_pad:-1] = gidx
    staged[-1] = total
    return staged, p_pad, total


def _retrieve_pac_batch_sharded(col: DeltaColumn, parts, los, his,
                                pages: np.ndarray, target_page_size: int,
                                num_targets: int, meter, engine: str,
                                filter_plan=None) -> PAC:
    """The fused path on a partitioned column.

    Pruning comes before anything is charged or staged: partitions
    holding none of the batch's pages are skipped (meter-neutral), and
    with a pushed-down filter the partitions whose hull cannot intersect
    the predicate's qualifying range are skipped too, then the page zone
    maps sieve the surviving pages (the final page set, and so the meter,
    equals the monolithic path's at any partition count).  The LRU
    (entries ``(partition, page)``) is split over the global page set,
    misses are charged once with requests per contiguous run, and the
    decode matrix comes back only when there are misses to backfill.

    The dispatch then takes one of two tails (``_shard_width``'s policy):
    the **single-shard tail** -- the monolithic resident kernel over the
    single-device stacked plan, with the words pool -- or the
    **multi-device tail**: the page set and requested rows bucketed per
    mesh entry (partitions are page-aligned, so a range crossing a
    boundary gives rows to both sides) into one ``staged`` matrix, one
    launch per entry over its block
    (:func:`repro_torch.kernels.shard.sharded_fused`), the planes
    OR-merged (a target may be reached through several partitions).
    Both tails give the same words.
    """
    ps = col.page_size
    qual = filter_plan.qual_range() if filter_plan is not None else None
    owner, mask = parts.prune(pages, qual)
    if mask is not None:
        pages = pages[mask]
        if pages.size == 0:  # every partition statistics-pruned
            return PAC(target_page_size)
    kept, pmask = prune_page_list(col, pages, qual)
    if pmask is not None:
        pages, owner = kept, owner[pmask]
        if pages.size == 0:  # every page statistics-pruned
            return PAC(target_page_size)
    pruned = mask is not None or pmask is not None
    stack_idx = _stack_index(parts, pages, owner)
    cache = live_cache(col)
    if cache is None:
        miss = [int(p) for p in pages]
    else:
        _, miss = cache.split(pages, owner=owner)
    _charge_pages(col, miss, meter)
    n_words = -(-num_targets // 32)
    # requested rows; under statistics pruning the rows of dropped pages
    # cannot pass the predicate and drop with them
    rows = intervals_to_ids((los, his))
    n_rows = len(rows)
    page_of = rows // ps
    pidx = np.searchsorted(pages, page_of)
    if pruned:
        ok = pidx < len(pages)
        ok &= pages[np.minimum(pidx, len(pages) - 1)] == page_of
        if not ok.all():
            rows, page_of, pidx = rows[ok], page_of[ok], pidx[ok]
    g, ppd, dev_of_page, per_dev = _shard_width(parts, owner, engine)
    if g == 1:
        device = engine_device(engine)
        arrays, _ = parts.device_plan_single(device)
        gidx = (pidx * ps + (rows - page_of * ps)).astype(np.int32)
        total = len(gidx)
        # pad to the unpruned request's class: pruning never mints a new
        # launch shape (see _gather_positions)
        pad = size_class(n_rows, RANGE_CLASS_MIN) - total
        if pad:
            gidx = np.concatenate([gidx, np.zeros(pad, np.int32)])
        p_pad = _page_class(len(pages), parts.stack_rows)
        staged = np.zeros(p_pad + len(gidx) + 1, np.int32)
        staged[:len(pages)] = stack_idx
        staged[p_pad:-1] = gidx
        staged[-1] = total
        host_words = _resident_fused(col, arrays, staged, p_pad, device,
                                     n_words, pages, miss, cache,
                                     filter_plan, owner)
        return PAC.from_dense_bitmap(host_words, target_page_size)
    # multi-device tail: bucket per mesh entry, one launch each
    from repro_torch.kernels import shard
    mesh = parts.mesh_devices(_devices(engine))
    blocks = parts.device_plan(mesh)
    block0 = dev_of_page * (ppd * parts.pmax)
    local_idx = (stack_idx - block0).astype(np.int32)
    # pidx maps each row to its page's slot; its entry follows from there
    dev_of_row = dev_of_page[pidx]
    dev_page_start = np.searchsorted(dev_of_page, np.arange(g))
    base_local = pidx - dev_page_start[dev_of_row]
    gidx = (base_local * ps + (rows - page_of * ps)).astype(np.int32)
    row_lists = [gidx[dev_of_row == i] for i in range(g)]
    p_pad = _page_class(int(per_dev.max()), ppd * parts.pmax)
    t_pad = size_class(max(len(x) for x in row_lists), RANGE_CLASS_MIN)
    staged = np.zeros((g, p_pad + t_pad + 1), np.int32)
    for i in range(g):
        sel = local_idx[dev_of_page == i]
        staged[i, :len(sel)] = sel
        staged[i, p_pad:p_pad + len(row_lists[i])] = row_lists[i]
        staged[i, -1] = len(row_lists[i])
    fwords = None
    if filter_plan is not None:
        fwords = filter_plan.device_bitmap_sharded(mesh, n_words)
    want_ids = cache is not None and bool(miss)
    host_words, ids = shard.sharded_fused(mesh, blocks, staged, n_words,
                                          p_pad, want_ids, fwords)
    if want_ids:
        mats = [None] * g
        pos = {int(p): (int(dev_of_page[i]),
                        i - int(dev_page_start[dev_of_page[i]]),
                        int(owner[i]))
               for i, p in enumerate(pages)}
        for p in miss:
            d, slot, k = pos[p]
            if mats[d] is None:
                mats[d] = ids[d].cpu().numpy().astype(np.int64)
            cache.put(p, mats[d][slot, :col.pages[p].count].copy(), part=k)
    return PAC.from_dense_bitmap(host_words, target_page_size)


def _retrieve_pac_batch_fused(col: DeltaColumn, los, his,
                              target_page_size: int, num_targets: int,
                              meter, engine: str, filter_plan=None,
                              resident: Optional[bool] = None) -> PAC:
    """Fused path: one dispatch from packed pages to a target bitmap.

    The decoded ids stay on the device; the host receives only the dense
    bitmap (``PAC.from_dense_bitmap`` keeps the non-empty planes).  With a
    decoded-page LRU attached, the IOMeter charges the **miss** pages
    only and the kernel's decode matrix backfills the cache (the one case
    where the matrix comes back to the host).  With ``filter_plan`` (a
    :class:`repro_torch.kernels.label_filter.ops.FilterPlan` over the
    target vertex table) the predicate is ANDed in by the same dispatch.

    Two transfer regimes, identical results and accounting (``resident``
    None follows ``DEVICE_RESIDENT``):

    * **device-resident**: pages are gathered from the column's resident
      unpack plan by index (LRU hits are decoded again there), and the
      predicate is the filter's resident plane;
    * **per-dispatch pack** (``resident=False``): the miss pages are
      gathered on the host and shipped packed, LRU-hit rows ship already
      decoded in ``cached``, and the predicate ships as its RLE lists.
    """
    if engine not in ("torch", "cuda"):
        raise ValueError(f"fused path requires a kernel engine, not "
                         f"{engine!r}")
    ps = col.page_size
    pages, _ = page_set_for_ranges(los, his, ps)
    if pages.size == 0:
        return PAC(target_page_size)
    device = engine_device(engine)
    if resident is None:
        resident = DEVICE_RESIDENT
    parts = live_partitions(col)
    if parts is not None and resident:
        # partition plane attached: the partitioned tails (the
        # per-dispatch pack route below stays the single-device oracle)
        return _retrieve_pac_batch_sharded(col, parts, los, his, pages,
                                           target_page_size, num_targets,
                                           meter, engine, filter_plan)
    # page-granular statistics pushdown: pages whose zone map cannot
    # intersect the predicate's hull are never staged, decoded or charged
    qual = filter_plan.qual_range() if filter_plan is not None else None
    pages, pmask = prune_page_list(col, pages, qual)
    if pages.size == 0:
        return PAC(target_page_size)
    cache = live_cache(col)
    part_of: Dict[int, int] = {}
    if cache is None:
        hits, miss = {}, [int(p) for p in pages]
    else:
        # a partitioned column's LRU entries live in the (partition, page)
        # namespace on every route, or one column's cache would split in
        # two and charge warm pages twice
        owner = parts.part_of_pages(pages) if parts is not None else None
        if owner is not None:
            part_of = {int(p): int(o) for p, o in zip(pages, owner)}
        hits, miss = cache.split(pages, owner=owner)
    _charge_pages(col, miss, meter)
    n_words = -(-num_targets // 32)
    if not resident:
        return _retrieve_pac_batch_packed(col, los, his, pages, pmask, hits,
                                          miss, cache, target_page_size,
                                          n_words, device, filter_plan,
                                          part_of)
    plan = pack_column(col).device_plan(device)
    staged, p_pad, _ = stage_resident(col, los, his, pages, pmask)
    host_words = _resident_fused(col, plan, staged, p_pad, device, n_words,
                                 pages, miss, cache, filter_plan)
    return PAC.from_dense_bitmap(host_words, target_page_size)


def _resident_fused(col: DeltaColumn, plan, staged: np.ndarray, p_pad: int,
                    device: torch.device, n_words: int, pages: np.ndarray,
                    miss: Sequence[int], cache, filter_plan=None,
                    owner: Optional[np.ndarray] = None) -> np.ndarray:
    """One resident fused launch (kernel 1, or 4 with ``filter_plan``) over
    the device plan ``plan`` -- the column's, or the single-device stacked
    partition plan -- and its staging vector; backfills the LRU from the
    decoded matrix when there are misses (in the ``(partition, page)``
    namespace when ``owner`` gives each page's partition).  Returns the
    uint32 target words on the host."""
    # the decode matrix only exists to backfill the LRU: with no cache --
    # or a warm one (zero misses) -- the ids never leave the card
    want_ids = cache is not None and bool(miss)
    staged_t = _to_device(staged, device)
    buf = _words_buffer(device, n_words)
    if filter_plan is None:
        out = K.fused_gather_decode_bitmap_batch(
            *plan, staged_t, buf, p_pad=p_pad, want_ids=want_ids)
    else:
        from repro_torch.kernels.label_filter import kernel as LK
        fwords = filter_plan.device_bitmap(device, n_words)
        out = LK.fused_gather_decode_filter_bitmap_batch(
            *plan, staged_t, fwords, buf, p_pad=p_pad, want_ids=want_ids)
    if want_ids:
        words, ids = out
        mat = ids.cpu().numpy().astype(np.int64)
        pos_of = {int(p): i for i, p in enumerate(pages)}
        for p in miss:
            i = pos_of[p]
            cache.put(p, mat[i, :col.pages[p].count].copy(),
                      part=None if owner is None else int(owner[i]))
    else:
        words = out
    host_words = words.cpu().numpy().view(np.uint32)
    _pool_words(device, n_words, words)  # reused two dispatches later
    return host_words


def stage_packed(col: DeltaColumn, los, his, pages: np.ndarray, pmask,
                 hits: Dict[int, np.ndarray], miss: Sequence[int]
                 ) -> Tuple[Tuple[np.ndarray, ...], np.ndarray, np.ndarray,
                            int]:
    """The host arrays of one per-dispatch pack dispatch over the sorted
    ``pages`` (``pmask``: as :func:`prune_page_list` returned it): the
    miss pages packed (``m_pad = next_pow2(m)`` rows), the LRU-hit rows
    decoded (``c_pad = next_pow2(hits)`` rows, at least one), and the
    requested-row positions over the ``[miss | cached]`` row order with
    their count.  Returns ``(args, cached, gidx, total)``."""
    ps = col.page_size
    m_pad = next_pow2(len(miss))
    args = _pad_pages(pack_page_list(col, miss), m_pad)
    hit_list = [int(p) for p in pages if int(p) in hits]
    cached = np.zeros((next_pow2(len(hit_list)), ps), np.int32)
    for i, p in enumerate(hit_list):
        d = hits[p]
        cached[i, :len(d)] = d
    # matrix row of each sorted page: misses first, then cached rows
    miss_set = set(miss)
    is_miss = np.fromiter((int(p) in miss_set for p in pages), bool,
                          len(pages))
    base_of_page = np.where(is_miss, np.cumsum(is_miss) - 1,
                            m_pad + np.cumsum(~is_miss) - 1)
    gidx, total = _gather_positions(pages, base_of_page, los, his, ps,
                                    pruned=pmask is not None)
    return args, cached, gidx, total


def _retrieve_pac_batch_packed(col: DeltaColumn, los, his, pages: np.ndarray,
                               pmask, hits: Dict[int, np.ndarray],
                               miss: Sequence[int], cache,
                               target_page_size: int, n_words: int,
                               device: torch.device, filter_plan=None,
                               part_of: Optional[Dict[int, int]] = None
                               ) -> PAC:
    """The per-dispatch pack tail of the fused path: ships what
    :func:`stage_packed` gathers and, with a filter, its RLE lists; one
    ``fused_decode_bitmap_batch`` (or its filtered twin) dispatch.
    ``part_of`` maps a partitioned column's pages to their partitions,
    the LRU namespace of the backfill."""
    args, cached, gidx, total = stage_packed(col, los, his, pages, pmask,
                                             hits, miss)
    shipped = ship_pages(args, device) + (
        _to_device(cached, device), _to_device(gidx, device),
        torch.full((1, 1), total, dtype=torch.int32, device=device))
    if filter_plan is None:
        words, ids = K.fused_decode_bitmap_batch(*shipped, n_words=n_words)
    else:
        from repro_torch.kernels.label_filter import kernel as LK
        words, ids = LK.fused_decode_filter_bitmap_batch(
            *shipped, _to_device(filter_plan.pos, device),
            _to_device(filter_plan.meta, device), filter_plan.program.ops,
            n_words)
    if cache is not None and miss:
        mat = ids.cpu().numpy().astype(np.int64)
        for i, p in enumerate(miss):
            cache.put(p, mat[i, :col.pages[p].count].copy(),
                      part=(part_of or {}).get(p))
    return PAC.from_dense_bitmap(words.cpu().numpy().view(np.uint32),
                                 target_page_size)


def retrieve_pac_batch(col: DeltaColumn, los, his, target_page_size: int,
                       meter=None, engine: str = "cuda",
                       num_targets: Optional[int] = None,
                       fused: Optional[bool] = None,
                       label_filter=None,
                       resident: Optional[bool] = None,
                       delta_ids=None) -> PAC:
    """Batched Definition 2: many row ranges -> one merged (unioned) PAC.

    Kernel engines take the fused decode->bitmap path whenever the target
    id space is known (``num_targets``), the target page size is
    word-aligned, and there are at least ``FUSED_MIN_RANGES`` ranges;
    ``fused`` forces the choice either way.  The host path -- decode +
    ``PAC.from_ids`` -- is the oracle and the numpy route.

    ``label_filter`` (:class:`repro_torch.core.labels.LabelFilter` over
    the target vertex table) pushes a label predicate down: the fused
    path ANDs the predicate inside the dispatch; the host path
    intersects with the filter's PAC.  Label metadata I/O is the caller's
    to charge (see ``neighbor.retrieve_neighbors_batch``).

    ``resident`` picks the fused path's transfer regime (see
    :func:`_retrieve_pac_batch_fused`); None follows ``DEVICE_RESIDENT``.
    The host path's decode follows ``DEVICE_RESIDENT`` only.

    ``delta_ids`` -- the batch's pending neighbor ids from the mutable
    plane (already predicate-filtered by the caller) -- are unioned into
    the returned PAC after the base dispatch: the memtable rows are
    RAM-resident, so they cost no lake I/O and never touch a kernel.
    """
    los = np.asarray(los, np.int64)
    his = np.asarray(his, np.int64)
    if fused is None:
        fused = (engine != "numpy" and num_targets is not None
                 and target_page_size % 32 == 0
                 and len(los) >= FUSED_MIN_RANGES)
    if fused:
        if num_targets is None:
            raise ValueError("fused=True requires num_targets")
        plan = None
        if label_filter is not None:
            plan = label_filter.plan()
            if plan.count != int(num_targets):
                raise ValueError(
                    f"filter covers {plan.count} vertices but the target "
                    f"id space has {num_targets}")
        pac = _retrieve_pac_batch_fused(col, los, his, target_page_size,
                                        int(num_targets), meter, engine,
                                        plan, resident=resident)
    else:
        # the same page-granular pruning hull applies on the host path
        # (pruned pages hold no qualifying ids), so meters agree with the
        # fused path
        qual = label_filter.qual_range() if label_filter is not None \
            else None
        ids = decode_row_ranges(col, los, his, meter, engine, qual=qual)
        pac = PAC.from_ids(np.unique(ids), target_page_size) if ids.size \
            else PAC(target_page_size)
        if label_filter is not None:
            pac = pac.intersect(label_filter.pac(target_page_size, engine))
    if delta_ids is not None and len(delta_ids):
        pac = pac.union(PAC.from_ids(np.asarray(delta_ids, np.int64),
                                     target_page_size))
    return pac


def retrieve_pac(col: DeltaColumn, lo: int, hi: int, target_page_size: int,
                 meter=None, engine: str = "cuda") -> PAC:
    """Kernel-engine neighbor retrieval: rows [lo, hi) -> PAC.

    Charges the same page bytes as the numpy path (the I/O plane is
    identical; only the decode engine differs).
    """
    return retrieve_pac_batch(col, np.array([lo]), np.array([hi]),
                              target_page_size, meter, engine=engine)


#: word padding of the single-range bitmaps (the JAX package's WORD_TILE:
#: 64 words, 2048 bits)
WORD_TILE = 64


def _host_bitmap(ids: np.ndarray, base: int, n_words: int) -> np.ndarray:
    """The numpy oracle of the single-range entries: uint32[n_words] with
    the bit of every id in ``[base, base + 32 * n_words)`` set."""
    rel = np.asarray(ids, np.int64) - base
    plane = np.zeros(32 * n_words, bool)
    plane[rel[(rel >= 0) & (rel < 32 * n_words)]] = True
    return np.packbits(plane, bitorder="little").view(np.uint32)


def ids_to_bitmap(ids: np.ndarray, base: int, n_words: int,
                  engine: str = "cuda") -> np.ndarray:
    """uint32[n_words] over ``[base, base + 32 * n_words)`` (``base``
    32-aligned) with the bit of every id set: ``bitmap`` on the kernel
    engines.  The JAX package's contract asks for sorted ids; any order
    and multiplicity gives the set here."""
    assert base % 32 == 0
    if engine == "numpy":
        return _host_bitmap(ids, base, n_words)
    device = engine_device(engine)
    ids_t = _to_device(np.ascontiguousarray(ids, np.int32), device)
    words = K.bitmap(ids_t, ids_t.shape[0], base,
                     next_multiple(n_words, WORD_TILE))
    return words.cpu().numpy().view(np.uint32)[:n_words]


def decode_range_to_bitmap(col: DeltaColumn, lo: int, hi: int, base: int,
                           n_words: int, engine: str = "cuda") -> np.ndarray:
    """Delta rows ``[lo, hi)`` -> uint32[n_words] over ``[base, base + 32 *
    n_words)`` (``base`` 32-aligned): ``fused_decode_bitmap`` on the kernel
    engines, the ids never leaving the card.  ``lo`` must be page-aligned
    and ``hi`` page-aligned or the column's end (whole-column scans are
    the common case).  The rows need not be sorted."""
    assert base % 32 == 0
    ps = col.page_size
    assert lo % ps == 0 and (hi % ps == 0 or hi == col.count), \
        "fused path requires page-aligned ranges"
    p0, p1 = lo // ps, -(-hi // ps)
    if engine == "numpy":
        ids = [delta_decode_page(col.pages[p]) for p in range(p0, p1)]
        return _host_bitmap(np.concatenate(ids) if ids else
                            np.zeros(0, np.int64), base, n_words)
    device = engine_device(engine)
    words = K.fused_decode_bitmap(
        *ship_pages(pack_pages(col, p0, p1), device), base=base,
        page_size=ps, words_out=next_multiple(n_words, WORD_TILE))
    return words.cpu().numpy().view(np.uint32)[:n_words]
