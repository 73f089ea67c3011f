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

Two transfer regimes, with the same ids, PACs and IOMeter:

* **device-resident** (the default): the column crosses to the card
  once, as its unpack plan (``PackedPages.device_plan``); a dispatch
  ships one int32 vector and the pages are gathered and decoded there
  (``gather_decode``, the fused resident kernels);
* **per-dispatch pack** (``REPRO_DEVICE_RESIDENT=0``, or
  ``resident=False`` on the fused entries): the miss pages are gathered
  on the host and shipped packed with every dispatch (``delta_decode``,
  ``fused_decode_bitmap_batch`` and its filtered twin); LRU-hit rows
  ship already decoded, and a label predicate ships as its RLE lists.

With a decoded-page LRU attached (:mod:`repro_torch.core.page_cache`)
only the miss pages are charged to the ``IOMeter``, and the decoded
matrix comes back to the host only when misses need backfilling.

Engines: ``numpy`` (the host oracle), ``torch`` (the kernels' plain
PyTorch versions, on the CPU) and ``cuda`` (the kernels, on ``cuda:0``).
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

#: (device, n_words) -> ring of the two most recent dispatches' bitmap
#: buffers.  A dispatch writes into the *older* of two pooled buffers,
#: never the most recent output, so two dispatches in flight never share
#: one buffer; steady state settles at two buffers per class.
_WORDS_POOL: Dict[Tuple[str, int], "deque"] = {}


def engine_device(engine: str) -> torch.device:
    """The device a kernel engine runs on: ``torch`` -> the CPU (plain
    versions), ``cuda`` -> ``cuda:0`` (the kernels).  ``cuda`` with no
    card raises: nothing falls back to the CPU."""
    if engine == "torch":
        return torch.device("cpu")
    if engine == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("engine='cuda' needs a CUDA device and none "
                               "is available (engine='torch' runs the "
                               "plain versions on the CPU)")
        return torch.device("cuda", 0)
    raise ValueError(f"unknown engine {engine!r}; want one of {ENGINES}")


def _words_buffer(device: torch.device, n_words: int) -> torch.Tensor:
    ring = _WORDS_POOL.get((str(device), n_words))
    if ring is not None and len(ring) >= 2:
        return ring.popleft()
    return torch.empty(n_words, dtype=torch.int32, device=device)


def _pool_words(device: torch.device, n_words: int,
                buf: torch.Tensor) -> None:
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
    the (PAGE_CLASS_MIN-rounded) whole column -- a gather cannot name
    more distinct rows than the column has."""
    return min(size_class(n, PAGE_CLASS_MIN),
               next_multiple(stack_rows, PAGE_CLASS_MIN))


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
    entries only)."""
    ps = col.page_size
    n = len(pages)
    if engine == "numpy":
        out = np.zeros((n, ps), np.int64)
        for i, p in enumerate(pages):
            d = delta_decode_page(col.pages[p])
            out[i, :len(d)] = d
        return out
    device = engine_device(engine)
    if DEVICE_RESIDENT:
        packed = pack_column(col)
        plan = packed.device_plan(device)
        idx = _page_index_vector(pages, len(col.pages))
        ids = K.gather_decode(*plan, _to_device(idx, device))
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
    """
    ps = col.page_size
    n = len(pages)
    if n == 0:
        return np.zeros((0, ps), np.int64)
    if engine != "numpy":
        engine_device(engine)   # an unusable engine raises before charging
    cache = live_cache(col)
    pages_arr = np.asarray(pages, np.int64)
    if cache is None:
        _charge_pages(col, pages, meter)
        return _decode_page_matrix(col, pages, engine)
    hits, miss = cache.split(pages)
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
            cache.put(p, mat[i, :col.pages[p].count].copy())
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
    # page-granular statistics pushdown: pages whose zone map cannot
    # intersect the predicate's hull are never staged, decoded or charged
    qual = filter_plan.qual_range() if filter_plan is not None else None
    pages, pmask = prune_page_list(col, pages, qual)
    if pages.size == 0:
        return PAC(target_page_size)
    if resident is None:
        resident = DEVICE_RESIDENT
    cache = live_cache(col)
    if cache is None:
        hits, miss = {}, [int(p) for p in pages]
    else:
        hits, miss = cache.split(pages)
    _charge_pages(col, miss, meter)
    n_words = -(-num_targets // 32)
    if not resident:
        return _retrieve_pac_batch_packed(col, los, his, pages, pmask, hits,
                                          miss, cache, target_page_size,
                                          n_words, device, filter_plan)
    plan = pack_column(col).device_plan(device)
    staged, p_pad, _ = stage_resident(col, los, his, pages, pmask)
    staged_t = _to_device(staged, device)
    # the decode matrix only exists to backfill the LRU: with no cache --
    # or a warm one (zero misses) -- the ids never leave the card
    want_ids = cache is not None and bool(miss)
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
            cache.put(p, mat[pos_of[p], :col.pages[p].count].copy())
    else:
        words = out
    host_words = words.cpu().numpy().view(np.uint32)
    _pool_words(device, n_words, words)  # reused two dispatches later
    return PAC.from_dense_bitmap(host_words, target_page_size)


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
                               device: torch.device, filter_plan=None) -> PAC:
    """The per-dispatch pack tail of the fused path: ships what
    :func:`stage_packed` gathers and, with a filter, its RLE lists; one
    ``fused_decode_bitmap_batch`` (or its filtered twin) dispatch."""
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
            cache.put(p, mat[i, :col.pages[p].count].copy())
    return PAC.from_dense_bitmap(words.cpu().numpy().view(np.uint32),
                                 target_page_size)


def retrieve_pac_batch(col: DeltaColumn, los, his, target_page_size: int,
                       meter=None, engine: str = "cuda",
                       num_targets: Optional[int] = None,
                       fused: Optional[bool] = None,
                       label_filter=None,
                       resident: Optional[bool] = None) -> PAC:
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
        return _retrieve_pac_batch_fused(col, los, his, target_page_size,
                                         int(num_targets), meter, engine,
                                         plan, resident=resident)
    # the same page-granular pruning hull applies on the host path (pruned
    # pages hold no qualifying ids), so meters agree with the fused path
    qual = label_filter.qual_range() if label_filter is not None else None
    ids = decode_row_ranges(col, los, his, meter, engine, qual=qual)
    pac = PAC.from_ids(np.unique(ids), target_page_size) if ids.size \
        else PAC(target_page_size)
    if label_filter is not None:
        pac = pac.intersect(label_filter.pac(target_page_size, engine))
    return pac


def retrieve_pac(col: DeltaColumn, lo: int, hi: int, target_page_size: int,
                 meter=None, engine: str = "cuda") -> PAC:
    """Kernel-engine neighbor retrieval: rows [lo, hi) -> PAC.

    Charges the same page bytes as the numpy path (the I/O plane is
    identical; only the decode engine differs).
    """
    return retrieve_pac_batch(col, np.array([lo]), np.array([hi]),
                              target_page_size, meter, engine=engine)
