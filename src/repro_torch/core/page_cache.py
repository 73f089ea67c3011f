"""Cross-query decoded-page LRU (the batched plane's warm-tick layer).

Serving re-touches the same hot pages tick after tick.  A
:class:`DecodedPageCache` is a per-column, capacity-bounded LRU of
**decoded** pages: every batched decode path (numpy
``Column._decode_pages``, kernel ``pac_decode.ops.decode_page_list`` /
``decode_row_ranges`` and the fused decode->bitmap entry) consults it and

* decodes / fetches only the cache-miss pages,
* charges the :class:`~repro_torch.core.storage.IOMeter` for **misses
  only** (a hit is RAM-resident -- no lake I/O), with requests counted
  per contiguous run of miss pages,
* inserts the freshly decoded miss pages back, evicting
  least-recently-used entries past capacity.

The cache maps ``page index -> decoded int64 row array`` and keeps
hit/miss/eviction counters.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class DecodedPageCache:
    """Capacity-bounded LRU of decoded data pages for one column."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._pages: "OrderedDict[object, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        #: column version the cached decodes correspond to (see
        #: :func:`live_cache`); bumped columns drop every entry.
        self.version = 0

    @staticmethod
    def _key(page: int, part: Optional[int]):
        """Entry key: the plain page index on the monolithic paths,
        ``(partition, page)`` on the partition plane, so entries are
        namespaced per partition (a version bump clears everything)."""
        return page if part is None else (part, page)

    def get(self, page: int, part: Optional[int] = None
            ) -> Optional[np.ndarray]:
        """Decoded rows of ``page`` or None; counts the probe and bumps
        recency on hit."""
        key = self._key(page, part)
        arr = self._pages.get(key)
        if arr is None:
            self.misses += 1
            return None
        self._pages.move_to_end(key)
        self.hits += 1
        return arr

    def put(self, page: int, rows: np.ndarray,
            part: Optional[int] = None) -> None:
        """Insert (or refresh) a decoded page, evicting LRU past capacity."""
        key = self._key(page, part)
        if key in self._pages:
            self._pages.move_to_end(key)
            self._pages[key] = rows
            return
        self._pages[key] = rows
        while len(self._pages) > self.capacity:
            self._pages.popitem(last=False)
            self.evictions += 1

    def split(self, pages: Sequence[int],
              owner: Optional[Sequence[int]] = None
              ) -> Tuple[Dict[int, np.ndarray], List[int]]:
        """One probe per page: ``(hit page -> rows, ordered miss list)``.

        ``owner`` (parallel to ``pages``) carries each page's partition on
        the partition plane: the probes go to the partition namespace, the
        hits and misses are still reported by global page."""
        hits: Dict[int, np.ndarray] = {}
        miss: List[int] = []
        for i, p in enumerate(pages):
            arr = self.get(int(p), None if owner is None else int(owner[i]))
            if arr is None:
                miss.append(int(p))
            else:
                hits[int(p)] = arr
        return hits, miss

    def snapshot(self) -> Tuple:
        """Point-in-time state for a speculative consumer that must be
        able to rewind exactly (the pipelined serving engine): recency
        drives eviction, so entry order is part of the state and the
        OrderedDict is shallow-copied (decoded rows are never mutated in
        place)."""
        return (OrderedDict(self._pages), self.hits, self.misses,
                self.evictions, self.version)

    def restore(self, state: Tuple) -> None:
        """Rewind to a :meth:`snapshot` (copying again, so one snapshot
        can back out several speculations)."""
        pages, self.hits, self.misses, self.evictions, self.version = state
        self._pages = OrderedDict(pages)

    def clear(self) -> None:
        self._pages.clear()

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = 0

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._pages),
                "capacity": self.capacity}

    def __len__(self) -> int:
        return len(self._pages)

    def __contains__(self, page: int) -> bool:
        return page in self._pages

    def __repr__(self) -> str:
        return (f"DecodedPageCache(size={len(self._pages)}/{self.capacity}, "
                f"hits={self.hits}, misses={self.misses}, "
                f"evictions={self.evictions})")


def attach_page_cache(col, capacity: int) -> DecodedPageCache:
    """Attach a fresh LRU to a delta column (idempotent on capacity match).

    Accepts either a :class:`~repro_torch.core.encoding.DeltaColumn` or a
    :class:`~repro_torch.core.table.DeltaIntColumn` wrapper.
    """
    enc = getattr(col, "encoded", col)
    cache = getattr(enc, "page_cache", None)
    if cache is not None and cache.capacity == capacity:
        return cache
    cache = DecodedPageCache(capacity)
    cache.version = getattr(enc, "version", 0)
    enc.page_cache = cache
    return cache


def live_cache(col) -> Optional[DecodedPageCache]:
    """The column's decoded-page LRU, coherent with its current version.

    Every decode path consults the cache through this helper: when the
    column's write counter moved since the cache last served (an in-place
    page rewrite), the stale decodes are dropped wholesale before any
    probe, so mutation can never serve stale rows.  Returns None when no
    cache is attached.
    """
    cache = getattr(col, "page_cache", None)
    if cache is None:
        return None
    v = getattr(col, "version", 0)
    if cache.version != v:
        cache.clear()
        cache.version = v
    return cache


def miss_runs(pages: Sequence[int]) -> int:
    """Read requests for a sorted page list: consecutive pages coalesce
    into one ranged GET (same convention as ``page_set_for_ranges``)."""
    if not len(pages):
        return 0
    return 1 + int(np.sum(np.diff(np.asarray(pages, np.int64)) > 1))
