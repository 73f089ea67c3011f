"""Page-aligned collections (PAC) -- paper Definition 1.

A PAC is a list of up to ``m`` collections, one per data page of a target
vertex-table column; collection ``C_i`` holds the internal IDs falling in
page ``i``.  Non-empty collections only are retained (real graphs are
sparse, so most pages are irrelevant).  Each collection is represented as a
**bitmap** (paper §4.3, following selection-pushdown practice): bit ``j`` of
page ``i`` set <=> internal ID ``i * page_size + j`` is in the collection.

Bitmaps are arrays of uint32 words, 32 bits per word, little-endian bit
order within the word -- the exact layout the CUDA kernels produce.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .encoding import DEFAULT_PAGE_SIZE

_BIT = np.uint32(1)


def words_per_page(page_size: int) -> int:
    return -(-page_size // 32)


def ids_to_bitmap(ids: np.ndarray, base: int, page_size: int) -> np.ndarray:
    """Bitmap for one page: ids must lie in [base, base + page_size)."""
    rel = np.asarray(ids, np.int64) - base
    words = np.zeros(words_per_page(page_size), np.uint32)
    np.bitwise_or.at(words, rel >> 5, _BIT << (rel & 31).astype(np.uint32))
    return words


def bitmap_to_ids(words: np.ndarray, base: int) -> np.ndarray:
    """Set-bit positions (ascending) offset by ``base``."""
    w = np.asarray(words, np.uint32)
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    return base + np.flatnonzero(bits).astype(np.int64)


def popcount(words: np.ndarray) -> int:
    return int(np.unpackbits(np.asarray(words, np.uint32).view(np.uint8)).sum())


class PAC:
    """Sparse page->bitmap mapping for one target table."""

    def __init__(self, page_size: int = DEFAULT_PAGE_SIZE,
                 bitmaps: Dict[int, np.ndarray] | None = None):
        self.page_size = page_size
        self.bitmaps: Dict[int, np.ndarray] = bitmaps or {}

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_ids(cls, ids: np.ndarray,
                 page_size: int = DEFAULT_PAGE_SIZE) -> "PAC":
        ids = np.asarray(ids, np.int64)
        pac = cls(page_size)
        if ids.size == 0:
            return pac
        pages = ids // page_size
        # ids from neighbor retrieval are sorted; group contiguously.
        boundaries = np.flatnonzero(np.diff(pages)) + 1
        splits = np.split(ids, boundaries)
        for chunk in splits:
            p = int(chunk[0] // page_size)
            pac.bitmaps[p] = ids_to_bitmap(chunk, p * page_size, page_size)
        return pac

    @classmethod
    def from_bitmap_planes(cls, planes: np.ndarray,
                           page_size: int = DEFAULT_PAGE_SIZE,
                           pages: np.ndarray | None = None) -> "PAC":
        """PAC from per-page bitmap planes (the fused kernels' output).

        ``planes`` is ``uint32[n, words_per_page(page_size)]``; row ``i``
        is the bitmap of page ``pages[i]`` (default: page ``i``).  Empty
        planes are dropped -- the kernel writes the dense plane stack, the
        PAC keeps only the sparse non-empty page set.
        """
        planes = np.ascontiguousarray(planes, np.uint32)
        if planes.ndim != 2 or planes.shape[1] != words_per_page(page_size):
            raise ValueError(
                f"planes must be [n, {words_per_page(page_size)}] for "
                f"page_size={page_size}, got {planes.shape}")
        if pages is None:
            pages = np.arange(planes.shape[0], dtype=np.int64)
        nonempty = planes.any(axis=1)
        pac = cls(page_size)
        for p, plane in zip(np.asarray(pages, np.int64)[nonempty],
                            planes[nonempty]):
            pac.bitmaps[int(p)] = plane.copy()
        return pac

    @classmethod
    def from_dense_bitmap(cls, words: np.ndarray,
                          page_size: int = DEFAULT_PAGE_SIZE) -> "PAC":
        """PAC from one dense bitmap over ``[0, 32 * len(words))``.

        Requires ``page_size % 32 == 0`` so page boundaries fall on word
        boundaries; the tail is zero-padded to a whole plane.
        """
        if page_size % 32:
            raise ValueError("page_size must be a multiple of 32")
        words = np.asarray(words, np.uint32)
        wpp = words_per_page(page_size)
        pad = (-len(words)) % wpp
        if pad:
            words = np.concatenate([words, np.zeros(pad, np.uint32)])
        return cls.from_bitmap_planes(words.reshape(-1, wpp), page_size)

    @classmethod
    def from_intervals(cls, starts: np.ndarray, ends: np.ndarray, n: int,
                       page_size: int = DEFAULT_PAGE_SIZE) -> "PAC":
        """PAC covering half-open [start, end) ranges (label filtering)."""
        pac = cls(page_size)
        wpp = words_per_page(page_size)
        for s, e in zip(np.asarray(starts, np.int64),
                        np.asarray(ends, np.int64)):
            s, e = int(s), int(min(e, n))
            if e <= s:
                continue
            for p in range(s // page_size, (e - 1) // page_size + 1):
                base = p * page_size
                lo = max(s - base, 0)
                hi = min(e - base, page_size)
                bm = pac.bitmaps.get(p)
                if bm is None:
                    bm = np.zeros(wpp, np.uint32)
                    pac.bitmaps[p] = bm
                idx = np.arange(lo, hi, dtype=np.int64)
                np.bitwise_or.at(bm, idx >> 5,
                                 _BIT << (idx & 31).astype(np.uint32))
        return pac

    # -- set algebra (page-wise word ops) ------------------------------------
    def intersect(self, other: "PAC") -> "PAC":
        assert self.page_size == other.page_size
        out = PAC(self.page_size)
        for p in self.bitmaps.keys() & other.bitmaps.keys():
            w = self.bitmaps[p] & other.bitmaps[p]
            if w.any():
                out.bitmaps[p] = w
        return out

    def union(self, other: "PAC") -> "PAC":
        assert self.page_size == other.page_size
        out = PAC(self.page_size)
        for p in self.bitmaps.keys() | other.bitmaps.keys():
            a = self.bitmaps.get(p)
            b = other.bitmaps.get(p)
            out.bitmaps[p] = (a | b) if (a is not None and b is not None) \
                else (a if a is not None else b).copy()
        return out

    # -- accessors ------------------------------------------------------------
    def pages(self) -> List[int]:
        return sorted(self.bitmaps)

    def count(self) -> int:
        return sum(popcount(w) for w in self.bitmaps.values())

    def to_ids(self) -> np.ndarray:
        parts = [bitmap_to_ids(self.bitmaps[p], p * self.page_size)
                 for p in self.pages()]
        return (np.concatenate(parts) if parts else np.zeros(0, np.int64))

    def select(self, page_values: Dict[int, np.ndarray]) -> np.ndarray:
        """Selection pushdown: gather values whose bit is set, per page."""
        out = []
        for p in self.pages():
            vals = page_values[p]
            rel = bitmap_to_ids(self.bitmaps[p], 0)
            rel = rel[rel < len(vals)]
            out.append(np.asarray(vals)[rel])
        return (np.concatenate(out) if out else np.zeros(0))

    def __len__(self) -> int:
        return len(self.bitmaps)

    def __eq__(self, other) -> bool:
        if not isinstance(other, PAC) or self.page_size != other.page_size:
            return NotImplemented
        if self.bitmaps.keys() != other.bitmaps.keys():
            return False
        return all(np.array_equal(w, other.bitmaps[p])
                   for p, w in self.bitmaps.items())

    # mutable value semantics: equality by content, deliberately unhashable
    __hash__ = None

    def __repr__(self) -> str:
        return (f"PAC(pages={len(self.bitmaps)}, ids={self.count()}, "
                f"page_size={self.page_size})")
