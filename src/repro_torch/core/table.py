"""Parquet-like columnar container.

A :class:`Table` is one logical row group: named column chunks, each split
into fixed-size data pages (the paper's minimum I/O unit, Fig. 2).  Column
chunks carry page statistics for predicate pushdown.  Encodings:

* ``PlainColumn``    -- PLAIN fixed-width values.
* ``StringColumn``   -- PLAIN BYTE_ARRAY (offsets + utf-8 payload).
* ``DeltaIntColumn`` -- DELTA_BINARY_PACKED (see encoding.py).
* ``BoolRleColumn``  -- RLE boolean (interval position list).
* ``TokensColumn``   -- ragged int32 lists (offsets + values), used for the
                        document-token payload of the LM data pipeline.

Every read path is page-granular and reports bytes touched to an optional
:class:`repro_torch.core.storage.IOMeter`, so data-lake I/O cost is modeled
exactly as "pages fetched x page bytes" (paper §4.1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .encoding import (DEFAULT_PAGE_SIZE, DeltaColumn, RleColumn,
                       delta_decode_column, delta_encode_column,
                       rle_decode_bool, rle_encode_bool)

NUMPY_DTYPES = {
    "int32": np.int32, "int64": np.int64,
    "float32": np.float32, "float64": np.float64, "bool": np.bool_,
}


class Column:
    """Abstract column chunk."""

    name: str
    count: int
    page_size: int

    def nbytes(self) -> int:
        raise NotImplementedError

    def read_all(self, meter=None) -> np.ndarray:
        raise NotImplementedError

    def read_range(self, lo: int, hi: int, meter=None) -> np.ndarray:
        """Decode rows [lo, hi), charging whole pages overlapping the range."""
        raise NotImplementedError

    def _decode_pages(self, pages: Sequence[int], meter=None):
        """Decode a sorted page list, charging each page once."""
        raise NotImplementedError(type(self))

    def read_row_ranges(self, los, his, meter=None) -> List[np.ndarray]:
        """Batched range reads with page de-duplication.

        Pages touched by several ranges are fetched/decoded/charged once;
        requests are counted per contiguous page run (what a real reader
        would send).  This is the vectorized access pattern of interval
        queries (BI-2): intervals of sorted vertices map to contiguous edge
        ranges sharing pages.
        """
        los = np.asarray(los, np.int64)
        his = np.asarray(his, np.int64)
        ps = self.page_size
        pages = set()
        for lo, hi in zip(los, his):
            if hi > lo:
                pages.update(range(int(lo) // ps, int(hi - 1) // ps + 1))
        if not pages:
            return [np.zeros(0, np.int64) for _ in los]
        plist = sorted(pages)
        decoded = self._decode_pages(plist, meter)
        out = []
        for lo, hi in zip(los, his):
            if hi <= lo:
                out.append(decoded[plist[0]][:0])
                continue
            parts = []
            for p in range(int(lo) // ps, int(hi - 1) // ps + 1):
                vals = decoded[p]
                s = max(int(lo) - p * ps, 0)
                e = min(int(hi) - p * ps, len(vals))
                parts.append(vals[s:e])
            out.append(np.concatenate(parts))
        return out

    def read_rows_concat(self, los, his, meter=None) -> np.ndarray:
        """Concatenation of rows over many [lo, hi) ranges, fully
        vectorized: page set, decode, and gather are all numpy ops (the
        inner loop of vectorized multi-hop expansion, e.g. IC-8/BI-2)."""
        los = np.asarray(los, np.int64)
        his = np.asarray(his, np.int64)
        lengths = np.maximum(his - los, 0)
        total = int(lengths.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        ps = self.page_size
        keep = lengths > 0
        l, h = los[keep], his[keep]
        # unique page list via merged page intervals (numpy-only: sort,
        # running-max to find disjoint segments, ragged arange expansion)
        p0, p1 = l // ps, (h - 1) // ps
        order = np.argsort(p0, kind="stable")
        s, e = p0[order], p1[order] + 1
        cummax = np.maximum.accumulate(e)
        new_seg = np.ones(len(s), bool)
        new_seg[1:] = s[1:] > cummax[:-1]
        seg_idx = np.flatnonzero(new_seg)
        seg_start = s[seg_idx]
        seg_end = np.maximum.reduceat(cummax, seg_idx)
        seg_len = seg_end - seg_start
        tot = int(seg_len.sum())
        w = np.arange(tot) - np.repeat(np.cumsum(seg_len) - seg_len, seg_len)
        pages = (np.repeat(seg_start, seg_len) + w).tolist()
        decoded = self._decode_pages(pages, meter)
        plist = np.asarray(pages, np.int64)
        sizes = np.asarray([len(decoded[p]) for p in pages], np.int64)
        bases = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        concat = np.concatenate([np.asarray(decoded[p]) for p in pages])
        # absolute row index for every output element
        rep = np.repeat(np.arange(len(l)), lengths[keep])
        within = np.arange(total) - np.repeat(
            np.cumsum(lengths[keep]) - lengths[keep], lengths[keep])
        rows = l[rep] + within
        page_of = rows // ps
        pidx = np.searchsorted(plist, page_of)
        pos = bases[pidx] + (rows - page_of * ps)
        return concat[pos]

    def n_pages(self) -> int:
        return -(-self.count // self.page_size) if self.count else 0

    def _charge(self, meter, nbytes: int, n_requests: int = 1) -> None:
        if meter is not None:
            meter.record(nbytes, n_requests)


@dataclasses.dataclass
class PageStats:
    vmin: float
    vmax: float


class PlainColumn(Column):
    def __init__(self, name: str, values: np.ndarray,
                 page_size: int = DEFAULT_PAGE_SIZE):
        self.name = name
        self.values = np.ascontiguousarray(values)
        self.count = len(values)
        self.page_size = page_size
        self._stats: Optional[List[PageStats]] = None

    def nbytes(self) -> int:
        return self.values.nbytes

    def page_stats(self) -> List[PageStats]:
        if self._stats is None:
            ps = self.page_size
            self._stats = [
                PageStats(float(self.values[i:i + ps].min()),
                          float(self.values[i:i + ps].max()))
                for i in range(0, self.count, ps)
            ]
        return self._stats

    def read_all(self, meter=None) -> np.ndarray:
        self._charge(meter, self.nbytes())
        return self.values

    def read_range(self, lo: int, hi: int, meter=None) -> np.ndarray:
        if hi <= lo:
            return self.values[:0]
        ps = self.page_size
        p0, p1 = lo // ps, (hi - 1) // ps + 1
        span_lo, span_hi = p0 * ps, min(p1 * ps, self.count)
        self._charge(meter,
                     (span_hi - span_lo) * self.values.dtype.itemsize, 1)
        return self.values[lo:hi]

    def read_pages(self, pages: Sequence[int], meter=None) -> Dict[int, np.ndarray]:
        """Fetch a set of (possibly non-contiguous) pages -> page values."""
        out = {}
        ps = self.page_size
        nreq = 0
        nbytes = 0
        for p in pages:
            s, e = p * ps, min((p + 1) * ps, self.count)
            out[p] = self.values[s:e]
            nbytes += (e - s) * self.values.dtype.itemsize
            nreq += 1
        self._charge(meter, nbytes, max(nreq, 1))
        return out

    def _decode_pages(self, pages: Sequence[int], meter=None):
        return self.read_pages(pages, meter)


class StringColumn(Column):
    """PLAIN BYTE_ARRAY: int32 offsets + utf-8 payload."""

    def __init__(self, name: str, strings: Sequence[str],
                 page_size: int = DEFAULT_PAGE_SIZE):
        self.name = name
        self.count = len(strings)
        self.page_size = page_size
        payload = bytearray()
        offsets = np.zeros(self.count + 1, np.int64)
        for i, s in enumerate(strings):
            b = s.encode("utf-8")
            payload.extend(b)
            offsets[i + 1] = offsets[i] + len(b)
        self.offsets = offsets
        self.payload = bytes(payload)

    @classmethod
    def from_parts(cls, name: str, offsets: np.ndarray, payload: bytes,
                   page_size: int = DEFAULT_PAGE_SIZE) -> "StringColumn":
        obj = cls.__new__(cls)
        obj.name = name
        obj.offsets = np.asarray(offsets, np.int64)
        obj.payload = payload
        obj.count = len(obj.offsets) - 1
        obj.page_size = page_size
        return obj

    def nbytes(self) -> int:
        # 4B offset per row (as stored) + payload
        return 4 * self.count + len(self.payload)

    def get(self, i: int) -> str:
        s, e = self.offsets[i], self.offsets[i + 1]
        return self.payload[s:e].decode("utf-8")

    def read_all(self, meter=None) -> List[str]:
        self._charge(meter, self.nbytes())
        return [self.get(i) for i in range(self.count)]

    def read_range(self, lo: int, hi: int, meter=None) -> List[str]:
        if hi <= lo:
            return []
        ps = self.page_size
        p0, p1 = lo // ps, (hi - 1) // ps + 1
        s, e = p0 * ps, min(p1 * ps, self.count)
        nbytes = 4 * (e - s) + int(self.offsets[e] - self.offsets[s])
        self._charge(meter, nbytes, 1)
        return [self.get(i) for i in range(lo, hi)]


class DeltaIntColumn(Column):
    def __init__(self, name: str, values: np.ndarray,
                 page_size: int = DEFAULT_PAGE_SIZE):
        self.name = name
        self.count = len(values)
        self.page_size = page_size
        self.encoded: DeltaColumn = delta_encode_column(values, page_size)

    def nbytes(self) -> int:
        return self.encoded.nbytes()

    def read_all(self, meter=None) -> np.ndarray:
        self._charge(meter, self.nbytes())
        return delta_decode_column(self.encoded)

    def read_range(self, lo: int, hi: int, meter=None) -> np.ndarray:
        # routed through _decode_pages so the single-vertex path shares
        # the decoded-page LRU (and its miss-only charging) with the
        # batched paths -- engines must meter identically either way
        if hi <= lo:
            return np.zeros(0, np.int64)
        ps = self.page_size
        p0, p1 = lo // ps, (hi - 1) // ps + 1
        decoded = self._decode_pages(list(range(p0, p1)), meter)
        joined = np.concatenate([decoded[p] for p in range(p0, p1)])
        return joined[lo - p0 * ps: hi - p0 * ps]

    def _decode_pages(self, pages: Sequence[int], meter=None):
        from .encoding import delta_decode_page
        from .page_cache import live_cache, miss_runs
        from .partition import live_partitions
        cache = live_cache(self.encoded)
        part_of = {}
        if cache is None:
            out, miss = {}, [int(p) for p in pages]
        else:
            # a partitioned column's LRU entries live in the (partition,
            # page) namespace, the one the kernel routes probe and fill
            parts = live_partitions(self.encoded)
            owner = (parts.part_of_pages(np.asarray(pages, np.int64))
                     if parts is not None else None)
            if owner is not None:
                part_of = {int(p): int(o) for p, o in zip(pages, owner)}
            out, miss = cache.split(pages, owner=owner)
        if miss:
            nbytes = sum(self.encoded.pages[p].nbytes() for p in miss)
            self._charge(meter, nbytes, miss_runs(miss))
            for p in miss:
                d = delta_decode_page(self.encoded.pages[p])
                out[p] = d
                if cache is not None:
                    cache.put(p, d, part=part_of.get(p))
        return out


class BoolRleColumn(Column):
    def __init__(self, name: str, values: np.ndarray,
                 page_size: int = DEFAULT_PAGE_SIZE):
        self.name = name
        self.count = len(values)
        self.page_size = page_size
        self.encoded: RleColumn = rle_encode_bool(values)

    def nbytes(self) -> int:
        return self.encoded.nbytes()

    def read_all(self, meter=None) -> np.ndarray:
        self._charge(meter, self.nbytes())
        return rle_decode_bool(self.encoded)

    def read_range(self, lo: int, hi: int, meter=None) -> np.ndarray:
        # interval metadata is tiny; charge it wholesale (it is the point
        # of RLE that the entire column's metadata is a few KB).
        self._charge(meter, self.nbytes(), 1)
        return rle_decode_bool(self.encoded)[lo:hi]


class BoolPlainColumn(PlainColumn):
    """Baseline 'binary (plain)' of the paper: one byte per row."""

    def __init__(self, name: str, values: np.ndarray,
                 page_size: int = DEFAULT_PAGE_SIZE):
        super().__init__(name, np.asarray(values, np.bool_), page_size)


class TokensColumn(Column):
    """Ragged int32 token lists (offsets + flat values)."""

    def __init__(self, name: str, lists: Sequence[np.ndarray],
                 page_size: int = DEFAULT_PAGE_SIZE):
        self.name = name
        self.count = len(lists)
        self.page_size = page_size
        self.offsets = np.zeros(self.count + 1, np.int64)
        for i, l in enumerate(lists):
            self.offsets[i + 1] = self.offsets[i] + len(l)
        self.values = (np.concatenate([np.asarray(l, np.int32) for l in lists])
                       if lists else np.zeros(0, np.int32))

    @classmethod
    def from_parts(cls, name: str, offsets: np.ndarray, values: np.ndarray,
                   page_size: int = DEFAULT_PAGE_SIZE) -> "TokensColumn":
        obj = cls.__new__(cls)
        obj.name, obj.page_size = name, page_size
        obj.offsets = np.asarray(offsets, np.int64)
        obj.values = np.asarray(values, np.int32)
        obj.count = len(obj.offsets) - 1
        return obj

    def nbytes(self) -> int:
        return 4 * self.count + self.values.nbytes

    def get(self, i: int) -> np.ndarray:
        return self.values[self.offsets[i]:self.offsets[i + 1]]

    def read_all(self, meter=None) -> List[np.ndarray]:
        self._charge(meter, self.nbytes())
        return [self.get(i) for i in range(self.count)]

    def read_range(self, lo: int, hi: int, meter=None) -> List[np.ndarray]:
        if hi <= lo:
            return []
        nbytes = 4 * (hi - lo) + 4 * int(self.offsets[hi] - self.offsets[lo])
        self._charge(meter, nbytes, 1)
        return [self.get(i) for i in range(lo, hi)]

    def read_rows(self, rows: np.ndarray, meter=None) -> List[np.ndarray]:
        """The token lists of ``rows``, charged as one request each:
        4 bytes of offset and 4 a token."""
        rows = np.asarray(rows, np.int64)
        nbytes = 4 * len(rows) + 4 * int(
            (self.offsets[rows + 1] - self.offsets[rows]).sum())
        self._charge(meter, nbytes, len(rows))
        return [self.get(int(i)) for i in rows]


@dataclasses.dataclass
class Table:
    """One logical row group of named column chunks."""

    name: str
    num_rows: int
    page_size: int = DEFAULT_PAGE_SIZE
    columns: Dict[str, Column] = dataclasses.field(default_factory=dict)

    def add(self, col: Column) -> "Table":
        if col.count != self.num_rows:
            raise ValueError(
                f"column {col.name}: {col.count} rows != table {self.num_rows}")
        self.columns[col.name] = col
        return self

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns.values())

    def column_names(self) -> List[str]:
        return list(self.columns)

    def n_pages(self) -> int:
        return -(-self.num_rows // self.page_size) if self.num_rows else 0

    def page_bounds(self, page: int) -> Tuple[int, int]:
        s = page * self.page_size
        return s, min(s + self.page_size, self.num_rows)
