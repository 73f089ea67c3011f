"""Acero-like baseline: a vectorized scan/filter/join/aggregate engine.

The paper benchmarks GraphAr against query plans built with Apache Acero on
plain Parquet files (§6.5.1): scans with predicate pushdown, hash joins for
topology expansion, and string matching for label filtering.  This module is
that baseline, faithfully *without* GraphAr's layout/encoding tricks: tables
are unsorted COO edge lists and plain vertex tables; every operator charges
full column scans (minus page-stat pushdown where a real engine would have
it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .storage import IOMeter
from .table import PlainColumn, Table


@dataclasses.dataclass
class Relation:
    """A materialized intermediate: named numpy columns of equal length."""

    columns: Dict[str, np.ndarray]

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    def __getitem__(self, k: str) -> np.ndarray:
        return self.columns[k]

    def take(self, idx: np.ndarray) -> "Relation":
        return Relation({k: v[idx] for k, v in self.columns.items()})


def scan(table: Table, columns: Sequence[str], meter: Optional[IOMeter] = None,
         predicate: Optional[Tuple[str, str, float]] = None) -> Relation:
    """Scan with optional single-column predicate pushdown.

    ``predicate=(col, op, value)`` skips pages whose [min,max] statistics
    cannot satisfy the predicate (Parquet-style page pruning), then applies
    the predicate exactly.
    """
    out: Dict[str, np.ndarray] = {}
    if predicate is not None:
        pcol, op, val = predicate
        col = table[pcol]
        if isinstance(col, PlainColumn):
            stats = col.page_stats()
            ps = col.page_size
            keep_pages = []
            for i, stt in enumerate(stats):
                if op == "==" and not (stt.vmin <= val <= stt.vmax):
                    continue
                if op == ">=" and stt.vmax < val:
                    continue
                if op == "<=" and stt.vmin > val:
                    continue
                keep_pages.append(i)
            # fetch kept pages for every requested column
            rows: List[np.ndarray] = []
            base: List[np.ndarray] = []
            for p in keep_pages:
                s, e = table.page_bounds(p)
                base.append(np.arange(s, e, dtype=np.int64))
            base_idx = (np.concatenate(base) if base
                        else np.zeros(0, np.int64))
            pvals = np.concatenate([
                np.asarray(col.read_range(*table.page_bounds(p), meter))
                for p in keep_pages]) if keep_pages else np.zeros(0)
            if op == "==":
                mask = pvals == val
            elif op == ">=":
                mask = pvals >= val
            else:
                mask = pvals <= val
            sel = base_idx[mask]
            for name in columns:
                c = table[name]
                vals_pages = np.concatenate([
                    np.asarray(c.read_range(*table.page_bounds(p), meter))
                    for p in keep_pages]) if keep_pages else np.zeros(0)
                out[name] = vals_pages[mask]
            out["_row"] = sel
            return Relation(out)
        # non-plain predicate column: fall through to full scan
    for name in columns:
        c = table[name]
        vals = c.read_all(meter)
        out[name] = (np.asarray(vals) if not isinstance(vals, list)
                     else np.asarray(vals, dtype=object))
    out["_row"] = np.arange(table.num_rows, dtype=np.int64)
    return Relation(out)


def filter_rel(rel: Relation, mask: np.ndarray) -> Relation:
    return rel.take(np.flatnonzero(mask))


def hash_join(left: Relation, right: Relation, left_key: str,
              right_key: str, how: str = "inner") -> Relation:
    """Vectorized hash join (sort-based under the hood; same asymptotics)."""
    lk = np.asarray(left[left_key], np.int64)
    rk = np.asarray(right[right_key], np.int64)
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    lo = np.searchsorted(rk_sorted, lk, side="left")
    hi = np.searchsorted(rk_sorted, lk, side="right")
    counts = hi - lo
    l_idx = np.repeat(np.arange(len(lk)), counts)
    if len(lk):
        starts = np.repeat(lo, counts)
        within = np.arange(counts.sum()) - np.repeat(
            np.cumsum(counts) - counts, counts)
        r_idx = order[starts + within]
    else:
        r_idx = np.zeros(0, np.int64)
    cols: Dict[str, np.ndarray] = {}
    for k, v in left.columns.items():
        cols[k] = v[l_idx]
    for k, v in right.columns.items():
        cols[k if k not in cols else f"r_{k}"] = v[r_idx]
    return Relation(cols)


def aggregate_count(rel: Relation, key: str,
                    minlength: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """GROUP BY key -> COUNT(*), returned as (keys, counts)."""
    k = np.asarray(rel[key], np.int64)
    counts = np.bincount(k, minlength=minlength)
    keys = np.flatnonzero(counts)
    return keys, counts[keys]


def order_by(rel: Relation, key: str, desc: bool = True) -> Relation:
    idx = np.argsort(rel[key], kind="stable")
    if desc:
        idx = idx[::-1]
    return rel.take(idx)


def string_label_mask(strings: Sequence[str], label: str) -> np.ndarray:
    """Baseline label predicate: split + match per row (paper Fig. 3 step 1)."""
    out = np.zeros(len(strings), bool)
    for i, s in enumerate(strings):
        if s and label in s.split("|"):
            out[i] = True
    return out
