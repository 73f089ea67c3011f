"""Edge tables with CSR/CSC/COO-emulating layouts (paper §3.2).

Edges of one type are stored as a table with ``<src>``/``<dst>`` columns and
properties.  GraphAr sorts edges **dual-key** (primary, secondary) --
``by_src`` = (src, dst) ~ CSR; ``by_dst`` = (dst, src) ~ CSC -- and adds an
auxiliary ``<offset>`` index table aligned with the key vertex table so that
the edge range of vertex ``v`` is ``[offset[v], offset[v+1])``.  Row-wise
the layout doubles as COO.  Bubbles (paper footnote 2) are naturally
expressed as equal consecutive offsets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .encoding import DEFAULT_PAGE_SIZE
from .schema import EdgeTypeSchema
from .table import DeltaIntColumn, PlainColumn, Table

BY_SRC = "by_src"
BY_DST = "by_dst"

ENC_PLAIN = "plain"     # baseline: PLAIN <src>/<dst>, unsorted (COO)
ENC_OFFSET = "offset"   # baseline: sorted + <offset>, PLAIN encoding
ENC_GRAPHAR = "graphar"  # sorted + <offset> + DELTA <src>/<dst>


@dataclasses.dataclass
class AdjacencyTable:
    """One sorted layout (CSR-like or CSC-like) of an edge type."""

    order: str                       # BY_SRC or BY_DST
    table: Table                     # <src>, <dst>, properties
    offsets: Optional[Table]         # single '<offset>' PlainColumn table
    num_key_vertices: int
    encoding: str = ENC_GRAPHAR
    #: size of the value-side vertex table -- the id space the fused
    #: decode->bitmap kernel scatters over; None disables the fused path.
    num_value_vertices: Optional[int] = None
    #: mutable plane (pending ingested edges, unioned with the packed
    #: base at dispatch time).  Not ported yet: retrieval raises
    #: ``NotImplementedError`` when one is attached; None = write-once.
    delta: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def num_edges(self) -> int:
        return self.table.num_rows

    @property
    def key_col(self) -> str:
        return "<src>" if self.order == BY_SRC else "<dst>"

    @property
    def value_col(self) -> str:
        return "<dst>" if self.order == BY_SRC else "<src>"

    # -- index access ----------------------------------------------------------
    def edge_range(self, v: int, meter=None) -> Tuple[int, int]:
        """[lo, hi) edge rows of key vertex ``v`` via the <offset> table."""
        if self.offsets is None:
            raise ValueError("no <offset> table (plain layout)")
        col: PlainColumn = self.offsets["<offset>"]  # type: ignore
        pair = col.read_range(v, v + 2, meter)
        return int(pair[0]), int(pair[1])

    def offsets_at(self, rows, meter=None) -> np.ndarray:
        """Offset values at arbitrary rows, one page-deduplicated gather."""
        if self.offsets is None:
            raise ValueError("no <offset> table (plain layout)")
        rows = np.asarray(rows, np.int64)
        col = self.offsets["<offset>"]
        return np.asarray(col.read_rows_concat(rows, rows + 1, meter),
                          np.int64)

    def edge_ranges_batch(self, vs, meter=None
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized :meth:`edge_range` for a batch of key vertices.

        One deduplicated gather of the <offset> column yields every
        ``[lo, hi)`` pair; pages shared between vertices are charged once
        (vs. once per vertex in the scalar path).
        """
        if self.offsets is None:
            raise ValueError("no <offset> table (plain layout)")
        vs = np.asarray(vs, np.int64)
        if vs.size == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        col = self.offsets["<offset>"]
        pairs = np.asarray(col.read_rows_concat(vs, vs + 2, meter),
                           np.int64).reshape(-1, 2)
        return pairs[:, 0], pairs[:, 1]

    def neighbor_ids(self, v: int, meter=None) -> np.ndarray:
        """Sorted neighbor internal IDs of ``v`` (decodes touched pages only)."""
        lo, hi = self.edge_range(v, meter)
        return np.asarray(
            self.table[self.value_col].read_range(lo, hi, meter), np.int64)

    def neighbor_ids_scan(self, v: int, meter=None) -> np.ndarray:
        """Baseline 'plain': full scan of both columns, filter on key == v."""
        keys = np.asarray(self.table[self.key_col].read_all(meter))
        vals = np.asarray(self.table[self.value_col].read_all(meter))
        return np.sort(vals[keys == v]).astype(np.int64)

    def degrees(self) -> np.ndarray:
        col: PlainColumn = self.offsets["<offset>"]  # type: ignore
        off = col.values
        return np.diff(off)

    def topology_nbytes(self) -> int:
        n = self.table["<src>"].nbytes() + self.table["<dst>"].nbytes()
        if self.offsets is not None:
            n += self.offsets["<offset>"].nbytes()
        return n

@dataclasses.dataclass
class EdgeTable:
    """All materialized layouts of one edge type."""

    schema: EdgeTypeSchema
    layouts: Dict[str, AdjacencyTable]

    def adjacency(self, order: str = BY_SRC) -> AdjacencyTable:
        return self.layouts[order]

    @property
    def num_edges(self) -> int:
        return next(iter(self.layouts.values())).num_edges


def sort_edges(src: np.ndarray, dst: np.ndarray, order: str
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Dual-key sort (paper: 'sorted first by source vertex IDs and then by
    destination vertex IDs'); returns permutation and sorted key array."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if order == BY_SRC:
        perm = np.lexsort((dst, src))
    else:
        perm = np.lexsort((src, dst))
    return perm, (src[perm] if order == BY_SRC else dst[perm])


def build_offsets(sorted_keys: np.ndarray, num_key_vertices: int
                  ) -> np.ndarray:
    """<offset> array: offsets[v] = first edge row with key >= v."""
    return np.searchsorted(
        sorted_keys, np.arange(num_key_vertices + 1)).astype(np.int64)


def build_adjacency(src: np.ndarray, dst: np.ndarray,
                    num_src: int, num_dst: int,
                    order: str = BY_SRC,
                    encoding: str = ENC_GRAPHAR,
                    properties: Optional[Dict[str, np.ndarray]] = None,
                    page_size: int = DEFAULT_PAGE_SIZE,
                    name: str = "edges") -> AdjacencyTable:
    """Sort + offset + encode one adjacency layout (paper Fig. 10 pipeline)."""
    properties = properties or {}
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    n_edges = len(src)
    nkey = num_src if order == BY_SRC else num_dst
    nval = num_dst if order == BY_SRC else num_src

    if encoding == ENC_PLAIN:
        t = Table(f"{name}_{order}_plain", n_edges, page_size)
        t.add(PlainColumn("<src>", src.astype(np.int32), page_size))
        t.add(PlainColumn("<dst>", dst.astype(np.int32), page_size))
        for k, v in properties.items():
            t.add(PlainColumn(k, np.asarray(v), page_size))
        return AdjacencyTable(order, t, None, nkey, encoding, nval)

    perm, sorted_keys = sort_edges(src, dst, order)
    s, d = src[perm], dst[perm]
    off = build_offsets(sorted_keys, nkey)

    t = Table(f"{name}_{order}_{encoding}", n_edges, page_size)
    if encoding == ENC_GRAPHAR:
        t.add(DeltaIntColumn("<src>", s, page_size))
        t.add(DeltaIntColumn("<dst>", d, page_size))
    else:  # ENC_OFFSET: sorted but PLAIN-encoded topology
        t.add(PlainColumn("<src>", s.astype(np.int32), page_size))
        t.add(PlainColumn("<dst>", d.astype(np.int32), page_size))
    for k, v in properties.items():
        t.add(PlainColumn(k, np.asarray(v)[perm], page_size))

    ot = Table(f"{name}_{order}_offset", nkey + 1, page_size)
    ot.add(PlainColumn("<offset>", off, page_size))
    return AdjacencyTable(order, t, ot, nkey, encoding, nval)
