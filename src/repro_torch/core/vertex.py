"""Vertex tables (paper §3.2, Fig. 4b).

Each row is one vertex with a 0-indexed implicit internal ID.  Property
columns are named after properties; label columns are named ``<Label>`` in
angle brackets and stored as RLE booleans (GraphAr) or as the paper's
baselines ("string" concatenation / "binary (plain)").  Partitioning with
trailing "bubbles" is supported via ``partition_size``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .encoding import DEFAULT_PAGE_SIZE
from .schema import VertexTypeSchema
from .table import (BoolPlainColumn, BoolRleColumn, Column, PlainColumn,
                    StringColumn, Table, TokensColumn)

LABEL_ENC_RLE = "rle"          # GraphAr: binary (RLE)
LABEL_ENC_PLAIN = "plain"      # baseline: binary (plain)
LABEL_ENC_STRING = "string"    # baseline: concatenated string column


def label_col_name(label: str) -> str:
    return f"<{label}>"


@dataclasses.dataclass
class VertexTable:
    schema: VertexTypeSchema
    table: Table
    label_encoding: str = LABEL_ENC_RLE

    @property
    def num_vertices(self) -> int:
        return self.table.num_rows

    @property
    def page_size(self) -> int:
        return self.table.page_size

    # -- construction ---------------------------------------------------------
    @classmethod
    def build(cls, schema: VertexTypeSchema,
              properties: Dict[str, object],
              labels: Optional[Dict[str, np.ndarray]] = None,
              label_encoding: str = LABEL_ENC_RLE,
              num_vertices: Optional[int] = None) -> "VertexTable":
        labels = labels or {}
        if num_vertices is None:
            probe = (next(iter(properties.values()))
                     if properties else next(iter(labels.values())))
            num_vertices = len(probe)
        ps = schema.page_size or DEFAULT_PAGE_SIZE
        t = Table(f"vertex_{schema.name}", num_vertices, ps)
        for prop in schema.properties:
            vals = properties[prop.name]
            if prop.dtype == "string":
                t.add(StringColumn(prop.name, vals, ps))
            elif prop.dtype == "tokens":
                t.add(TokensColumn(prop.name, vals, ps))
            else:
                t.add(PlainColumn(prop.name, np.asarray(vals), ps))
        if label_encoding == LABEL_ENC_STRING:
            # paper baseline: all labels of a vertex in one BYTE_ARRAY column
            mat = np.stack([np.asarray(labels[l], bool)
                            for l in schema.labels], axis=1) \
                if schema.labels else np.zeros((num_vertices, 0), bool)
            strings = ["|".join(l for l, on in zip(schema.labels, row) if on)
                       for row in mat]
            t.add(StringColumn("<labels>", strings, ps))
        else:
            col_cls = (BoolRleColumn if label_encoding == LABEL_ENC_RLE
                       else BoolPlainColumn)
            for l in schema.labels:
                t.add(col_cls(label_col_name(l),
                              np.asarray(labels[l], bool), ps))
        return cls(schema, t, label_encoding)

    # -- access ---------------------------------------------------------------
    def property_column(self, name: str) -> Column:
        return self.table[name]

    def label_column(self, label: str) -> Column:
        if self.label_encoding == LABEL_ENC_STRING:
            return self.table["<labels>"]
        return self.table[label_col_name(label)]

    def label_rle(self, label: str):
        col = self.table[label_col_name(label)]
        if not isinstance(col, BoolRleColumn):
            raise TypeError("label columns are not RLE-encoded")
        return col.encoded

    def labels_nbytes(self) -> int:
        if self.label_encoding == LABEL_ENC_STRING:
            return self.table["<labels>"].nbytes()
        return sum(self.table[label_col_name(l)].nbytes()
                   for l in self.schema.labels)

    def read_property_pages(self, name: str, pages: Sequence[int],
                            meter=None) -> Dict[int, np.ndarray]:
        col = self.table[name]
        if isinstance(col, PlainColumn):
            return col.read_pages(pages, meter)
        out = {}
        for p in pages:
            s, e = self.table.page_bounds(p)
            out[p] = col.read_range(s, e, meter)
        return out

    def read_properties_batch(self, pac, names: Sequence[str],
                              meter=None) -> Dict[str, np.ndarray]:
        """Batched multi-property gather (selection pushdown, paper §4.3).

        Fetches every named property column for exactly the PAC's ids in
        a **single deduplicated pass** over the PAC's page set: the page
        list and the per-page selection indices are derived once -- one
        ``unpackbits`` over the whole bitmap-plane stack -- and shared by
        all columns, instead of re-deriving both per property as the
        per-column ``fetch_properties`` loop does.  Delta-encoded columns
        consult their decoded-page LRU page by page.  Values come back in
        ascending internal-id order, identical per column to
        :func:`repro_torch.core.neighbor.fetch_properties`.
        """
        pages = pac.pages()
        if not pages:
            return {name: np.zeros(0) for name in names}
        planes = np.stack([pac.bitmaps[p] for p in pages])
        bits_per_plane = planes.shape[1] * 32
        flat = np.flatnonzero(
            np.unpackbits(planes.view(np.uint8), bitorder="little"))
        plane_of = flat // bits_per_plane
        # per-page relative indices, computed once for every column
        rel = np.split(flat % bits_per_plane,
                       np.searchsorted(plane_of, np.arange(1, len(pages))))
        out: Dict[str, np.ndarray] = {}
        for name in names:
            page_vals = self.read_property_pages(name, pages, meter)
            parts = []
            for p, r in zip(pages, rel):
                vals = np.asarray(page_vals[p])
                parts.append(vals[r[r < len(vals)]])
            out[name] = np.concatenate(parts) if parts else np.zeros(0)
        return out
