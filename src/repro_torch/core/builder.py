"""GraphAr construction: raw data -> sorted/encoded tables (paper §6.2.3).

The transformation pipeline has the paper's three steps, individually timed
so the Fig. 10 breakdown can be reproduced:
  1. ``sort``   -- dual-key lexsort of the edge list;
  2. ``offset`` -- build the <offset> index aligned with the vertex table;
  3. ``output`` -- encode (delta / RLE) and write the payload files.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from .edge import (BY_DST, BY_SRC, ENC_GRAPHAR, AdjacencyTable, EdgeTable,
                   build_adjacency, build_offsets, sort_edges)
from .schema import EdgeTypeSchema, GraphSchema, VertexTypeSchema
from .storage import GraphStore
from .vertex import LABEL_ENC_RLE, VertexTable


@dataclasses.dataclass
class TransformTiming:
    sort: float = 0.0
    offset: float = 0.0
    output: float = 0.0

    @property
    def total(self) -> float:
        return self.sort + self.offset + self.output


@dataclasses.dataclass
class Graph:
    """An in-memory LPG in GraphAr layout."""

    schema: GraphSchema
    vertices: Dict[str, VertexTable]
    edges: Dict[str, EdgeTable]

    def vertex(self, type_name: str) -> VertexTable:
        return self.vertices[type_name]

    def edge(self, name: str) -> EdgeTable:
        return self.edges[name]

    def adjacency(self, edge_name: str, order: str = BY_SRC) -> AdjacencyTable:
        return self.edges[edge_name].adjacency(order)

    def read_properties_batch(self, type_name: str, pac, names,
                              meter=None) -> Dict[str, np.ndarray]:
        """Batched multi-property gather over one vertex type: every named
        column fetched for exactly the PAC's ids in a single deduplicated
        pass over the PAC's page set (see
        :meth:`repro_torch.core.vertex.VertexTable.read_properties_batch`)."""
        return self.vertices[type_name].read_properties_batch(
            pac, names, meter)

    def save(self, root: str) -> None:
        store = GraphStore(root)
        store.write_schema_yaml(self.schema)
        for vt in self.vertices.values():
            store.write(vt.table)
        for et in self.edges.values():
            for adj in et.layouts.values():
                store.write(adj.table)
                if adj.offsets is not None:
                    store.write(adj.offsets)


class GraphArBuilder:
    """Assemble a :class:`Graph` from raw numpy data."""

    def __init__(self, name: str, prefix: str = "."):
        self.schema = GraphSchema(name, prefix)
        self._vertices: Dict[str, VertexTable] = {}
        self._edges: Dict[str, EdgeTable] = {}
        self.timing = TransformTiming()

    # -- vertices ---------------------------------------------------------------
    def add_vertices(self, vschema: VertexTypeSchema,
                     properties: Dict[str, object],
                     labels: Optional[Dict[str, np.ndarray]] = None,
                     label_encoding: str = LABEL_ENC_RLE,
                     num_vertices: Optional[int] = None) -> "GraphArBuilder":
        t0 = time.perf_counter()
        vt = VertexTable.build(vschema, properties, labels, label_encoding,
                               num_vertices)
        self.timing.output += time.perf_counter() - t0
        self.schema.add_vertex_type(vschema)
        self._vertices[vschema.name] = vt
        return self

    # -- edges ------------------------------------------------------------------
    def add_edges(self, eschema: EdgeTypeSchema,
                  src: np.ndarray, dst: np.ndarray,
                  properties: Optional[Dict[str, np.ndarray]] = None,
                  encoding: str = ENC_GRAPHAR) -> "GraphArBuilder":
        num_src = self._vertices[eschema.src_type].num_vertices
        num_dst = self._vertices[eschema.dst_type].num_vertices
        layouts: Dict[str, AdjacencyTable] = {}
        for order in eschema.adjacency:
            order = {"by_src": BY_SRC, "by_dst": BY_DST}[order]
            # timed sort (reported in the Fig. 10 breakdown)
            t0 = time.perf_counter()
            perm, sorted_keys = sort_edges(src, dst, order)
            t1 = time.perf_counter()
            nkey = num_src if order == BY_SRC else num_dst
            build_offsets(sorted_keys, nkey)
            t2 = time.perf_counter()
            adj = build_adjacency(src, dst, num_src, num_dst, order=order,
                                  encoding=encoding, properties=properties,
                                  page_size=eschema.page_size,
                                  name=eschema.name)
            t3 = time.perf_counter()
            self.timing.sort += t1 - t0
            self.timing.offset += t2 - t1
            # build_adjacency re-sorts internally; attribute only encode time
            self.timing.output += max(t3 - t2 - (t1 - t0) - (t2 - t1), 0.0)
            layouts[order] = adj
        self.schema.add_edge_type(eschema)
        self._edges[eschema.name] = EdgeTable(eschema, layouts)
        return self

    def build(self) -> Graph:
        return Graph(self.schema, dict(self._vertices), dict(self._edges))
