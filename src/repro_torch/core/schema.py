"""LPG schema metadata (paper §3.2): YAML graph descriptor.

An LPG is ``G = (V, E, T_V, T_E, P, L)``.  The YAML file captures what the
payload format cannot: the graph name, path prefix, the vertex/edge types,
their property definitions, candidate label sets, partition sizes and the
adjacency orderings materialized per edge type (CSR / CSC / COO).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from .encoding import DEFAULT_PAGE_SIZE

DTYPES = ("int32", "int64", "float32", "float64", "bool", "string", "tokens")


@dataclasses.dataclass
class PropertySchema:
    name: str
    dtype: str  # one of DTYPES

    def __post_init__(self) -> None:
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}")


@dataclasses.dataclass
class VertexTypeSchema:
    name: str
    properties: List[PropertySchema] = dataclasses.field(default_factory=list)
    labels: List[str] = dataclasses.field(default_factory=list)  # candidates
    partition_size: Optional[int] = None  # rows per physical partition
    page_size: int = DEFAULT_PAGE_SIZE

    def property_names(self) -> List[str]:
        return [p.name for p in self.properties]


@dataclasses.dataclass
class EdgeTypeSchema:
    """Edge type ``src_type-<relation>-dst_type`` (paper Fig. 4c)."""

    src_type: str
    relation: str
    dst_type: str
    properties: List[PropertySchema] = dataclasses.field(default_factory=list)
    # which sorted layouts are materialized ("by_src" ~= CSR, "by_dst" ~= CSC)
    adjacency: List[str] = dataclasses.field(
        default_factory=lambda: ["by_src"])
    partition_size: Optional[int] = None
    page_size: int = DEFAULT_PAGE_SIZE

    @property
    def name(self) -> str:
        return f"{self.src_type}-{self.relation}-{self.dst_type}"


@dataclasses.dataclass
class GraphSchema:
    name: str
    prefix: str = "."
    vertex_types: Dict[str, VertexTypeSchema] = dataclasses.field(
        default_factory=dict)
    edge_types: Dict[str, EdgeTypeSchema] = dataclasses.field(
        default_factory=dict)
    version: str = "graphar/v1"

    def add_vertex_type(self, vt: VertexTypeSchema) -> "GraphSchema":
        self.vertex_types[vt.name] = vt
        return self

    def add_edge_type(self, et: EdgeTypeSchema) -> "GraphSchema":
        self.edge_types[et.name] = et
        return self

    # -- YAML round trip ----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "graphar": self.version,
            "name": self.name,
            "prefix": self.prefix,
            "vertices": [
                {
                    "type": vt.name,
                    "properties": [{"name": p.name, "dtype": p.dtype}
                                   for p in vt.properties],
                    "labels": list(vt.labels),
                    "partition_size": vt.partition_size,
                    "page_size": vt.page_size,
                }
                for vt in self.vertex_types.values()
            ],
            "edges": [
                {
                    "src": et.src_type,
                    "relation": et.relation,
                    "dst": et.dst_type,
                    "properties": [{"name": p.name, "dtype": p.dtype}
                                   for p in et.properties],
                    "adjacency": list(et.adjacency),
                    "partition_size": et.partition_size,
                    "page_size": et.page_size,
                }
                for et in self.edge_types.values()
            ],
        }

    def to_yaml(self) -> str:
        import yaml  # optional dependency: only the YAML round trip needs it
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_yaml())

    @classmethod
    def from_dict(cls, d: dict) -> "GraphSchema":
        g = cls(name=d["name"], prefix=d.get("prefix", "."),
                version=d.get("graphar", "graphar/v1"))
        for v in d.get("vertices", []):
            g.add_vertex_type(VertexTypeSchema(
                name=v["type"],
                properties=[PropertySchema(p["name"], p["dtype"])
                            for p in v.get("properties", [])],
                labels=list(v.get("labels", [])),
                partition_size=v.get("partition_size"),
                page_size=v.get("page_size", DEFAULT_PAGE_SIZE)))
        for e in d.get("edges", []):
            g.add_edge_type(EdgeTypeSchema(
                src_type=e["src"], relation=e["relation"], dst_type=e["dst"],
                properties=[PropertySchema(p["name"], p["dtype"])
                            for p in e.get("properties", [])],
                adjacency=list(e.get("adjacency", ["by_src"])),
                partition_size=e.get("partition_size"),
                page_size=e.get("page_size", DEFAULT_PAGE_SIZE)))
        return g

    @classmethod
    def from_yaml(cls, text: str) -> "GraphSchema":
        import yaml
        return cls.from_dict(yaml.safe_load(text))

    @classmethod
    def load(cls, path: str) -> "GraphSchema":
        with open(path) as f:
            return cls.from_yaml(f.read())
