"""The paper's own workload configurations (§6): graph scales, layout
parameters, and media constants -- the knobs the GraphAr benchmarks run
with.  Data copied from the JAX package's ``configs/graphar_paper.py``
(not imported), equal field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class GraphArConfig:
    name: str
    page_size: int = 2048          # rows per data page (paper: 1MB pages)
    row_group: int = 1024 * 1024   # rows per row group (paper default)
    miniblock: int = 32            # delta miniblock (Parquet default)
    bmi_max_width: int = 4         # kernel path for widths 1..4 (paper §4.3)
    adjacency: Tuple[str, ...] = ("by_src", "by_dst")   # CSR + CSC
    label_encoding: str = "rle"


#: scaled stand-ins for the paper's Table 1 / LDBC SNB graphs
PAPER_WORKLOADS: Dict[str, Dict] = {
    "snb-sf-small": {"scale": 1, "queries": ("is3", "ic8", "bi2")},
    "snb-sf-medium": {"scale": 2, "queries": ("is3", "ic8", "bi2")},
    "topology-suite": {"graphs": ("CI", "OL", "HW", "WK")},
    "label-suite": {"graphs": ("BL", "AX", "MA", "PO")},
}


def default_config() -> GraphArConfig:
    return GraphArConfig(name="graphar-default")
