"""Synthetic graph generators (the JAX package's, same random streams).

``powerlaw_graph`` produces a degree-skewed graph with tunable ID
locality (sparse, clustered adjacency -> few bits per delta, paper §4.2);
``clustered_labels`` produces boolean label columns arranged in runs
(short RLE interval lists, paper §5.1).  Both draw from the same
``np.random.default_rng`` streams as the JAX package's generators, so one
seed gives the same graph in both packages.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def powerlaw_graph(num_vertices: int, avg_degree: float,
                   locality: float = 0.9, alpha: float = 2.1,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Edge list (src, dst) with Zipf-ish out-degrees and ID locality.

    ``locality`` is the fraction of edges whose endpoint is drawn from a
    narrow window around the source ID (log-normal offsets), matching the
    clustering the paper exploits; the rest are uniform (long-range links).
    """
    rng = np.random.default_rng(seed)
    num_edges = int(num_vertices * avg_degree)
    # power-law out-degree: sample sources via Zipf ranks
    ranks = rng.zipf(alpha, size=num_edges).astype(np.int64)
    src = (ranks * 9973 + rng.integers(0, num_vertices, num_edges)) \
        % num_vertices
    local = rng.random(num_edges) < locality
    offs = np.maximum(rng.lognormal(3.0, 1.5, num_edges).astype(np.int64), 1)
    sign = rng.choice([-1, 1], num_edges)
    dst_local = (src + sign * offs) % num_vertices
    dst_rand = rng.integers(0, num_vertices, num_edges)
    dst = np.where(local, dst_local, dst_rand)
    keep = src != dst
    return src[keep].astype(np.int64), dst[keep].astype(np.int64)


def clustered_labels(num_vertices: int, names: List[str],
                     density: float = 0.3, run_scale: int = 4096,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Boolean label columns arranged in runs (short RLE interval lists)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for k, name in enumerate(names):
        col = np.zeros(num_vertices, bool)
        pos = 0
        r = np.random.default_rng(seed * 1000003 + k)
        while pos < num_vertices:
            run = max(int(r.exponential(run_scale)), 32)
            val = r.random() < density
            col[pos:pos + run] = val
            pos += run
        out[name] = col
    return out
