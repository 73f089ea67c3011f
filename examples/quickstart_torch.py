"""GraphAr quickstart on the PyTorch port: build an LPG, store it, query it.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(the default ``--device cuda`` runs the retrieval and label-filter kernels
on the card.)
"""
import argparse
import os
import tempfile

import numpy as np

from _torch_example import add_device_arg, open_device
from repro_torch.core import (BY_SRC, EdgeTypeSchema, GraphArBuilder,
                              GraphStore, IOMeter, L, PropertySchema,
                              VertexTypeSchema, filter_rle_interval,
                              intervals_to_ids, neighbor_properties,
                              retrieve_neighbors)
from repro_torch.core.storage import ESSD
from repro_torch.data.synthetic import clustered_labels, powerlaw_graph


def main():
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    engine, _, _ = open_device(ap.parse_args().device)

    # -- 1. raw data: a small social graph with labeled persons ------------
    n = 20_000
    src, dst = powerlaw_graph(n, avg_degree=10, seed=0)
    labels = clustered_labels(n, ["Asian", "Enrollee", "Student"],
                              density=0.3, run_scale=512, seed=1)
    age = np.random.default_rng(0).integers(18, 90, n).astype(np.int64)

    # -- 2. build the GraphAr layout (sort -> offset -> encode) ------------
    b = GraphArBuilder("quickstart")
    b.add_vertices(
        VertexTypeSchema("person", [PropertySchema("age", "int64")],
                         labels=list(labels)),
        {"age": age}, labels)
    b.add_edges(EdgeTypeSchema("person", "knows", "person",
                               adjacency=["by_src", "by_dst"]), src, dst)
    g = b.build()
    print(f"built graph: {n} vertices, {len(src)} edges "
          f"(sort {b.timing.sort:.3f}s, encode {b.timing.output:.3f}s)"
          f"  [built on the host]")

    # -- 3. persist + reload ------------------------------------------------
    root = os.path.join(tempfile.gettempdir(), "graphar_quickstart")
    g.save(root)
    store = GraphStore(root)
    print(f"saved to {root}: tables = {store.list_tables()}")

    # -- 4. neighbor retrieval (CSR-like: offset + delta + PAC) -------------
    adj = g.adjacency("person-knows-person", BY_SRC)
    meter = IOMeter()
    v = int(src[0])
    pac = retrieve_neighbors(adj, v, g.vertex("person").page_size, meter,
                             engine=engine)
    ages = neighbor_properties(adj, v, g.vertex("person"), "age",
                               engine=engine)
    print(f"vertex {v}: {pac.count()} neighbors across {len(pac)} pages, "
          f"mean age {ages.mean():.1f}; bytes touched {meter.nbytes} "
          f"(~{meter.seconds(ESSD)*1e3:.2f} ms on ESSD)")

    # -- 5. label filtering: (Asian & Enrollee) | Student -------------------
    cond = (L("Asian") & L("Enrollee")) | L("Student")
    ids = intervals_to_ids(filter_rle_interval(g.vertex("person"), cond,
                                               engine=engine))
    print(f"label filter {cond}: {len(ids)} matching vertices")


if __name__ == "__main__":
    main()
