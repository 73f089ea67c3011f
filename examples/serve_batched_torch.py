"""Batched serving demo on the PyTorch port: continuous batching over a
fixed-slot KV cache, with label-scoped retrieval-augmented prompts pulled
from a GraphAr lake.

Each engine tick issues ONE batched neighbor retrieval for every request
admitted in that tick (the port's kernels on the card, their plain
versions with ``--device cpu``), scoped by the label predicate
"HighQuality and not Spam"; ``ServeEngine.stats()`` surfaces the
decoded-page LRU counters and the filter's considered/kept counters.
Admission is multi-tenant: a latency-sensitive ``prod`` class and a
rate-limited, deadline-bearing ``batch`` class share the slot pool under
deficit-weighted round-robin, and the ``batch`` flood draws typed
rejections with ``retry_after`` hints.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]
"""
import argparse

import numpy as np

from _torch_example import add_device_arg, open_device
from repro_torch.configs import get_config
from repro_torch.core import (BY_SRC, EdgeTypeSchema, GraphArBuilder,
                              IOMeter, L, PropertySchema, VertexTypeSchema)
from repro_torch.data.synthetic import document_graph
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.retrieval import GraphRetriever
from repro_torch.serve.tenancy import TenantConfig


def main():
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    engine, device, _ = open_device(ap.parse_args().device)

    # -- lake with passage tokens (retrieval source) -------------------------
    lake = document_graph(num_docs=1000, vocab=512, mean_len=48, seed=2)
    b = GraphArBuilder("passages")
    b.add_vertices(
        VertexTypeSchema("doc", [PropertySchema("tokens", "tokens")],
                         labels=list(lake.labels), page_size=512),
        {"tokens": lake.tokens}, lake.labels)
    b.add_edges(EdgeTypeSchema("doc", "links", "doc", page_size=512),
                lake.links_src, lake.links_dst)
    graph = b.build()
    adj = graph.adjacency("doc-links-doc", BY_SRC)
    tokens_col = graph.vertex("doc").table["tokens"]

    # -- model + engine with a label-scoped batched lake retriever -----------
    cfg = get_config("smollm-360m").reduced().with_(
        n_units=2, vocab_size=512)
    model = build_model(cfg, device).init(0)
    meter = IOMeter()
    retriever = GraphRetriever(adj, tokens_col, max_neighbors=2,
                               tokens_per_neighbor=16, meter=meter,
                               engine=engine,
                               filter_vt=graph.vertex("doc"),
                               filter_cond=L("HighQuality") & ~L("Spam"))
    eng = ServeEngine(model, max_slots=4, max_len=256, eos_id=-1,
                      context_fn=retriever,
                      tenants=[TenantConfig("prod", weight=4, max_queue=16),
                               TenantConfig("batch", weight=1, rate=0.5,
                                            burst=4.0, max_queue=4,
                                            deadline_ticks=64)])

    # -- requests: prompt = seed doc; labeled neighbor passages per tick -----
    # prod submits 8; batch floods 12 against a rate of 0.5 req/tick with
    # burst 4 -- the excess is shed with typed retry_after hints
    rng = np.random.default_rng(0)
    shed = []
    for rid in range(20):
        doc = int(rng.integers(0, lake.num_docs))
        prompt = tokens_col.get(doc)[:24].astype(np.int32)
        req = Request(rid, prompt, max_new_tokens=12,
                      temperature=0.0, context_vertex=doc)
        req.tenant = "prod" if rid < 8 else "batch"
        out = eng.submit(req)
        if not out.admitted:
            shed.append(out)

    finished = eng.run_until_drained(max_ticks=500)
    ctx = sum(r.context_tokens for r in finished)
    print(f"served {len(finished)} requests in {eng.steps} batched decode "
          f"steps; {retriever.calls} batched retrievals for "
          f"{retriever.vertices_seen} seeds ({ctx} context tokens, "
          f"{meter.nbytes} lake bytes)")
    # cross-tick decoded-page LRU + filtering-plane counters
    stats = eng.stats()["retrieval"]
    print("page cache:", stats["page_cache"])
    print("label filter:", stats["filter"])
    # multi-tenant admission: the batch flood was shed, prod untouched
    print(f"shed {len(shed)} batch requests "
          f"(reasons: {sorted({o.reason.value for o in shed})}, "
          f"retry_after hints: {sorted({o.retry_after for o in shed})})")
    for name, t in eng.stats()["tenants"].items():
        print(f"tenant {name}: weight={t['weight']} "
              f"admitted={t['admitted']}/{t['submitted']} "
              f"ok={t['finished_ok']} expired={t['expired']}")


if __name__ == "__main__":
    main()
