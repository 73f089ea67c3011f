"""Shared pieces of the serving parity suites: the reduced smollm in both
packages (the port's carrying the reference's ``init(0)`` weights through
``params_from_jax``), document lakes built by both packages from one
seed, and requests built twice from one seeded stream (the engines
mutate requests in place)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as JC
import repro.core as J
import repro_torch.configs as TC
from repro.data.synthetic import document_graph as j_document_graph
from repro.models import build_model as jbuild
from repro.serve import engine as JE
from repro_torch.data.synthetic import document_graph as t_document_graph
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as TE

torch.set_num_threads(1)

#: the reference's engines beside the port's on the same inputs
ENGINE_PAIRS = [("numpy", "numpy"), ("jax", "torch")]
#: a reference step is decisive when its top two float32 logits lie more
#: than this apart
MARGIN = 1e-4

_MODELS = {}


def models():
    """(JAX model, JAX params, port model on the CPU), built once."""
    if not _MODELS:
        jcfg = JC.get_config("smollm-360m").reduced().with_(n_units=2)
        tcfg = TC.get_config("smollm-360m").reduced().with_(n_units=2)
        jm = jbuild(jcfg)
        jp = jm.init(0)
        tm = build_model(tcfg, "cpu")
        tm.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                              jp)))
        _MODELS.update(cfg=tcfg, jm=jm, jp=jp, tm=tm)
    return _MODELS["cfg"], _MODELS["jm"], _MODELS["jp"], _MODELS["tm"]


def lake(core, num_docs=200, seed=5, page_size=128, vocab=512,
         mean_len=32):
    """(graph, adjacency by source, tokens column, DocumentLake) of
    ``document_graph`` in ``core``'s package (``J`` or ``T``)."""
    gen = j_document_graph if core is J else t_document_graph
    lk = gen(num_docs=num_docs, vocab=vocab, mean_len=mean_len, seed=seed)
    b = core.GraphArBuilder("docs")
    b.add_vertices(
        core.VertexTypeSchema("doc", [core.PropertySchema("tokens",
                                                          "tokens")],
                              labels=list(lk.labels), page_size=page_size),
        {"tokens": lk.tokens}, lk.labels)
    b.add_edges(core.EdgeTypeSchema("doc", "links", "doc",
                                    page_size=page_size),
                lk.links_src, lk.links_dst)
    g = b.build()
    return (g, g.adjacency("doc-links-doc", core.BY_SRC),
            g.vertex("doc").table["tokens"], lk)


def requests(pkg, cfg, adj, n, mnt=3, seed=0, size=6, tenants=None):
    """``n`` seeded requests of ``pkg`` (``JE`` or ``TE``) with a context
    vertex of nonzero degree; the same seed gives the same requests in
    both packages."""
    rng = np.random.default_rng(seed)
    seeds = np.flatnonzero(adj.degrees() > 0)
    vs = seeds[rng.integers(0, len(seeds), n)]
    out = []
    for i, v in enumerate(vs):
        r = pkg.Request(i, rng.integers(4, cfg.vocab_size, size=size)
                        .astype(np.int32), max_new_tokens=mnt,
                        context_vertex=int(v))
        if tenants:
            r.tenant = tenants[i % len(tenants)]
        out.append(r)
    return out


def engines(jkw=None, tkw=None, **kw):
    """The reference's and the port's engine over the shared models."""
    _, jm, jp, tm = models()
    return (JE.ServeEngine(jm, jp, **{**kw, **(jkw or {})}),
            TE.ServeEngine(tm, **{**kw, **(tkw or {})}))


def assert_same_requests(a, b):
    """Finished requests equal field by field, in the same order."""
    assert [r.request_id for r in a] == [r.request_id for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.prompt, y.prompt)
        assert x.output == y.output, f"request {x.request_id}"
        assert x.context_tokens == y.context_tokens
        assert x.done == y.done
        assert (x.status.value if x.status else None) == \
            (y.status.value if y.status else None)
        assert x.finished_tick == y.finished_tick


def comparable_stats(s):
    """An engine's ``stats()`` without its wall-clock fields and with the
    device mirror's key named for the device (``cpu``) or the engine
    (``jax``) dropped: what both packages must agree on."""
    s = dict(s)
    pipe = dict(s["pipeline"])
    for k in ("last_tick", "totals", "pipeline_overlap_ms"):
        pipe.pop(k)
    s["pipeline"] = pipe
    if "overload" in s:
        ov = dict(s["overload"])
        for k in ("p99_ms", "transitions"):
            ov.pop(k)
        s["overload"] = ov
    if "retrieval" in s:
        s["retrieval"] = retrieval_stats(s["retrieval"])
    return s


def retrieval_stats(s):
    s = dict(s)
    if "device_mirror" in s:
        dm = dict(s["device_mirror"])
        assert dm.pop("engines") in (["jax"], ["cpu"])
        s["device_mirror"] = dm
    if "partitions" in s:
        # the partition plane names its devices: torch's "cpu" against the
        # JAX platform's CPU device
        parts = dict(s["partitions"])
        assert all(d == "cpu" or "CPU" in d for d in parts.pop("devices"))
        s["partitions"] = parts
    return s


def decisive_prefix(jm, jp, req):
    """How many leading tokens of the reference request ``req`` are
    decisive: the steps before the first whose top two logits, in the
    reference's float32 forward over prompt and tokens, lie at most
    ``MARGIN`` apart (all of them when none does)."""
    seq = np.concatenate([np.asarray(req.prompt, np.int32),
                          np.asarray(req.output, np.int32)])
    logits, _ = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(seq[None])})
    logits = np.asarray(logits[0], np.float32)
    n = len(req.prompt)
    for i in range(len(req.output)):
        top2 = np.sort(logits[n - 1 + i])[-2:]
        if top2[1] - top2[0] <= MARGIN:
            return i
    return len(req.output)
