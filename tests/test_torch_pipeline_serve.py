"""The port's data pipeline (``repro_torch/data/pipeline.py``) and serving
engine: the JAX package's ``test_pipeline_serve.py`` on the port, each
pipeline test also holding the port's batches and IOMeter against the
reference's on a lake both packages build from one seed, and the engine
tests holding the port's tokens against the reference engine's."""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from _torch_serve import engines, models
from repro.data.pipeline import GraphCorpusPipeline as JPipeline
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.synthetic import document_graph as j_document_graph
from repro.serve import engine as JE
from repro_torch.data.pipeline import GraphCorpusPipeline, PipelineConfig
from repro_torch.data.synthetic import document_graph
from repro_torch.data.tokenizer import EOS, HashTokenizer
from repro_torch.serve import engine as TE


def _build(core, lk):
    b = core.GraphArBuilder("docs")
    b.add_vertices(
        core.VertexTypeSchema("doc", [core.PropertySchema("tokens",
                                                          "tokens"),
                                      core.PropertySchema("quality",
                                                          "float32")],
                              labels=list(lk.labels), page_size=256),
        {"tokens": lk.tokens, "quality": lk.quality}, lk.labels)
    b.add_edges(core.EdgeTypeSchema("doc", "links", "doc", page_size=256),
                lk.links_src, lk.links_dst)
    return b.build()


@pytest.fixture(scope="module")
def doc_graph():
    lake = document_graph(num_docs=3000, vocab=512, mean_len=64, seed=0)
    return _build(T, lake), lake


@pytest.fixture(scope="module")
def j_graph():
    lake = j_document_graph(num_docs=3000, vocab=512, mean_len=64, seed=0)
    return _build(J, lake), lake


def _same_batches(pipe, jpipe, start=0, n=3):
    for a, b in zip(pipe.batches(start), jpipe.batches(start)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
        assert a["step"] == b["step"]
        n -= 1
        if not n:
            break
    assert (pipe.io_stats().nbytes, pipe.io_stats().nrequests) == \
        (jpipe.io_stats().nbytes, jpipe.io_stats().nrequests)


def test_document_lake_equals_the_reference(doc_graph, j_graph):
    _, lake = doc_graph
    _, jlake = j_graph
    assert lake.num_docs == jlake.num_docs
    assert len(lake.tokens) == len(jlake.tokens)
    for a, b in zip(lake.tokens, jlake.tokens):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(lake.links_src, jlake.links_src)
    np.testing.assert_array_equal(lake.links_dst, jlake.links_dst)
    assert list(lake.labels) == list(jlake.labels)
    for name in lake.labels:
        np.testing.assert_array_equal(lake.labels[name], jlake.labels[name])
    np.testing.assert_array_equal(lake.quality, jlake.quality)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_pipeline_filters_and_packs(doc_graph, j_graph, engine):
    g, lake = doc_graph
    cond = (T.L("HighQuality") | T.L("News")) & ~T.L("Spam")
    cfg = PipelineConfig(seq_len=128, batch_size=4, seed=1)
    pipe = GraphCorpusPipeline(g, cond, cfg, engine=engine)
    expect = np.flatnonzero(
        (lake.labels["HighQuality"] | lake.labels["News"])
        & ~lake.labels["Spam"])
    np.testing.assert_array_equal(pipe.eligible, expect)
    it = pipe.batches()
    for _ in range(3):
        batch = next(it)
        assert batch["tokens"].shape == (4, 128)
        assert batch["labels"].shape == (4, 128)
        # next-token alignment
        np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                      batch["labels"][:, :-1])
    assert pipe.io_stats().nbytes > 0
    jcond = (J.L("HighQuality") | J.L("News")) & ~J.L("Spam")
    _same_batches(GraphCorpusPipeline(g, cond, cfg, engine=engine),
                  JPipeline(j_graph[0], jcond, JPipelineConfig(
                      seq_len=128, batch_size=4, seed=1)))


def test_pipeline_filters_on_the_card_by_default(doc_graph, monkeypatch):
    g, _ = doc_graph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        GraphCorpusPipeline(g, T.L("News"), PipelineConfig(seq_len=32))
    # no filter, no device work: an unfiltered pipeline needs no card
    assert len(GraphCorpusPipeline(g, None, PipelineConfig()).eligible)


def test_pipeline_deterministic_resume(doc_graph, j_graph):
    g, _ = doc_graph
    cfg = PipelineConfig(seq_len=64, batch_size=2, seed=7)
    a = GraphCorpusPipeline(g, None, cfg)
    b = GraphCorpusPipeline(g, None, cfg)
    ia = a.batches(start_step=0)
    for _ in range(5):
        last_a = next(ia)
    ib = b.batches(start_step=4)  # resume at step 4 reproduces batch 5
    last_b = next(ib)
    np.testing.assert_array_equal(last_a["tokens"], last_b["tokens"])
    _same_batches(GraphCorpusPipeline(g, None, cfg),
                  JPipeline(j_graph[0], None, JPipelineConfig(
                      seq_len=64, batch_size=2, seed=7)), start=4)


def test_pipeline_sharding_disjoint(doc_graph, j_graph):
    g, _ = doc_graph
    cfg0 = PipelineConfig(seq_len=64, batch_size=2, shard_id=0, num_shards=2)
    cfg1 = PipelineConfig(seq_len=64, batch_size=2, shard_id=1, num_shards=2)
    p0 = GraphCorpusPipeline(g, None, cfg0)
    p1 = GraphCorpusPipeline(g, None, cfg1)
    assert set(p0.eligible).isdisjoint(set(p1.eligible))
    j1 = JPipeline(j_graph[0], None, JPipelineConfig(
        seq_len=64, batch_size=2, shard_id=1, num_shards=2))
    np.testing.assert_array_equal(p1.eligible, j1.eligible)


def test_tokenizer_deterministic():
    tok = HashTokenizer(512)
    a = tok.encode("hello graph world")
    b = tok.encode("hello graph world")
    np.testing.assert_array_equal(a, b)
    assert a[0] == 1 and a[-1] == EOS
    assert (a < 512).all()


# ------------------------------ serving ------------------------------------

def test_serve_engine_continuous_batching():
    cfg, _, _, _ = models()
    eng, teng = engines(max_slots=2, max_len=96, eos_id=-1)
    rng = np.random.default_rng(0)
    sizes = [8 + 3 * i for i in range(5)]
    prompts = [rng.integers(4, cfg.vocab_size, size=n).astype(np.int32)
               for n in sizes]
    jreqs = [JE.Request(i, p.copy(), max_new_tokens=6)
             for i, p in enumerate(prompts)]
    reqs = [TE.Request(i, p.copy(), max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r, jr in zip(reqs, jreqs):
        teng.submit(r)
        eng.submit(jr)
    for _ in range(200):
        teng.step()
        if not teng.queue and all(s is None for s in teng.slots):
            break
    assert all(len(r.output) >= 1 for r in reqs)
    assert all(r.done for r in reqs)
    # decode ticks were batched: fewer ticks than total generated tokens
    total_tokens = sum(len(r.output) for r in reqs)
    assert teng.steps < total_tokens
    eng.run_until_drained()
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert teng.steps == eng.steps


def test_serve_engine_matches_sequential_decode():
    """Engine output for a single request == plain prefill+decode loop."""
    cfg, _, _, model = models()
    rng = np.random.default_rng(3)
    prompt = rng.integers(4, cfg.vocab_size, size=12).astype(np.int32)

    # reference: batch-1 greedy decode
    cache = model.init_cache(1, 64, dtype=torch.float32)
    logits, cache = model.prefill(
        {"tokens": torch.from_numpy(prompt)[None]}, cache)
    ref = [int(torch.argmax(logits[0, -1]))]
    for _ in range(4):
        tok = torch.tensor([[ref[-1]]], dtype=torch.int32)
        logits, cache = model.decode_step(tok, cache)
        ref.append(int(torch.argmax(logits[0, -1])))

    eng = TE.ServeEngine(model, max_slots=2, max_len=64, eos_id=-1)
    req = TE.Request(0, prompt, max_new_tokens=5)
    eng.submit(req)
    for _ in range(20):
        eng.step()
        if req.done:
            break
    assert req.output == ref
