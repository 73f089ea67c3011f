"""The port's ``ServeEngine`` against the reference's on the SSM, hybrid
and MoE families: reduced mamba2-2.7b, jamba-1.5-large-398b and
deepseek-moe-16b, the port carrying the reference's ``init(0)`` weights
(``tests/_torch_families.py``), behind a label-scoped two-hop retriever
over a lake both packages build from one seed.

* Greedy tokens equal the reference engine's on every decisive step (top
  two logits of the reference's float32 forward more than
  ``_torch_serve.MARGIN`` apart; for MoE the engine's decode batch sets
  the capacity, so the streams are held equal outright), IOMeter and
  ``stats()`` equal.
* Two same-size prefill groups in a row on mamba2 reuse one prefill
  template: its conv tails (which a prefill reads) and states are zeroed
  before the second, so the engine cache equals the reference's (built on
  a fresh zero cache) after every tick.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from _torch_families import models
from _torch_serve import comparable_stats, decisive_prefix, lake, requests
from repro.serve import engine as JE
from repro.serve.retrieval import GraphRetriever as JGraphRetriever
from repro_torch.serve import engine as TE
from repro_torch.serve.retrieval import GraphRetriever

torch.set_num_threads(1)

ARCHS = ["mamba2-2.7b", "jamba-1.5-large-398b", "deepseek-moe-16b"]
MAX_LEN = 96


def _retrievers():
    out = []
    for core, cls, eng in ((J, JGraphRetriever, "numpy"),
                           (T, GraphRetriever, "numpy")):
        g, adj, tok, _ = lake(core)
        out.append(cls(adj, tok, meter=core.IOMeter(), engine=eng,
                       max_neighbors=2, tokens_per_neighbor=8,
                       page_cache_pages=64, hops=2,
                       filter_vt=g.vertex("doc"),
                       filter_cond=core.L("HighQuality") & ~core.L("Spam")))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_equals_the_reference(arch):
    """The pipeline on, 3 slots, 10 requests with prompts of three
    lengths and retrieved contexts."""
    jm, jp, tm = models(arch)
    jr, tr = _retrievers()
    kw = dict(max_slots=3, max_len=MAX_LEN, eos_id=-1, pipeline=True)
    jeng = JE.ServeEngine(jm, jp, context_fn=jr, **kw)
    teng = TE.ServeEngine(tm, context_fn=tr, **kw)
    for pkg, eng, r in ((JE, jeng, jr), (TE, teng, tr)):
        for i, req in enumerate(requests(pkg, tm.cfg, r.adj, 10, mnt=4)):
            req.prompt = req.prompt[:4 + i % 3]
            eng.submit(req)
    jfin, tfin = jeng.run_until_drained(), teng.run_until_drained()
    assert [r.request_id for r in tfin] == [r.request_id for r in jfin]
    for a, b in zip(tfin, jfin):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.context_tokens == b.context_tokens
        assert a.status.value == b.status.value
        if a.output != b.output:
            assert tm.cfg.moe is None, f"request {b.request_id} parts"
            k = decisive_prefix(jm, jp, b)
            assert k < len(b.output) and a.output[:k] == b.output[:k], \
                f"request {b.request_id} parts at a decisive step"
    assert (tr.meter.nbytes, tr.meter.nrequests) == \
        (jr.meter.nbytes, jr.meter.nrequests)
    assert comparable_stats(teng.stats()) == comparable_stats(jeng.stats())


def _ssm_leaves(cache, jax_side):
    """Every SSM layer's conv tail and state of an engine cache."""
    if jax_side:
        s = cache["units"]["l0"]["ssm"]
        return [np.asarray(s[n][u], np.float32)
                for u in range(s["conv"].shape[0]) for n in ("conv", "state")]
    return [layer["ssm"][n].float().numpy() for layer in cache["layers"]
            for n in ("conv", "state")]


def test_two_same_size_prefill_groups_on_mamba2():
    """Two groups of two 3-token prompts in a row reuse the batch-2
    template: the engine caches equal the reference's after every tick,
    and the tokens are equal.  The prompts are short because a prefill
    reads the conv tail at its first 3 positions, and a longer prompt's
    state forgets them (decays of exp(-dt * [1, 16]) a step)."""
    jm, jp, tm = models("mamba2-2.7b")
    kw = dict(max_slots=2, max_len=40, eos_id=-1)
    jeng, teng = JE.ServeEngine(jm, jp, **kw), TE.ServeEngine(tm, **kw)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(4, tm.cfg.vocab_size, 3).astype(np.int32)
               for _ in range(4)]
    for pkg, eng in ((JE, jeng), (TE, teng)):
        for i, p in enumerate(prompts):
            eng.submit(pkg.Request(i, p.copy(), max_new_tokens=2))
    for tick in range(4):
        jeng.step()
        teng.step()
        for a, b in zip(_ssm_leaves(teng.cache, False),
                        _ssm_leaves(jeng.cache, True)):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4,
                                       err_msg=f"tick {tick}")
    assert set(teng._tmp_caches) == {2}
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [r.output for r in teng.finished] == \
        [r.output for r in jeng.finished]
    assert len(teng.finished) == 4
