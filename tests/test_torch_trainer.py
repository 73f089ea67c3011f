"""The port's trainer, checkpoints, gradient compression, pipeline
schedule and corpus training loop against the JAX package's.

* The reference's failure-recovery test (reduced smollm, 12 steps,
  checkpoints every 4, a crash at step 6) on both packages from the same
  weights: each run recovers, and the two packages' histories agree
  within rel 1e-4.
* A checkpoint of a float32 train state written by the reference,
  restored by path in the port and carried across (``params_from_jax``,
  ``opt_state_from_jax``): the port's next step is the reference's.
* bfloat16: a tree saved by each package restores in the port; the
  reference's own restore of it raises (its ``astype`` of the void array
  ``np.load`` gives back), and that raise is pinned here.
* Shard ``.npy`` files byte for byte the reference's for the same arrays,
  bfloat16 among them, and the manifests equal but for ``created``.
* ``test_distributed_extras.py`` on both packages.
* Three steps of ``examples/train_graph_corpus.py``'s loop at a tiny
  lake: the port's ``GraphCorpusPipeline`` on ``torch`` gives the
  reference's tokens, and the losses agree within rel 1e-4.
"""
import filecmp
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint.checkpointer as JK
import repro.configs as JC
import repro.distributed.collectives as JCo
import repro.distributed.pipeline as JPi
import repro.train.optimizer as JO
import repro.train.schedule as JS
import repro_torch.checkpoint.checkpointer as TK
import repro_torch.configs as TC
import repro_torch.distributed.collectives as TCo
import repro_torch.distributed.pipeline as TPi
import repro_torch.train.optimizer as TO
import repro_torch.train.schedule as TS
from repro.models import build_model as jbuild
from repro.train.train_step import make_train_step as jmake
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.models import build_model
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.train.train_step import (load_params, make_train_step,
                                          model_params)
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def smollm(**over):
    jcfg = JC.get_config("smollm-360m").reduced().with_(**over)
    tcfg = TC.get_config("smollm-360m").reduced().with_(**over)
    jm = jbuild(jcfg)
    jp = jm.init(0)
    tm = build_model(tcfg, "cpu")
    state = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    load_params(tm, state)
    return jm, jp, tm, state


class FromReference(Trainer):
    """The port's trainer started from the reference's ``init(0)``
    weights (the frameworks draw different numbers from one seed)."""

    def __init__(self, *args, state, **kwargs):
        super().__init__(*args, **kwargs)
        self.state = state

    def _init_state(self):
        params = model_params(load_params(self.model, self.state))
        return params, self.opt.init(params, self.layout), 0


# ------------------------------------------------------------------ trainer

def test_trainer_failure_recovery_matches_reference(tmp_path):
    jm, _, tm, state = smollm(n_units=1)
    cfg = tm.cfg

    def batch_fn(step):
        r = np.random.default_rng(step)
        return {"tokens": r.integers(0, cfg.vocab_size, (4, 16)
                                     ).astype(np.int32),
                "labels": r.integers(0, cfg.vocab_size, (4, 16)
                                     ).astype(np.int32)}

    def jbatch_fn(step):
        return {k: jnp.asarray(v) for k, v in batch_fn(step).items()}

    def config(C, name):
        return C(total_steps=12, checkpoint_every=4,
                 checkpoint_dir=str(tmp_path / name), log_every=4)

    jout = JTrainer(jm, JO.adamw(1e-3), config(JTrainerConfig, "jax"),
                    jbatch_fn).run(simulate_failure_at=6)
    out = FromReference(tm, TO.adamw(1e-3), config(TrainerConfig, "torch"),
                        batch_fn, state=state).run(simulate_failure_at=6)
    clean = FromReference(tm, TO.adamw(1e-3), config(TrainerConfig, "clean"),
                          batch_fn, state=state).run()
    assert out["failures"] == jout["failures"] == 1
    assert out["final_step"] == jout["final_step"] == 12
    assert TK.latest_checkpoint(str(tmp_path / "torch")) == 12
    assert TK.list_checkpoints(str(tmp_path / "torch")) == [4, 8, 12]
    assert [h["step"] for h in out["history"]] == \
        [h["step"] for h in jout["history"]] == [4, 8, 12]
    for got, want, again in zip(out["history"], jout["history"],
                                clean["history"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
        assert got["loss"] == pytest.approx(again["loss"], rel=1e-4)
    for k, v in out["params"].items():
        np.testing.assert_allclose(_np(v), _np(clean["params"][k]),
                                   rtol=2e-4, atol=5e-4)


def _nest(flat):
    """A flat ``{"a/b/c": leaf}`` dict as nested dicts."""
    out = {}
    for path, leaf in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def test_reference_checkpoint_carried_into_the_port(tmp_path):
    """The reference's float32 train state after one step, saved by the
    reference and restored by path in the port: the port's next step from
    it is the reference's next step."""
    jm, jp, tm, _ = smollm(n_units=2)
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    b1, b2 = ({"tokens": rng.integers(0, cfg.vocab_size, (4, 16)
                                      ).astype(np.int32),
               "labels": rng.integers(0, cfg.vocab_size, (4, 16)
                                      ).astype(np.int32)} for _ in range(2))
    jo = JO.adamw(JS.warmup_cosine(1e-2, 2, 10))
    jstep = jax.jit(jmake(jm, jo, 2))
    jp1, js1, _ = jstep(jp, jo.init(jp), jax.tree.map(jnp.asarray, b1))
    JK.save_checkpoint(str(tmp_path), 1, {"params": jp1, "opt": js1},
                       extra={"next_step": 1})
    flat, extra = TK.restore_checkpoint(str(tmp_path), 1)
    assert extra == {"next_step": 1}
    tree = _nest(flat)
    params = params_from_jax(cfg, tree["params"])
    state = opt_state_from_jax(cfg, tree["opt"], "adamw")
    to = TO.adamw(TS.warmup_cosine(1e-2, 2, 10))
    tp2, ts2, tmet = make_train_step(tm, to, 2)(params, state, b2)
    jp2, js2, jmet = jstep(jp1, js1, jax.tree.map(jnp.asarray, b2))
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-4)
    assert int(ts2["step"]) == int(js2["step"]) == 2
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jp2))
    for k, v in want.items():
        np.testing.assert_allclose(_np(tp2[k]), _np(v), rtol=2e-4,
                                   atol=5e-4, err_msg=k)


# -------------------------------------------------------------- bfloat16

def _bf16_tree():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    return w, {"w": w.astype(ml_dtypes.bfloat16),
               "s": np.arange(4, dtype=np.float32)}


def test_bf16_checkpoints_restore_in_the_port(tmp_path):
    w, tree = _bf16_tree()
    want = torch.from_numpy(w).to(torch.bfloat16)
    like = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
            "s": torch.zeros(4)}
    JK.save_checkpoint(str(tmp_path / "jax"), 1, tree)
    TK.save_checkpoint(str(tmp_path / "torch"), 1,
                       {"w": want, "s": torch.arange(4.0)})
    for side in ("jax", "torch"):
        got, _ = TK.restore_checkpoint(str(tmp_path / side), 1, like=like)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], want)
        assert torch.equal(got["s"], torch.arange(4.0))
        flat, _ = TK.restore_checkpoint(str(tmp_path / side), 1)
        assert torch.equal(flat["w"], want)
        # into a float32 numpy leaf, widened exactly
        got, _ = TK.restore_checkpoint(str(tmp_path / side), 1,
                                       like={"w": np.zeros((3, 5),
                                                           np.float32),
                                             "s": np.zeros(4, np.float32)})
        np.testing.assert_array_equal(got["w"], want.float().numpy())
        with open(tmp_path / side / "step_00000001" / "manifest.json") as f:
            dtypes = {l["path"]: l["dtype"] for l in json.load(f)["leaves"]}
        assert dtypes == {"w": "bfloat16", "s": "float32"}
    # the reference cannot restore its own bfloat16 leaf
    for side in ("jax", "torch"):
        with pytest.raises(ValueError, match="cast"):
            JK.restore_checkpoint(str(tmp_path / side), 1, like=tree)


def test_shards_byte_identical_to_the_reference(tmp_path):
    rng = np.random.default_rng(4)
    tree = {"b": {"f32": rng.standard_normal((7, 9)).astype(np.float32),
                  "i32": rng.integers(-9, 9, (5,)).astype(np.int32),
                  "i8": rng.integers(-127, 127, (2, 128)).astype(np.int8)},
            "a": np.float32(3.5) * np.ones(()),
            "c": [np.arange(3, dtype=np.int64), np.zeros((0, 4), np.float32)],
            "bf": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16)}
    port = dict(tree, bf=torch.from_numpy(
        tree["bf"].view(np.int16).copy()).view(torch.bfloat16),
        b=dict(tree["b"], f32=torch.from_numpy(tree["b"]["f32"])))
    JK.save_checkpoint(str(tmp_path / "jax"), 3, tree, extra={"k": 1})
    TK.save_checkpoint(str(tmp_path / "torch"), 3, port, extra={"k": 1})
    jd, td = (tmp_path / s / "step_00000003" for s in ("jax", "torch"))
    files = sorted(os.listdir(jd))
    assert files == sorted(os.listdir(td)) and len(files) == 8
    for f in files:
        if f.endswith(".npy"):
            assert filecmp.cmp(jd / f, td / f, shallow=False), f
    jm, tm = (json.load(open(d / "manifest.json")) for d in (jd, td))
    jm.pop("created"), tm.pop("created")
    assert jm == tm


# ----------------------------------------------- distributed extras, both

PKGS = {"jax": SimpleNamespace(co=JCo, pi=JPi, arr=jnp.asarray,
                               zeros=lambda n: jnp.zeros(n)),
        "torch": SimpleNamespace(co=TCo, pi=TPi, arr=torch.from_numpy,
                                 zeros=lambda n: torch.zeros(n))}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_compression_roundtrip_accuracy(pkg):
    rng = np.random.default_rng(0)
    grads = {"w": pkg.arr(rng.standard_normal((64, 300)).astype(np.float32)),
             "b": pkg.arr(rng.standard_normal(7).astype(np.float32))}
    comp, _ = pkg.co.compress_with_feedback(
        grads, pkg.co.init_error_feedback(grads))
    approx = pkg.co.decompress(comp, grads)
    for k in grads:
        rel = float(abs(approx[k] - grads[k]).max() / abs(grads[k]).max())
        assert rel < 0.02, f"{k}: {rel}"


def test_compression_saves_bytes(pkg):
    grads = {"w": pkg.arr(np.ones((1024, 1024), np.float32))}
    comp, _ = pkg.co.compress_with_feedback(
        grads, pkg.co.init_error_feedback(grads))
    assert pkg.co.compressed_bytes(comp) < 0.35 * 1024 * 1024 * 4


def test_error_feedback_removes_bias(pkg):
    rng = np.random.default_rng(1)
    true_sum = np.zeros(512, np.float32)
    acc = np.zeros(512, np.float32)
    err = pkg.co.init_error_feedback({"g": pkg.zeros(512)})
    for _ in range(50):
        g = rng.standard_normal(512).astype(np.float32) * 1e-3
        true_sum += g
        comp, err = pkg.co.compress_with_feedback({"g": pkg.arr(g)}, err)
        acc += _np(pkg.co.decompress(comp, {"g": pkg.zeros(512)})["g"])
    rel = np.abs(acc - true_sum).max() / np.abs(true_sum).max()
    assert rel < 0.05, rel


def test_compression_matches_reference():
    """Codes, scales, residuals and the decompressed values over 5 steps
    of error feedback; codes equal but at rounding ties."""
    rng = np.random.default_rng(6)
    shapes = {"w": (40, 300), "v": (300,), "s": ()}
    jerr = JCo.init_error_feedback({k: jnp.zeros(s) for k, s in
                                    shapes.items()})
    terr = TCo.init_error_feedback({k: torch.zeros(s) for k, s in
                                    shapes.items()})
    for _ in range(5):
        g = {k: np.asarray(rng.standard_normal(s), np.float32)
             for k, s in shapes.items()}
        jc, jerr = JCo.compress_with_feedback(jax.tree.map(jnp.asarray, g),
                                              jerr)
        tc, terr = TCo.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, terr)
        assert TCo.compressed_bytes(tc) == JCo.compressed_bytes(jc)
        for k in shapes:
            diff = np.abs(tc[k]["q"].numpy().astype(int)
                          - np.asarray(jc[k]["q"]).astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            np.testing.assert_allclose(tc[k]["scale"].numpy(),
                                       np.asarray(jc[k]["scale"]), rtol=1e-6)
            np.testing.assert_allclose(_np(terr[k]), _np(jerr[k]),
                                       atol=2e-6)
        like = {k: torch.zeros(s) for k, s in shapes.items()}
        got = TCo.decompress(tc, like)
        want = JCo.decompress(jc, {k: jnp.zeros(s) for k, s in
                                   shapes.items()})
        for k in shapes:
            assert got[k].shape == tuple(want[k].shape)
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=2e-6)


@pytest.mark.parametrize("s,m", [(2, 4), (4, 8), (4, 2), (3, 3)])
def test_schedule_1f1b_invariants(pkg, s, m):
    timeline = pkg.pi.schedule_1f1b(s, m)
    fwd_t, bwd_t = {}, {}
    for ts, ticks in enumerate(timeline):
        stages = [t.stage for t in ticks]
        assert len(stages) == len(set(stages))
        for t in ticks:
            key = (t.stage, t.micro)
            book = fwd_t if t.phase == "fwd" else bwd_t
            assert key not in book
            book[key] = ts
    assert len(fwd_t) == s * m and len(bwd_t) == s * m
    for (st, mi), ts in fwd_t.items():
        if st + 1 < s:
            assert fwd_t[(st + 1, mi)] > ts
            assert bwd_t[(st, mi)] > bwd_t[(st + 1, mi)]
        assert bwd_t[(st, mi)] > ts
    other = TPi if pkg.pi is JPi else JPi
    assert [[(t.stage, t.micro, t.phase) for t in ticks]
            for ticks in timeline] == \
        [[(t.stage, t.micro, t.phase) for t in ticks]
         for ticks in other.schedule_1f1b(s, m)]


def test_bubble_fraction_shrinks_with_microbatches(pkg):
    b2 = pkg.pi.bubble_fraction(4, 4)
    b8 = pkg.pi.bubble_fraction(4, 16)
    assert b8 < b2 < 0.6
    assert b2 == JPi.bubble_fraction(4, 4) and b8 == JPi.bubble_fraction(4, 16)


def test_run_pipelined_matches_sequential(pkg):
    stages = [lambda x, i=i: x * 2 + i for i in range(4)]
    micro = [pkg.arr(np.asarray(float(m), np.float32)) for m in range(6)]
    got = pkg.pi.run_pipelined(stages, micro)
    for m, x in enumerate(micro):
        want = x
        for f in stages:
            want = f(want)
        assert float(got[m]) == float(want)


# --------------------------------------------------- the corpus training loop

def _lake_graph(C, lake):
    b = C.GraphArBuilder("corpus")
    b.add_vertices(
        C.VertexTypeSchema("doc", [C.PropertySchema("tokens", "tokens")],
                           labels=list(lake.labels), page_size=128),
        {"tokens": lake.tokens}, lake.labels)
    b.add_edges(C.EdgeTypeSchema("doc", "links", "doc", page_size=128),
                lake.links_src, lake.links_dst)
    return b.build()


def test_graph_corpus_training_loop_matches_reference(tmp_path):
    """``examples/train_graph_corpus.py``'s loop for 3 steps at a tiny
    lake: quality-filtered, link-expanded batches, AdamW with warmup
    cosine, the trainer; the port's pipeline on ``torch``."""
    import repro.core as JCore
    import repro_torch.core as TCore
    from repro.data.pipeline import GraphCorpusPipeline as JPipe
    from repro.data.pipeline import PipelineConfig as JPCfg
    from repro.data.synthetic import document_graph as jdocs
    from repro_torch.data.pipeline import GraphCorpusPipeline, PipelineConfig
    from repro_torch.data.synthetic import document_graph
    steps, vocab = 3, 512
    jpipe = JPipe(_lake_graph(JCore, jdocs(num_docs=4000, vocab=vocab, mean_len=24, seed=0)),
                  (JCore.L("HighQuality") | JCore.L("News"))
                  & ~JCore.L("Spam"), JPCfg(seq_len=32, batch_size=4))
    pipe = GraphCorpusPipeline(
        _lake_graph(TCore, document_graph(num_docs=4000, vocab=vocab, mean_len=24,
                                   seed=0)),
        (TCore.L("HighQuality") | TCore.L("News")) & ~TCore.L("Spam"),
        PipelineConfig(seq_len=32, batch_size=4), engine="torch")
    np.testing.assert_array_equal(pipe.eligible, jpipe.eligible)
    got = [next(s) for s in [pipe.batches()] for _ in range(steps)]
    want = [next(s) for s in [jpipe.batches()] for _ in range(steps)]
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
    io, jio = pipe.io_stats(), jpipe.io_stats()
    assert (io.nbytes, io.nrequests) == (jio.nbytes, jio.nrequests)

    jm, _, tm, state = smollm(vocab_size=vocab, n_units=2)

    def config(C, name):
        return C(total_steps=steps, checkpoint_every=50,
                 checkpoint_dir=str(tmp_path / name), log_every=1)

    jout = JTrainer(jm, JO.adamw(JS.warmup_cosine(3e-4, 20, steps)),
                    config(JTrainerConfig, "jax"),
                    lambda s: {k: jnp.asarray(want[s][k])
                               for k in ("tokens", "labels")}).run()
    out = FromReference(tm, TO.adamw(TS.warmup_cosine(3e-4, 20, steps)),
                        config(TrainerConfig, "torch"),
                        lambda s: {k: got[s][k] for k in ("tokens", "labels")},
                        state=state).run()
    assert len(out["history"]) == len(jout["history"]) == steps
    for g, w in zip(out["history"], jout["history"]):
        assert g["step"] == w["step"]
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4)
