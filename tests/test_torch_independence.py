"""The port stands alone: it imports neither JAX nor the JAX package, and
``engine="cuda"`` never quietly runs on the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as TC
from repro_torch.kernels.traversal import ops as trav

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
#: ``jax``/``repro`` exactly, or a submodule of either; ``repro_torch``
#: shares the prefix but not the name
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)",
                       re.MULTILINE)

PROBE = """
import sys
import numpy as np
import torch
import repro_torch.core as TC
from repro_torch.data.synthetic import clustered_labels, powerlaw_graph
from repro_torch.kernels.traversal.ops import frontier_edge_counts
torch.set_num_threads(1)
n = 600
src, dst = powerlaw_graph(n, 5, seed=1)
adj = TC.build_adjacency(src, dst, n, n, TC.BY_SRC, TC.ENC_GRAPHAR,
                         page_size=128)
labels = clustered_labels(n, ["A", "B"], run_scale=32, seed=1)
vt = TC.VertexTable.build(TC.VertexTypeSchema("v", [], labels=["A", "B"]),
                          {}, labels, num_vertices=n)
filt = TC.LabelFilter(vt, TC.L("A") | ~TC.L("B"))
for batch in (5, 40):
    pac = TC.retrieve_neighbors_batch(adj, np.arange(batch), 256,
                                      engine="torch", filter=filt)
    assert pac.count() > 0
ids = TC.k_hop(adj, [1, 2], 2, engine="torch", filter=filt)
assert ids.size > 2
starts, ends = filt.intervals("numpy")
off = np.asarray(adj.offsets["<offset>"].values, np.int64)
counts = frontier_edge_counts(adj, starts, ends, off[starts], off[ends],
                              engine="torch")
assert counts.sum() > 0
# the mutable plane: an ingest, reads with rows pending, a durable
# compaction into a temporary store, reads after it
import tempfile
from repro_torch.core.compaction import CompactionRunner
from repro_torch.core.delta_segment import ingest_edges, live_delta
from repro_torch.core.storage import GraphStore
rng = np.random.default_rng(3)
ingest_edges(adj, rng.integers(0, n, 200), rng.integers(0, n, 200))
pending = TC.k_hop(adj, [1, 2], 2, engine="torch", filter=filt)
assert TC.retrieve_neighbors_batch(adj, np.arange(40), 256,
                                   engine="torch").count() > 0
with tempfile.TemporaryDirectory() as root:
    store = GraphStore(root)
    store.write(adj.table)
    store.write(adj.offsets)
    assert CompactionRunner(adj, store=store).compact()
    assert store.current_generation() == 1 and live_delta(adj) is None
assert (TC.k_hop(adj, [1, 2], 2, engine="torch", filter=filt)
        == pending).all()
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED", bad)
"""


QUERY_PROBE = """
import sys
import torch
from repro_torch.core import query as Q
from repro_torch.data.synthetic import ldbc_like
from repro_torch.kernels.pac_decode import ops as pac_ops
torch.set_num_threads(1)
snb = ldbc_like(scale=1, seed=0)
g = Q.build_snb_graphar(snb, 1024)
base = Q.build_snb_baseline(snb, 1024)
for resident in (True, False):
    pac_ops.DEVICE_RESIDENT = resident
    assert Q.is3_graphar(g, 17, engine="torch")[0].size
    assert Q.ic8_graphar(g, 426, engine="torch",
                         reply_label="TagClass0")[0].size
    assert Q.bi2_graphar(g, "TagClass3", engine="torch") == \
        Q.bi2_acero(base, "TagClass3")
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED", bad)
"""


ENTRY_PROBE = """
import sys
import numpy as np
import torch
import repro_torch.core as TC
from repro_torch.data.synthetic import powerlaw_graph
from repro_torch.kernels.bitmap_select.ops import select_from_pages
from repro_torch.kernels.pac_decode import ops as pac_ops
from repro_torch.kernels.rle_filter.ops import rle_to_bitmap
torch.set_num_threads(1)
n = 600
src, dst = powerlaw_graph(n, 5, seed=1)
adj = TC.build_adjacency(src, dst, n, n, TC.BY_SRC, TC.ENC_GRAPHAR,
                         page_size=128)
enc = adj.table["<dst>"].encoded
assert pac_ops.ids_to_bitmap(np.array([5, 7, 5]), 0, 1, "torch")[0] == 160
assert pac_ops.decode_range_to_bitmap(enc, 0, enc.count, 0, 19,
                                      "torch").any()
assert rle_to_bitmap(TC.rle_encode_bool(np.arange(n) % 3 == 0), True,
                     "torch").any()
pac = TC.PAC.from_ids(np.arange(0, n, 7), 128)
vals = np.arange(n, dtype=np.float32)
sel = select_from_pages(pac, {p: vals[p * 128:(p + 1) * 128]
                              for p in pac.pages()}, "torch")
assert sel.tolist() == list(range(0, n, 7))
vt = TC.VertexTable.build(
    TC.VertexTypeSchema("v", [TC.PropertySchema("age", "int64")],
                        page_size=128),
    {"age": np.arange(n) % 100}, {}, num_vertices=n)
filt = TC.NumericFilter(vt, TC.NumProp("age").between(18, 30))
for batch in (5, 40):
    for resident in (True, False):
        assert TC.retrieve_neighbors_batch(adj, np.arange(batch), 128,
                                           engine="torch", filter=filt,
                                           resident=resident).count() > 0
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED", bad)
"""


LM_PROBE = """
import sys
import numpy as np
import torch
import repro_torch.configs as RC
import repro_torch.kernels.flash_attention.ops as fa
from repro_torch.models import build_model
from repro_torch.serve.sampling import sample
torch.set_num_threads(1)
cfg = RC.get_config("smollm-360m").reduced().with_(use_flash=True)
model = build_model(cfg, "cpu").init(0)
tokens = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab_size, (2, 32)).astype(np.int32))
with torch.no_grad():
    logits, _ = model({"tokens": tokens})
assert logits.shape == (2, 32, cfg.vocab_size)
cache = model.init_cache(2, 40)
logits, cache = model.prefill({"tokens": tokens}, cache)
logits, cache = model.decode_step(sample(logits[:, -1])[:, None], cache)
assert int(cache["index"]) == 33 and bool(torch.isfinite(logits).all())
q = torch.zeros((1, 2, 64, 32))
assert fa.mha(q, q[:, :1], q[:, :1]).shape == q.shape
from repro_torch.configs.graphar_paper import PAPER_WORKLOADS
from repro_torch.models.moe import moe_ref
from repro_torch.models.ssm import ssd_reference
assert "snb-sf-small" in PAPER_WORKLOADS and moe_ref and ssd_reference
rng = np.random.default_rng(1)
for arch in ("deepseek-moe-16b", "mamba2-2.7b", "jamba-1.5-large-398b",
             "whisper-small", "llama-3.2-vision-11b"):
    cfg = RC.get_config(arch).reduced().with_(n_units=1)
    model = build_model(cfg, "cpu").init(0)
    batch = {"tokens": tokens[:, :8]}
    if cfg.encoder_layers:
        batch["frames"] = torch.zeros((2, 16, cfg.d_model))
    if cfg.num_vision_tokens:
        batch["vision"] = torch.ones((2, 4, cfg.d_model))
    cache = model.init_cache(2, 16, ctx_len=16 if cfg.encoder_layers else 4)
    logits, cache = model.prefill(batch, cache)
    logits, cache = model.decode_step(sample(logits[:, -1])[:, None], cache)
    assert bool(torch.isfinite(logits).all()), arch
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED", bad)
"""


SERVE_PROBE = """
import sys
import numpy as np
import torch
import repro_torch.configs as RC
import repro_torch.core as TC
from repro_torch.data.pipeline import GraphCorpusPipeline, PipelineConfig
from repro_torch.data.synthetic import document_graph
from repro_torch.ft.faults import FaultPlan
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.overload import OverloadConfig
from repro_torch.serve.retrieval import GraphRetriever
from repro_torch.serve.tenancy import TenantConfig
torch.set_num_threads(1)
lake = document_graph(num_docs=200, vocab=512, mean_len=32, seed=5)
b = TC.GraphArBuilder("docs")
b.add_vertices(TC.VertexTypeSchema("doc", [TC.PropertySchema("tokens",
               "tokens")], labels=list(lake.labels), page_size=128),
               {"tokens": lake.tokens}, lake.labels)
b.add_edges(TC.EdgeTypeSchema("doc", "links", "doc", page_size=128),
            lake.links_src, lake.links_dst)
g = b.build()
adj = g.adjacency("doc-links-doc", TC.BY_SRC)
retr = GraphRetriever(adj, g.vertex("doc").table["tokens"], engine="torch",
                      meter=TC.IOMeter(), hops=2, filter_vt=g.vertex("doc"),
                      filter_cond=TC.L("HighQuality") & ~TC.L("Spam"))
cfg = RC.get_config("smollm-360m").reduced().with_(n_units=2)
model = build_model(cfg, "cpu").init(0)
eng = ServeEngine(model, max_slots=3, max_len=96, eos_id=-1,
                  context_fn=retr, pipeline=True,
                  tenants=[TenantConfig("prod", weight=3),
                           TenantConfig("batch", rate=1.0, burst=2.0)],
                  overload=OverloadConfig(target_p99_ms=1e3),
                  faults=FaultPlan({"serve.retrieval": 1}))
rng = np.random.default_rng(0)
for i, v in enumerate(np.flatnonzero(adj.degrees() > 0)[:8]):
    eng.submit(Request(i, rng.integers(4, 512, 6).astype(np.int32),
                       max_new_tokens=3, context_vertex=int(v),
                       tenant=("prod", "batch")[i % 2]))
fin = eng.run_until_drained()
assert fin and eng.stats()["retrieval"]["calls"] > 0
pipe = GraphCorpusPipeline(g, TC.L("News"), PipelineConfig(seq_len=32,
                                                           batch_size=2),
                           engine="torch")
assert next(pipe.batches())["tokens"].shape == (2, 32)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED", bad)
"""


PARTITION_PROBE = """
import sys
import numpy as np
import torch
import repro_torch.core as TC
from repro_torch.data.synthetic import clustered_labels, powerlaw_graph
from repro_torch.kernels.pac_decode import ops as pac_ops
from repro_torch.serve.retrieval import GraphRetriever
torch.set_num_threads(1)
n = 600
src, dst = powerlaw_graph(n, 5, seed=1)
adj = TC.build_adjacency(src, dst, n, n, TC.BY_SRC, TC.ENC_GRAPHAR,
                         page_size=64)
labels = clustered_labels(n, ["A", "B"], run_scale=32, seed=1)
vt = TC.VertexTable.build(TC.VertexTypeSchema("v", [], labels=["A", "B"]),
                          {}, labels, num_vertices=n)
filt = TC.LabelFilter(vt, TC.L("A"))
TC.attach_page_cache(adj.table["<dst>"], 16)
want = TC.k_hop(adj, [1, 2], 2, engine="numpy")
for mesh in (1, 4):
    # the multi-device tail on a mesh naming the CPU `mesh` times
    pac_ops._devices = lambda engine, m=mesh: (torch.device("cpu"),) * m
    pac_ops.SHARD_MIN_PAGES = 0
    for parts in (3, 8):
        assert TC.retrieve_neighbors_batch(adj, np.arange(40), 256,
                                           engine="torch", filter=filt,
                                           partitions=parts).count() > 0
        assert (TC.k_hop(adj, [1, 2], 2, engine="torch",
                         partitions=parts) == want).all()
tokens = TC.TokensColumn("t", [np.arange(4, dtype=np.int32)] * n, 64)
retr = GraphRetriever(adj, tokens, engine="torch", partitions=8)
retr(np.arange(12))
assert retr.stats()["partitions"]["n_parts"] == 8
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED", bad)
"""


TRAIN_PROBE = """
import os
import sys
import tempfile
import numpy as np
import torch
import repro_torch.configs as RC
from repro_torch.checkpoint.checkpointer import (restore_checkpoint,
                                                 save_checkpoint)
from repro_torch.distributed.collectives import (compress_with_feedback,
                                                 init_error_feedback)
from repro_torch.distributed.pipeline import bubble_fraction
from repro_torch.ft.coordinator import Coordinator
from repro_torch.models import build_model
from repro_torch.train.optimizer import adafactor, adamw
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import (make_train_step, model_params,
                                          unit_layout)
from repro_torch.train.trainer import Trainer, TrainerConfig
torch.set_num_threads(1)
cfg = RC.get_config("smollm-360m").reduced().with_(n_units=2, remat="dots")
model = build_model(cfg, "cpu").init(0)
rng = np.random.default_rng(0)
batch = {k: rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
         for k in ("tokens", "labels")}
params = model_params(model)
for opt in (adamw(warmup_cosine(1e-3, 2, 10), moment_dtype="int8"),
            adafactor(1e-3)):
    p1, s1, m = make_train_step(model, opt, 2)(
        params, opt.init(params, unit_layout(model)), batch)
    assert bool(torch.isfinite(m["loss"]))
comp, _ = compress_with_feedback(p1, init_error_feedback(p1))
assert 0 < bubble_fraction(2, 4) < 1
with tempfile.TemporaryDirectory() as root:
    save_checkpoint(root, 1, {"params": p1, "opt": s1})
    tree, _ = restore_checkpoint(root, 1, like={"params": p1, "opt": s1})
    assert all(torch.equal(tree["params"][k], v) for k, v in p1.items())
    out = Trainer(model, adamw(1e-3), TrainerConfig(
        total_steps=2, checkpoint_every=1,
        checkpoint_dir=os.path.join(root, "run"), log_every=1),
        lambda s: batch, Coordinator(1)).run()
    assert out["final_step"] == 2
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED", bad)
"""


LAUNCH_PROBE = """
import sys
import tempfile
import torch
import repro_torch.configs as RC
from repro_torch.checkpoint.checkpointer import save_checkpoint
from repro_torch.checkpoint.reshard import (device_put_resharded,
                                            elastic_restore)
from repro_torch.distributed.sharding import constrain, shard_params
from repro_torch.launch import dryrun, report, roofline, serve, shapes
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.train.train_step import model_params
torch.set_num_threads(1)
row = dryrun.run_cell("whisper-small", "prefill_32k", False,
                      mesh_factory=make_test_mesh)
assert row["status"] == "ok" and row["t_memory_s"] > 0
assert report.analytic_memory_floor("smollm-360m", "train_4k", 256, False)
cfg = RC.get_config("smollm-360m").reduced()
params = model_params(build_model(cfg, "cpu").init(0))
mesh = make_test_mesh(device="cpu")
placed = device_put_resharded(params, mesh, cfg)
assert all(torch.equal(placed[n].full(), p) for n, p in params.items())
with tempfile.TemporaryDirectory() as d:
    save_checkpoint(d, 1, params)
    back, _ = elastic_restore(d, 1, params, mesh, cfg)
assert torch.equal(back["embed"].shards[0], placed["embed"].shards[0])
with mesh:
    assert constrain(params["embed"], "dp", "model") is params["embed"]
assert serve.main(["--arch", "smollm-360m", "--reduced", "--requests", "2",
                   "--max_new_tokens", "2", "--device", "cpu"])["tokens"] == 4
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED", bad)
"""


SHARDED_PROBE = """
import sys
import numpy as np
import torch
import torch.distributed as dist
import repro_torch.configs as RC
from repro_torch.launch.mesh import distributed_mesh, init_world
from repro_torch.models import build_model
from repro_torch.models.model import shard_model
torch.set_num_threads(1)
rank, port = int(sys.argv[1]), int(sys.argv[2])
init_world(rank, 2, f"tcp://localhost:{port}", backend="gloo", timeout_s=60)
mesh = distributed_mesh((1, 2), ("data", "model"))
cfg = RC.get_config("stablelm-1.6b").reduced().with_(use_flash=True)
model = shard_model(build_model(cfg, "cpu").init(0), mesh)
tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
with mesh, torch.no_grad():
    logits, _ = model({"tokens": tokens.astype(np.int32)})
assert logits.shape == (2, 16, cfg.vocab_size)
dist.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED", bad)
"""


def test_sharded_forward_loads_neither_jax_nor_the_jax_package():
    """A gloo world of 2 ranks: a sharded forward (stablelm's flash route
    on each rank's local heads); neither rank has JAX in ``sys.modules``
    after it."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, "-c", SHARDED_PROBE, str(r),
                               str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "LOADED []" in out, out


def test_launch_loads_neither_jax_nor_the_jax_package():
    """A dry-run row, a placement, an elastic restore, a constraint and
    the serve CLI."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", LAUNCH_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_training_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", TRAIN_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_training_without_a_card_raises(monkeypatch, tmp_path):
    """The trainer's model and the launcher default to the card."""
    import repro_torch.configs as RC
    from repro_torch.launch import train as launch
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = RC.get_config("smollm-360m").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        Trainer(build_model(cfg), adamw(1e-3), TrainerConfig(), dict)
    with pytest.raises(RuntimeError, match="CUDA device"):
        launch.main(["--arch", "smollm-360m", "--reduced", "--steps", "1",
                     "--checkpoint_dir", str(tmp_path)])
    # --lower-only needs no card: it runs the port's dry-run on meta in a
    # subprocess and exits with its code
    calls = []
    monkeypatch.setattr("subprocess.call",
                        lambda argv: calls.append(argv) or 0)
    with pytest.raises(SystemExit) as e:
        launch.main(["--arch", "smollm-360m", "--lower-only"])
    assert e.value.code == 0
    assert calls[0][1:] == ["-m", "repro_torch.launch.dryrun", "--arch",
                            "smollm-360m", "--shape", "train_4k", "--mesh",
                            "single"]


def test_partitioned_retrieval_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PARTITION_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_serving_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", SERVE_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_lm_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", LM_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_kernel_entries_load_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", ENTRY_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_queries_load_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", QUERY_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_retrieval_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_sources_import_neither_jax_nor_the_jax_package():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) > 15
    offenders = {str(f.relative_to(SRC)): FORBIDDEN.findall(f.read_text())
                 for f in files}
    assert not {k: v for k, v in offenders.items() if v}
    # the pattern itself: the port's own name passes, the reference's fails
    assert not FORBIDDEN.search("from repro_torch.core import L")
    assert FORBIDDEN.search("from repro.core import L")
    assert FORBIDDEN.search("import jax.numpy as jnp")


EXAMPLES = SRC.parent / "examples"
#: each port example and the arguments of its shortest run
PORT_EXAMPLES = {"quickstart_torch": [], "ldbc_queries_torch": [],
                 "serve_batched_torch": [],
                 "train_graph_corpus_torch": ["--steps", "1"]}
EXAMPLE_PROBE = """
import os, runpy, sys
path = sys.argv[1]
sys.argv = [path] + sys.argv[2:]
sys.path.insert(0, os.path.dirname(path))     # as ``python path`` does
try:
    runpy.run_path(path, run_name="__main__")
except RuntimeError as e:
    print("RAISED", e)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED", bad)
"""


def _examples(device, tmp_path):
    """Every port example run with ``--device DEVICE`` in a process of its
    own with no card visible, all at once: their outputs by name."""
    procs = {}
    for name, args in PORT_EXAMPLES.items():
        tmp = tmp_path / f"{name}_{device}"
        tmp.mkdir()
        env = dict(os.environ, PYTHONPATH=str(SRC), TMPDIR=str(tmp),
                   CUDA_VISIBLE_DEVICES="")
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", EXAMPLE_PROBE,
             str(EXAMPLES / f"{name}.py"), "--device", device] + args,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    outs = {}
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs[name] = out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_examples_load_neither_jax_nor_the_jax_package(tmp_path):
    """Each port example, run whole on the CPU, leaves neither ``jax`` nor
    ``repro`` in ``sys.modules``; its sources name neither."""
    for name, out in _examples("cpu", tmp_path).items():
        assert "RAISED" not in out, (name, out)
        assert "LOADED []" in out, (name, out)
    sources = sorted(EXAMPLES.glob("*_torch*.py"))
    assert len(sources) == 5            # the four and their device helper
    for f in sources:
        assert not FORBIDDEN.findall(f.read_text()), f.name


def test_examples_without_a_card_raise(tmp_path):
    """The default ``--device cuda`` raises without a card, before any
    work: nothing falls back to the CPU."""
    for name, out in _examples("cuda", tmp_path).items():
        assert "RAISED no CUDA device" in out, (name, out)
        assert "LOADED []" in out, (name, out)


def test_cuda_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 300
    rng = np.random.default_rng(0)
    adj = TC.build_adjacency(rng.integers(0, n, 2000),
                             rng.integers(0, n, 2000), n, n, TC.BY_SRC,
                             TC.ENC_GRAPHAR, page_size=128)
    meter = TC.IOMeter()
    for batch in (4, 32):               # the decode and the fused routes
        with pytest.raises(RuntimeError, match="CUDA device"):
            TC.retrieve_neighbors_batch(adj, np.arange(batch), 128, meter)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TC.neighbor_ids_batch(adj, np.arange(4), engine="cuda")
    meter = TC.IOMeter()
    with pytest.raises(RuntimeError, match="CUDA device"):
        TC.k_hop(adj, np.arange(4), 2, meter)          # fused by default
    with pytest.raises(RuntimeError, match="CUDA device"):
        trav.two_hop_pac(adj, adj, np.arange(4), 128, meter=meter)
    with pytest.raises(RuntimeError, match="CUDA device"):
        trav.frontier_edge_counts(adj, [0], [9], [0], [9], meter)
    assert meter.nbytes == 0 and not hasattr(adj, "_traversal_plans")


def test_cuda_engine_without_a_card_raises_per_dispatch(monkeypatch):
    from repro_torch.kernels.pac_decode import ops as pac_ops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pac_ops, "DEVICE_RESIDENT", False)
    n = 300
    rng = np.random.default_rng(0)
    adj = TC.build_adjacency(rng.integers(0, n, 2000),
                             rng.integers(0, n, 2000), n, n, TC.BY_SRC,
                             TC.ENC_GRAPHAR, page_size=128)
    meter = TC.IOMeter()
    for batch in (4, 32):               # the decode and the fused routes
        with pytest.raises(RuntimeError, match="CUDA device"):
            TC.retrieve_neighbors_batch(adj, np.arange(batch), 128, meter,
                                        resident=False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TC.k_hop(adj, np.arange(4), 2, meter)          # the host loop
    with pytest.raises(RuntimeError, match="CUDA device"):
        pac_ops.decode_pages(adj.table["<dst>"].encoded, 0, 2)


def test_cuda_engine_without_a_card_raises_kernel_entries(monkeypatch):
    from repro_torch.kernels.bitmap_select.ops import select_from_pages
    from repro_torch.kernels.pac_decode import ops as pac_ops
    from repro_torch.kernels.rle_filter.ops import rle_to_bitmap
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    col = TC.delta_encode_column(np.arange(300), 128)
    pac = TC.PAC.from_ids(np.arange(0, 300, 7), 128)
    n = 300
    vt = TC.VertexTable.build(
        TC.VertexTypeSchema("v", [TC.PropertySchema("age", "int64")],
                            page_size=128),
        {"age": np.arange(n) % 100}, {}, num_vertices=n)
    filt = TC.NumericFilter(vt, TC.NumProp("age") >= 90)
    calls = [
        lambda: pac_ops.ids_to_bitmap(np.arange(9), 0, 4),
        lambda: pac_ops.decode_range_to_bitmap(col, 0, col.count, 0, 10),
        lambda: rle_to_bitmap(TC.rle_encode_bool(np.ones(9, bool))),
        lambda: select_from_pages(pac, {p: np.zeros(128, np.float32)
                                        for p in pac.pages()}),
        lambda: filt.bitmap("cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
