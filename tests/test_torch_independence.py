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
