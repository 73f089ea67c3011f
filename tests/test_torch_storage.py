"""Storage-plane parity of the PyTorch port with the JAX package.

One seeded graph, built by both packages, must give equal packed batch
arrays and unpack plans, byte-identical ``.gar`` containers that each
package reads back from the other, and the same host-read IOMeter.
Everything compared is an integer or a byte string: the tolerance is
exact equality.
"""
import os

import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as TC
from repro.core import storage as RS
from repro_torch.core import storage as TS
from repro_torch.core.encoding import packed_from_arrays

torch.set_num_threads(1)

N = 1500
PAGE = 256
LABELS = ["A", "B", "C"]


def _graph(mod, src, dst, labels, props):
    """GraphArBuilder graph with every column kind the storage plane has."""
    vs = mod.VertexTypeSchema(
        "person",
        [mod.PropertySchema("age", "int64"),
         mod.PropertySchema("score", "float32"),
         mod.PropertySchema("name", "string"),
         mod.PropertySchema("doc", "tokens")],
        labels=LABELS, page_size=PAGE)
    es = mod.EdgeTypeSchema("person", "knows", "person",
                            [mod.PropertySchema("w", "int32")],
                            adjacency=["by_src", "by_dst"], page_size=PAGE)
    b = mod.GraphArBuilder("g")
    b.add_vertices(vs, props, labels)
    b.add_edges(es, src, dst, {"w": np.arange(len(src), dtype=np.int32)})
    return b.build()


@pytest.fixture(scope="module")
def graphs():
    from repro_torch.data.synthetic import clustered_labels, powerlaw_graph
    src, dst = powerlaw_graph(N, 5, seed=21)
    labels = clustered_labels(N, LABELS, density=0.4, run_scale=48, seed=3)
    rng = np.random.default_rng(4)
    props = {"age": rng.integers(0, 90, N),
             "score": rng.random(N).astype(np.float32),
             "name": [f"p{i % 97}" for i in range(N)],
             "doc": [rng.integers(0, 50, rng.integers(0, 6)).astype(np.int32)
                     for _ in range(N)]}
    return _graph(RC, src, dst, labels, props), \
        _graph(TC, src, dst, labels, props)


def test_synthetic_streams_match():
    from repro.data import synthetic as rsyn
    from repro_torch.data import synthetic as tsyn
    for a, b in zip(rsyn.powerlaw_graph(777, 7, seed=9),
                    tsyn.powerlaw_graph(777, 7, seed=9)):
        np.testing.assert_array_equal(a, b)
    ra = rsyn.clustered_labels(999, ["x", "y"], run_scale=40, seed=2)
    ta = tsyn.clustered_labels(999, ["x", "y"], run_scale=40, seed=2)
    for k in ra:
        np.testing.assert_array_equal(ra[k], ta[k])


@pytest.mark.parametrize("order", ["by_src", "by_dst"])
def test_packed_arrays_and_unpack_plan_equal(graphs, order):
    rg, tg = graphs
    radj = rg.adjacency("person-knows-person", order)
    tadj = tg.adjacency("person-knows-person", order)
    rp = RC.pack_column(radj.table[radj.value_col].encoded)
    tp = TC.pack_column(tadj.table[tadj.value_col].encoded)
    for a, b in zip(rp.host_arrays(), tp.host_arrays()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rp.unpack_plan(), tp.unpack_plan()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rp.page_min, tp.page_min)
    np.testing.assert_array_equal(rp.page_max, tp.page_max)
    # the port's PackedPages fed from the reference's six host arrays
    fed = packed_from_arrays(*rp.host_arrays(), page_size=PAGE)
    for a, b in zip(fed.unpack_plan(), tp.unpack_plan()):
        np.testing.assert_array_equal(a, b)


def test_device_plan_mirrors_once_per_device(graphs):
    _, tg = graphs
    tp = TC.pack_column(tg.adjacency("person-knows-person")
                        .table["<dst>"].encoded)
    before = tp.device_transfers
    plan = tp.device_plan("cpu")
    assert tp.device_plan(torch.device("cpu")) is plan
    assert tp.device_transfers == before + 1
    first, pos, mind, packed = tp.unpack_plan()
    for t, a in zip(plan, (first, pos, mind, packed.view(np.int32))):
        assert t.dtype == torch.int32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), a)


def _tables(g):
    out = {}
    for vt in g.vertices.values():
        out[vt.table.name] = vt.table
    for et in g.edges.values():
        for adj in et.layouts.values():
            out[adj.table.name] = adj.table
            out[adj.offsets.name] = adj.offsets
    return out


def test_table_blobs_byte_identical(graphs):
    rt, tt = (_tables(g) for g in graphs)
    assert sorted(rt) == sorted(tt)
    for name in rt:
        assert RS.table_blob(rt[name]) == TS.table_blob(tt[name]), name


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lake_reads_in_the_other_package(graphs, tmp_path, writer):
    rg, tg = graphs
    root = str(tmp_path / writer)
    (rg if writer == "jax" else tg).save(root)
    reader_store = (TS.GraphStore(root) if writer == "jax"
                    else RS.GraphStore(root))
    writer_blob = RS.table_blob if writer == "jax" else TS.table_blob
    reader_blob = TS.table_blob if writer == "jax" else RS.table_blob
    names = reader_store.list_tables()
    assert names == sorted(_tables(rg))
    for name in names:
        table = reader_store.read(name)
        with open(os.path.join(root, f"{name}.gar"), "rb") as f:
            on_disk = f.read()
        assert reader_blob(table) == on_disk == writer_blob(
            _tables(rg if writer == "jax" else tg)[name])
    schema = reader_store.read_schema_yaml()
    assert schema.to_dict() == rg.schema.to_dict()


def test_host_reads_meter_identically(graphs):
    rg, tg = graphs
    radj = rg.adjacency("person-knows-person")
    tadj = tg.adjacency("person-knows-person")
    rng = np.random.default_rng(8)
    vs = rng.integers(0, N, 40)
    rm, tm = RS.IOMeter(), TS.IOMeter()
    rl, rh = radj.edge_ranges_batch(vs, rm)
    tl, th = tadj.edge_ranges_batch(vs, tm)
    np.testing.assert_array_equal(rl, tl)
    np.testing.assert_array_equal(rh, th)
    np.testing.assert_array_equal(
        radj.table["<dst>"].read_rows_concat(rl, rh, rm),
        tadj.table["<dst>"].read_rows_concat(tl, th, tm))
    for v in vs[:5]:
        np.testing.assert_array_equal(radj.neighbor_ids(int(v), rm),
                                      tadj.neighbor_ids(int(v), tm))
    rv, tv = rg.vertex("person"), tg.vertex("person")
    for col in ("age", "<A>", "name", "doc"):
        rv.table[col].read_range(100, 700, rm)
        tv.table[col].read_range(100, 700, tm)
    assert (rm.nbytes, rm.nrequests) == (tm.nbytes, tm.nrequests)
    assert rm.nbytes > 0
    for media in ("tmpfs", "essd", "oss"):
        assert rm.seconds(RS.MEDIA[media]) == tm.seconds(TS.MEDIA[media])
