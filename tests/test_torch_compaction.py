"""The port's compaction (``repro_torch/core/compaction``) against the JAX
package's: the JAX package's ``test_compaction.py`` on the port, each
case run by both packages on the same seeded graphs, ingests, fault plans
and schedules.

The compacted layout equals a from-scratch rebuild and the reference's
compacted layout page for page; serving ids and per-tick IOMeter costs
under a fault at every write boundary equal the rebuild, the no-fault
run and the reference's; generation files and manifests are
byte-identical between the packages, and a store written by either reads
in the other; the backoff schedule, the graceful give-up and resume, GC;
``_pad.shape_class_count()`` stays flat over a re-warmed epoch.  Then the
port's deliberate difference: a compaction's stale traversal plan holds
no tensors or arrays once the new plan is built, while
``traversal_stats`` equals the reference's.
"""
import os

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import compaction as JC
from repro.core import delta_segment as JD
from repro.core import storage as JS
from repro.ft import faults as JF
from repro.ft.backoff import Backoff as JBackoff
from repro.kernels.traversal import ops as JTO
from repro_torch.core import compaction as TC
from repro_torch.core import delta_segment as TD
from repro_torch.core import storage as TS
from repro_torch.ft import faults as TF
from repro_torch.ft.backoff import Backoff
from repro_torch.kernels import _pad
from repro_torch.kernels.traversal import ops as TTO

torch.set_num_threads(1)

N = 300
PAGE = 128
TPS = 512
PAIRS = [("numpy", "numpy"), ("jax", "torch")]
#: each package's modules, keyed by its core
PKG = {J: (JD, JC, JS, JF), T: (TD, TC, TS, TF)}


def _graph(mod, seed=3, n_edges=2500):
    rng = np.random.default_rng(seed)
    return mod.build_adjacency(rng.integers(0, N, n_edges),
                               rng.integers(0, N, n_edges), N, N,
                               mod.BY_SRC, mod.ENC_GRAPHAR, page_size=PAGE)


def _rebuilt(mod, adj):
    return mod.build_adjacency(*PKG[mod][0].all_edges(adj), N, N,
                               mod.BY_SRC, mod.ENC_GRAPHAR, page_size=PAGE)


def _layout(adj):
    """Every page of both columns and the offsets, as plain lists."""
    out = []
    for name in ("<src>", "<dst>"):
        enc = adj.table[name].encoded
        out.append((enc.count, [(p.count, p.first_value, p.vmin, p.vmax,
                                 p.min_deltas.tolist(),
                                 p.bit_widths.tolist(),
                                 p.word_offsets.tolist(), p.packed.tolist())
                                for p in enc.pages]))
    out.append(adj.offsets["<offset>"].values.tolist())
    return out


def _ingest(mod, adj, seed, rows):
    rng = np.random.default_rng(seed)
    PKG[mod][0].ingest_edges(adj, rng.integers(0, N, rows),
                             rng.integers(0, N, rows))


# ------------------------ the swap itself --------------------------------

def test_compacted_layout_bit_identical_to_rebuild():
    out = []
    for mod in (J, T):
        adj = _graph(mod)
        _ingest(mod, adj, 9, 200)
        oracle = _rebuilt(mod, adj)
        assert PKG[mod][1].CompactionRunner(adj).compact()
        assert PKG[mod][0].live_delta(adj) is None
        assert _layout(adj) == _layout(oracle)
        assert adj.table.num_rows == oracle.table.num_rows
        out.append((_layout(adj), adj.delta.stats()))
    assert out[0] == out[1]


def test_swap_bumps_version_and_invalidates_caches():
    adj = _graph(T)
    cols = [adj.table[n].encoded for n in ("<src>", "<dst>")]
    v0 = [c.version for c in cols]
    cache = T.attach_page_cache(adj.table["<dst>"], 16)
    T.neighbor_ids_batch(adj, np.arange(20), engine="torch")  # mirror
    old = cols[1].packed_cache
    assert old is not None and old.device_transfers == 1 and len(cache)
    TD.ingest_edges(adj, [1], [2])
    assert TC.CompactionRunner(adj).compact()
    assert [c.version for c in cols] == [v + 1 for v in v0]
    assert all(c.packed_cache is None for c in cols)  # mirrors re-ship
    assert T.live_cache(cols[1]) is cache and len(cache) == 0
    T.neighbor_ids_batch(adj, np.arange(20), engine="torch")
    assert cols[1].packed_cache.device_transfers == 1
    assert cols[1].packed_cache.version == cols[1].version
    cols[1].page_cache = None


def test_rows_ingested_after_snapshot_survive_compaction():
    """drop_rows removes exactly the frozen snapshot -- later ingests
    keep serving from the delta path (multiset difference, not prefix)."""
    out = []
    for mod in (J, T):
        adj = _graph(mod)
        d = PKG[mod][0].attach_delta(adj)
        d.ingest([1, 1, 2], [5, 5, 6])
        frozen = d.snapshot()
        d.ingest([1, 3], [5, 7])                 # post-snapshot, one a dup
        d.drop_rows(frozen)
        assert d.pending_rows() == 2
        vals, _ = d.lookup_batch(np.asarray([1, 3], np.int64))
        np.testing.assert_array_equal(vals, [5, 7])
        with pytest.raises(ValueError, match="mismatch"):
            d.drop_rows({0: (np.asarray([9]), np.asarray([9]))})
        out.append(d.stats())
    assert out[0] == out[1]


def test_policy_gates_compaction():
    """The policy fires at one row group (the column's page size) of
    pending rows, or at half the base; the port keeps the reference's
    defaults as its only setting."""
    assert TC.MAX_DELTA_FRACTION == JC.CompactionPolicy().max_delta_fraction
    out = []
    for mod in (J, T):
        D, C = PKG[mod][:2]
        gate = C.CompactionPolicy().should_compact if mod is J \
            else C.should_compact
        adj = _graph(mod)
        runner = C.CompactionRunner(adj)
        steps = [runner.maybe_compact()]         # nothing pending
        D.ingest_edges(adj, np.arange(10), np.arange(10))
        steps.append(runner.maybe_compact())     # below one row group
        assert D.live_delta(adj) is not None
        _ingest(mod, adj, 0, PAGE - 11)
        steps.append(runner.maybe_compact())     # PAGE - 1 rows
        _ingest(mod, adj, 1, 1)
        steps.append(runner.maybe_compact())     # PAGE rows: one group
        assert D.live_delta(adj) is None
        steps.append(gate(10, 20, 64))
        steps.append(gate(9, 20, 64))
        out.append(steps)
    assert out[0] == out[1] == [False, False, False, True, True, False]


# -------------------- interleaved serving invariant ----------------------

SCHEDULE = ["serve", "ingest", "serve", "ingest", "serve", "compact",
            "serve", "ingest", "serve", "compact", "serve"]


def _schedule(mod, adj, runner, engine, meter):
    """serve/ingest/compact schedule; returns per-serve-tick ids, the
    per-tick (bytes, requests) the schedule charged, and each serve
    tick's visible edge set."""
    rng = np.random.default_rng(55)
    ids, costs, edges = [], [], []
    for op in SCHEDULE:
        if op == "serve":
            vs = rng.integers(0, N, 24)
            b0, r0 = meter.nbytes, meter.nrequests
            ids.append(mod.neighbor_ids_batch(adj, vs, meter,
                                              engine=engine))
            costs.append((meter.nbytes - b0, meter.nrequests - r0))
            edges.append((vs, PKG[mod][0].all_edges(adj)))
        elif op == "ingest":
            s, d = rng.integers(0, N, 40), rng.integers(0, N, 40)
            for _ in range(4):
                try:
                    PKG[mod][0].ingest_edges(adj, s, d)
                    break
                except PKG[mod][3].InjectedFault:
                    continue                     # atomic: retry same batch
        elif op == "compact":
            runner.compact()
    return ids, costs, edges


def _store_bytes(root):
    return {f: open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root))}


@pytest.mark.parametrize("boundary", TF.BOUNDARIES)
@pytest.mark.parametrize("jeng,teng", PAIRS)
def test_interleaved_serving_invariant_under_fault(tmp_path, jeng, teng,
                                                   boundary):
    """Every serve tick's ids equal a from-scratch rebuild of the edges
    visible at that tick, under a fault at every boundary; the per-tick
    meter trace equals the no-fault run's; ids, costs, the runner's
    counters and the store's files equal the reference's, byte for
    byte."""
    assert TF.BOUNDARIES == JF.BOUNDARIES
    out = []
    for mod, engine in ((J, jeng), (T, teng)):
        D, C, S, F = PKG[mod]
        plan = F.FaultPlan({boundary: 2})
        adj = _graph(mod)
        root = str(tmp_path / mod.__name__ / "lake")
        store = S.GraphStore(root, faults=plan)
        D.attach_delta(adj, faults=plan)
        runner = C.CompactionRunner(adj, store=store, faults=plan,
                                    sleep=lambda _s: None)
        meter = mod.IOMeter()
        ids, costs, edges = _schedule(mod, adj, runner, engine, meter)
        for got, (vs, (s, d)) in zip(ids, edges):
            oracle = mod.build_adjacency(s, d, N, N, mod.BY_SRC,
                                         mod.ENC_GRAPHAR, page_size=PAGE)
            np.testing.assert_array_equal(
                got, mod.neighbor_ids_batch(oracle, vs, engine="numpy"))
        files = _store_bytes(root)
        assert not any(".tmp-" in f for f in files), sorted(files)
        if runner.compactions:
            assert store.current_generation() >= 1
        out.append(([i.tolist() for i in ids], costs, files,
                    (runner.compactions, runner.attempts, runner.faults_hit,
                     runner.gave_up), plan.stats(), adj.delta.stats()))
    assert out[0] == out[1]
    # no-fault run of the port (fresh graph, same deterministic schedule)
    adj2 = _graph(T)
    ids2, costs2, _ = _schedule(T, adj2, TC.CompactionRunner(
        adj2, sleep=lambda _s: None), teng, T.IOMeter())
    assert [i.tolist() for i in ids2] == out[1][0]
    assert costs2 == out[1][1]                   # fault-invariant footprint


@pytest.mark.parametrize("jeng,teng", PAIRS)
def test_seeded_fault_plan_from_env_matrix(jeng, teng):
    """The CI fault matrix: REPRO_FAULT_SEED derives a boundary->trips
    plan; serving + compaction end bit-identical to the rebuild and to
    the reference, whatever the seed draws."""
    seed = int(os.environ.get("REPRO_FAULT_SEED", "1"))
    out = []
    for mod, engine in ((J, jeng), (T, teng)):
        D, C, _, F = PKG[mod]
        plan = F.FaultPlan.from_seed(seed)
        adj = _graph(mod, seed=seed)
        D.attach_delta(adj, faults=plan)
        runner = C.CompactionRunner(adj, faults=plan, max_attempts=8,
                                    sleep=lambda _s: None)
        rng = np.random.default_rng(seed)
        for _ in range(3):
            try:
                D.ingest_edges(adj, rng.integers(0, N, 30),
                               rng.integers(0, N, 30))
            except F.InjectedFault:
                D.ingest_edges(adj, rng.integers(0, N, 30),
                               rng.integers(0, N, 30))
            runner.compact()
        oracle = _rebuilt(mod, adj)
        vs = rng.integers(0, N, 32)
        got = mod.neighbor_ids_batch(adj, vs, engine=engine)
        np.testing.assert_array_equal(
            got, mod.neighbor_ids_batch(oracle, vs, engine="numpy"))
        out.append((got.tolist(), plan.trips, runner.faults_hit,
                    runner.compactions, adj.delta.stats()))
    assert out[0] == out[1]


# ---------------- settled state: meters + flat shape classes -------------

@pytest.mark.parametrize("jeng,teng", PAIRS)
def test_settled_meter_bit_identical_to_rebuild(jeng, teng):
    out = []
    for mod, engine in ((J, jeng), (T, teng)):
        adj = _graph(mod)
        rng = np.random.default_rng(4)
        PKG[mod][0].ingest_edges(adj, rng.integers(0, N, 90),
                                 rng.integers(0, N, 90))
        oracle = _rebuilt(mod, adj)
        assert PKG[mod][1].CompactionRunner(adj).compact()
        vs = rng.integers(0, N, 40)
        m1, m2 = mod.IOMeter(), mod.IOMeter()
        a = mod.neighbor_ids_batch(adj, vs, m1, engine=engine)
        np.testing.assert_array_equal(
            a, mod.neighbor_ids_batch(oracle, vs, m2, engine=engine))
        assert (m1.nbytes, m1.nrequests) == (m2.nbytes, m2.nrequests)
        out.append((a.tolist(), m1.nbytes, m1.nrequests))
    assert out[0] == out[1]


def test_zero_retrace_steady_state_after_compaction():
    """The reference's zero-retrace check: after a compaction re-warms the
    new epoch, repeating the same batches mints no new launch shape."""
    adj = _graph(T)
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, N, s) for s in rng.integers(40, 64, 6)]
    for vs in batches:
        T.retrieve_neighbors_batch(adj, vs, TPS, engine="torch", fused=True,
                                   resident=True)
    TD.ingest_edges(adj, rng.integers(0, N, 50), rng.integers(0, N, 50))
    assert TC.CompactionRunner(adj).compact()
    for vs in batches:                           # re-warm the new epoch
        T.retrieve_neighbors_batch(adj, vs, TPS, engine="torch", fused=True,
                                   resident=True)
    before = _pad.shape_class_count()
    for vs in batches:
        T.retrieve_neighbors_batch(adj, vs, TPS, engine="torch", fused=True,
                                   resident=True)
    assert _pad.shape_class_count() == before


# ------------------------- durability + GC -------------------------------

def test_store_write_crash_leaves_old_file_intact(tmp_path):
    adj = _graph(T)
    path = str(tmp_path / "edges.gar")
    TS.write_table(adj.table, path)
    before = open(path, "rb").read()
    adj2 = _graph(T, seed=8)
    with pytest.raises(TF.InjectedFault):
        TS.write_table(adj2.table, path, TF.FaultPlan({"store.write": 1}))
    assert open(path, "rb").read() == before     # old contents intact
    torn = [f for f in os.listdir(tmp_path) if ".tmp-" in f]
    assert torn                                  # torn staging file left
    store = TS.GraphStore(str(tmp_path))
    assert sorted(TC.collect_garbage(store)) == sorted(torn)
    TS.write_table(adj2.table, path)             # retry goes through
    t = TS.read_table(path)
    np.testing.assert_array_equal(t["<dst>"].read_all(),
                                  adj2.table["<dst>"].read_all())
    # the reference writes the same bytes and reads the port's file
    JS.write_table(_graph(J, seed=8).table, str(tmp_path / "ref.gar"))
    assert open(tmp_path / "ref.gar", "rb").read() == open(path, "rb").read()


def _two_generations(mod, root):
    D, C, S, _ = PKG[mod]
    adj = _graph(mod)
    store = S.GraphStore(root)
    store.write(adj.table)                       # legacy layout first
    store.write(adj.offsets)
    name = adj.table.name
    runner = C.CompactionRunner(adj, store=store, sleep=lambda _s: None)
    rng = np.random.default_rng(12)
    D.ingest_edges(adj, rng.integers(0, N, 60), rng.integers(0, N, 60))
    assert runner.compact()
    assert store.current_generation() == 1
    files = set(os.listdir(store.root))
    assert f"{name}.g1.gar" in files
    assert f"{name}.gar" not in files            # superseded legacy GC'd
    D.ingest_edges(adj, rng.integers(0, N, 60), rng.integers(0, N, 60))
    assert runner.compact()
    assert store.current_generation() == 2
    files = set(os.listdir(store.root))
    assert f"{name}.g2.gar" in files
    assert f"{name}.g1.gar" not in files         # old generation GC'd
    assert store.list_tables() == sorted({name, adj.offsets.name})
    return adj, store


def test_manifest_flip_and_generation_gc(tmp_path):
    """Two committed generations in each package: the same files, byte for
    byte; each package's committed tables read back in the other equal to
    the live compacted layout."""
    (jadj, jstore), (tadj, tstore) = (
        _two_generations(mod, str(tmp_path / mod.__name__))
        for mod in (J, T))
    assert _store_bytes(jstore.root) == _store_bytes(tstore.root)
    name = tadj.table.name
    for store in (jstore, tstore):
        for reader, adj in ((JS.GraphStore(store.root), jadj),
                            (TS.GraphStore(store.root), tadj)):
            for logical, live in ((name, adj.table),
                                  (adj.offsets.name, adj.offsets)):
                t = reader.read(logical)
                for col in live.columns:
                    np.testing.assert_array_equal(
                        t[col].read_all(), live[col].read_all())
    assert _layout(jadj) == _layout(tadj)


def test_uncommitted_generation_is_invisible_and_collected(tmp_path):
    adj = _graph(T)
    store = TS.GraphStore(str(tmp_path / "lake"))
    store.write(adj.table)
    store.write_generation(adj.table, 7)         # staged, never committed
    assert store.list_tables() == [adj.table.name]
    assert store.current_generation() == 0
    t = store.read(adj.table.name)               # legacy file still serves
    assert t.num_rows == adj.table.num_rows
    removed = TC.collect_garbage(store)
    assert removed == [f"{adj.table.name}.g7.gar"]
    assert TC.collect_garbage(TS.GraphStore(str(tmp_path / "none"))) == []


# ------------------------- retry / backoff -------------------------------

def test_compactor_retries_follow_seeded_backoff_schedule():
    out = []
    for mod, bo in ((J, JBackoff), (T, Backoff)):
        D, C, _, F = PKG[mod]
        adj = _graph(mod)
        plan = F.FaultPlan({"compact.merge": 2})
        D.attach_delta(adj)
        D.ingest_edges(adj, [1], [2])
        slept = []
        runner = C.CompactionRunner(adj, faults=plan,
                                    backoff=bo(base=0.01, max_delay=0.25,
                                               seed=42),
                                    sleep=slept.append)
        assert runner.compact()
        ref = bo(base=0.01, max_delay=0.25, seed=42)
        assert slept == [ref.delay(0), ref.delay(1)]
        assert runner.faults_hit == 2 and runner.compactions == 1
        out.append((slept, runner.attempts))
    assert out[0] == out[1]


def test_compactor_gives_up_gracefully_and_resumes():
    out = []
    for mod in (J, T):
        D, C, _, F = PKG[mod]
        adj = _graph(mod)
        plan = F.FaultPlan({"compact.merge": 99})
        D.attach_delta(adj, faults=plan)
        rng = np.random.default_rng(1)
        D.ingest_edges(adj, rng.integers(0, N, 30), rng.integers(0, N, 30))
        oracle = _rebuilt(mod, adj)
        runner = C.CompactionRunner(adj, faults=plan, max_attempts=3,
                                    sleep=lambda _s: None)
        assert not runner.compact()              # exhausted, no exception
        assert runner.gave_up == 1
        d = D.live_delta(adj)
        assert d is not None and d.pending_rows() == 30
        vs = rng.integers(0, N, 20)              # delta path keeps serving
        np.testing.assert_array_equal(
            mod.neighbor_ids_batch(adj, vs, engine="numpy"),
            mod.neighbor_ids_batch(oracle, vs, engine="numpy"))
        runner.faults = F.FaultPlan({})          # faults cleared: resume
        assert runner.compact()
        assert D.live_delta(adj) is None
        out.append((runner.attempts, runner.faults_hit, runner.gave_up,
                    _layout(adj)))
    assert out[0] == out[1]


# --------------- the stale traversal plan (a deliberate difference) ------

def test_traversal_stats_equal_after_compaction_stale_plan_released():
    out = []
    for mod, engine, tops in ((J, "jax", JTO), (T, "torch", TTO)):
        adj = _graph(mod)
        seeds = np.arange(0, N, 37)
        runs = [mod.k_hop(adj, seeds, 2, engine=engine).tolist()]
        _ingest(mod, adj, 5, 80)
        runs.append(mod.k_hop(adj, seeds, 2, engine=engine).tolist())
        assert PKG[mod][1].CompactionRunner(adj).compact()
        runs.append(mod.k_hop(adj, seeds, 3, engine=engine).tolist())
        plans = adj._traversal_plans
        assert len(plans) == 2                   # the stale one is kept
        out.append((runs, tops.traversal_stats(adj)))
    assert out[0] == out[1]
    assert out[1][1]["fallbacks"] == 1 and out[1][1]["dispatches"] == 2
    col = adj.table[adj.value_col].encoded
    stale = [p for k, p in adj._traversal_plans.items()
             if k[0] != col.version]
    live = adj._traversal_plans[(col.version, 0)]
    assert len(stale) == 1
    assert not stale[0]._device                  # no tensors
    assert stale[0].host_vals.size == stale[0].key_sorted.size == \
        stale[0].voff.size == 0                  # no host arrays
    assert stale[0].dispatches == 1              # counters kept
    assert live._device and live.host_vals.size == adj.num_edges
