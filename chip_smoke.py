#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
  1. device: require a CUDA device; print the card's name and power limit;
  2. build: compile ``src/repro_torch/kernels/csrc/*.cu`` (timed);
  set-up: a soc-LiveJournal1-sized graph (4,847,571 vertices, ~69.0M
     edges) from ``powerlaw_graph`` and 8 ``clustered_labels``, ``by_src``
     adjacency at page size 2048;
  3. kernels: each of the four kernels against its plain PyTorch version
     on the card, at the shapes the main path gives it, bit for bit;
     timed against the plain version and against its bound;
  4. slice: ``retrieve_neighbors_batch(engine="cuda")`` over batches of
     8 / 16 / 1024 / 16384 vertices, unfiltered and filtered by
     ``(L0 & L1) | ~L2``, with no page cache and with a 4096-page LRU
     (cold, then warm); every run is held against the ``numpy`` engine
     (PAC, IOMeter and LRU counters equal) and every kernel must have
     launched;
  5. traversal: the ``TraversalPlan`` built on the card (timed), then
     ``k_hop(engine="cuda")`` from 1, 8 and 64 seeds at 2 and 3 hops,
     unfiltered, filtered and with the per-hop list ``[None, filt, ...]``:
     meterless runs timed (host ms, median of 3, one device round trip
     each), runs with a meter (no cache, then a 4096-page LRU cold and
     warm) held against the host-loop oracle; ``two_hop_pac`` from one
     seed against the staged numpy path, and ``frontier_edge_counts``
     over ``L0``'s intervals against a numpy bincount; the traversal
     kernels, ``gather_decode`` (the plan build) and ``cond_bitmap`` (the
     predicate plane) must have launched;
  6. traversal kernels: ``khop_scan``, ``two_hop`` and ``count_hop``
     against their plain versions on the card, bit for bit, at the
     traversal path's shapes and with padding keys, sentinel seeds and
     intervals, overlapping intervals and an end equal to ``n_key``; timed
     against the plain version and against the bound.
Every launch count is set to 0 just before phases 4 and 5 and read just
after; a kernel's ``launches`` is the sum over the two.
The card's name and power limit, then the kernel table as JSON, come on
the lines before the last; the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_VERTICES = 4_847_571          # SNAP soc-LiveJournal1
AVG_DEGREE = 14.23              # 68,993,773 edges / 4,847,571 vertices
PAGE_SIZE = 2048
LABELS = [f"L{i}" for i in range(8)]
BATCHES = (8, 16, 1024, 16384)
CACHE_PAGES = 4096
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
INT32_OPS_PER_S = 67e12         # H100 SXM 32-bit non-tensor peak
REPS = 3
SEED_COUNTS = (1, 8, 64)
#: kernels launched by the retrieval slice (phase 4) and by the traversal
#: path (phase 5: the plan build decodes through gather_decode, and each
#: filter's predicate plane comes from cond_bitmap)
RETRIEVAL_KERNELS = ("gather_decode", "fused_gather_decode_bitmap_batch",
                     "cond_bitmap", "fused_gather_decode_filter_bitmap_batch")
TRAVERSAL_KERNELS = ("gather_decode", "cond_bitmap", "khop_scan", "two_hop",
                     "count_hop")
#: where the kernel phase runs and which engine the slice drives
DEVICE = "cuda:0"
ENGINE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA
    events around the run, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def kernel_row(name, source, replaces, err, ms, plain_ms, nbytes, nops=0):
    """One entry of the ``kernels`` line; its launches are filled in from
    the slice phases."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def max_err(a, b):
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def build_graph():
    import numpy as np
    import repro_torch.core as TC
    from repro_torch.data.synthetic import clustered_labels, powerlaw_graph
    t0 = time.perf_counter()
    src, dst = powerlaw_graph(N_VERTICES, AVG_DEGREE, seed=0)
    adj = TC.build_adjacency(src, dst, N_VERTICES, N_VERTICES, TC.BY_SRC,
                             TC.ENC_GRAPHAR, page_size=PAGE_SIZE)
    labels = clustered_labels(N_VERTICES, LABELS, density=0.3,
                              run_scale=512, seed=0)
    vt = TC.VertexTable.build(TC.VertexTypeSchema("v", [], labels=LABELS),
                              {}, labels, num_vertices=N_VERTICES)
    col = adj.table["<dst>"].encoded
    TC.pack_column(col).unpack_plan()
    log(f"set-up: {N_VERTICES} vertices, {adj.num_edges} edges, "
        f"{len(col.pages)} pages of {PAGE_SIZE}, host build "
        f"{time.perf_counter() - t0:.1f} s")
    del src, dst
    rng = np.random.default_rng(1)
    batches = {b: rng.integers(0, N_VERTICES, b) for b in BATCHES}
    return adj, vt, batches


def staged_for(adj, vs, filt=None):
    """The staged vector and p_pad the fused path ships for batch ``vs``
    (the same steps as ``_retrieve_pac_batch_fused``, no cache)."""
    import numpy as np
    from repro_torch.core.encoding import prune_page_list
    from repro_torch.kernels.pac_decode import ops
    col = adj.table["<dst>"].encoded
    los, his = adj.edge_ranges_batch(vs)
    pages, _ = ops.page_set_for_ranges(los, his, col.page_size)
    qual = filt.qual_range() if filt is not None else None
    pages, pmask = prune_page_list(col, pages, qual)
    gidx, total = ops._gather_positions(pages, np.arange(len(pages)), los,
                                        his, col.page_size,
                                        pruned=pmask is not None)
    p_pad = ops._page_class(len(pages), len(col.pages))
    staged = np.zeros(p_pad + len(gidx) + 1, np.int32)
    staged[:len(pages)] = pages
    staged[p_pad:-1] = gidx
    staged[-1] = total
    return staged, p_pad, len(pages), total


def kernel_phase(torch, adj, vt, batches):
    import numpy as np
    from repro_torch.core.encoding import delta_encode_column, pack_column
    from repro_torch.core.labels import L, LabelFilter
    from repro_torch.kernels.label_filter import kernel as LK
    from repro_torch.kernels.label_filter import ref as LR
    from repro_torch.kernels.pac_decode import kernel as PK
    from repro_torch.kernels.pac_decode import ops
    from repro_torch.kernels.pac_decode import ref as PR
    dev = torch.device(DEVICE)
    col = adj.table["<dst>"].encoded
    plan = col.packed_cache.device_plan(dev)
    n_pages, d = plan[1].shape
    max_words = plan[3].shape[1]
    ps = d + 1
    row_bytes = 4 * (1 + 2 * d + max_words)
    n_words = -(-adj.num_value_vertices // 32)
    rows = []

    def entry(*args, **kwargs):
        rows.append(kernel_row(*args, **kwargs))

    # -- gather_decode: the non-fused path's page list for batch 8, plus
    #    a 16384-vertex page list and out-of-range padding (clamped)
    los, his = adj.edge_ranges_batch(batches[BATCHES[0]])
    pages8, _ = ops.page_set_for_ranges(los, his, PAGE_SIZE)
    idx8 = torch.from_numpy(ops._page_index_vector(pages8, n_pages)).to(dev)
    staged_big, p_big, n_big, _ = staged_for(adj, batches[BATCHES[-1]])
    idx_big = torch.from_numpy(staged_big[:p_big].copy())
    idx_big[n_big:] = torch.tensor([-7, n_pages + 5] * p_big)[
        :p_big - n_big].to(torch.int32)
    idx_big = idx_big.to(dev)
    for idx in (idx8, idx_big):
        k, r = PK.gather_decode(*plan, idx), PR.gather_decode(*plan, idx)
        require(torch.equal(k, r), f"gather_decode differs at {len(idx)} "
                f"rows ({max_err(k, r)})")
    err = max_err(PK.gather_decode(*plan, idx8), PR.gather_decode(*plan, idx8))
    uniq = len(np.unique(np.clip(idx8.cpu().numpy(), 0, n_pages - 1)))
    entry("gather_decode", "src/repro_torch/kernels/csrc/gather_decode.cu",
          "src/repro/kernels/pac_decode/kernel.py:453", err,
          cuda_ms(torch, lambda: PK.gather_decode(*plan, idx8), 50),
          cuda_ms(torch, lambda: PR.gather_decode(*plan, idx8), 10),
          uniq * row_bytes + 4 * len(idx8) + 4 * len(idx8) * ps)
    # other page sizes: one pass of the block scan (256) and several (8192)
    rng = np.random.default_rng(2)
    for page_size in (256, 8192):
        vals = np.concatenate(
            [np.sort(rng.integers(0, 1 << 24, 5 * page_size)),
             rng.integers(-(1 << 30), 1 << 30, 77)])
        other = pack_column(delta_encode_column(vals, page_size))
        oplan = other.device_plan(dev)
        oidx = torch.arange(-1, other.n_pages + 1, dtype=torch.int32,
                            device=dev)
        k, r = PK.gather_decode(*oplan, oidx), PR.gather_decode(*oplan, oidx)
        require(torch.equal(k, r), f"gather_decode differs at page size "
                f"{page_size} ({max_err(k, r)})")
    log(f"kernels: gather_decode equal at {len(idx8)} and {len(idx_big)} "
        f"rows, and at page sizes 256 and 8192")

    # -- fused: batch 16384, unfiltered and filtered, want_ids both ways
    filt = LabelFilter(vt, (L("L0") & L("L1")) | ~L("L2"))
    fplan = filt.plan()
    pos_t, meta_t = fplan.device(dev)
    fw = LK.cond_bitmap(pos_t, meta_t, fplan.program.ops, n_words)
    fr = LR.cond_bitmap(pos_t, meta_t, fplan.program.ops, n_words)
    require(torch.equal(fw, fr), f"cond_bitmap differs ({max_err(fw, fr)})")
    n_ops = len(fplan.program.ops)
    k_leaves = sum(1 for op in fplan.program.ops if op[0] == "leaf")
    steps = int(np.ceil(np.log2(fplan.pos.shape[1] + 1)))
    entry("cond_bitmap", "src/repro_torch/kernels/csrc/cond_bitmap.cu",
          "src/repro/kernels/label_filter/kernel.py:88", max_err(fw, fr),
          cuda_ms(torch, lambda: LK.cond_bitmap(
              pos_t, meta_t, fplan.program.ops, n_words), 20),
          cuda_ms(torch, lambda: LR.cond_bitmap(
              pos_t, meta_t, fplan.program.ops, n_words), 3),
          fplan.pos.nbytes + fplan.meta.nbytes + 4 * n_ops + 4 * n_words,
          32 * n_words * (k_leaves * steps + n_ops))
    log(f"kernels: cond_bitmap equal over {n_words} words")

    for name, fwords in (("fused_gather_decode_bitmap_batch", None),
                         ("fused_gather_decode_filter_bitmap_batch", fw)):
        staged, p_pad, n_real, total = staged_for(
            adj, batches[BATCHES[-1]], filt if fwords is not None else None)
        st = torch.from_numpy(staged).to(dev)
        buf = torch.empty(n_words, dtype=torch.int32, device=dev)

        def kern(want_ids, st=st, p_pad=p_pad, buf=buf, fwords=fwords):
            if fwords is None:
                return PK.fused_gather_decode_bitmap_batch(
                    *plan, st, buf, p_pad=p_pad, want_ids=want_ids)
            return LK.fused_gather_decode_filter_bitmap_batch(
                *plan, st, fwords, buf, p_pad=p_pad, want_ids=want_ids)

        def plain(st=st, p_pad=p_pad, fwords=fwords):
            return PR.fused_gather_batch(*plan, st, n_words, p_pad, fwords)

        rw, rids = plain()
        kw, kids = kern(True)
        require(torch.equal(kw, rw) and torch.equal(kids, rids),
                f"{name} (want_ids) differs")
        kw = kern(False)
        require(torch.equal(kw, rw), f"{name} differs")
        # rows past `total` must be ignored whatever they point at
        junk = st.clone()
        tail = junk[p_pad + total:-1]
        tail.copy_(torch.randint(0, p_pad * ps, tail.shape,
                                 dtype=torch.int32, device=dev))
        kj = kern(False, st=junk)
        require(torch.equal(kj, rw), f"{name} reads rows past total")
        ids_req = rids.reshape(-1)[st[p_pad:p_pad + total].long()]
        dups = total - int(torch.unique(ids_req).numel())
        require(dups > 0 and len(staged) - p_pad - 1 > total
                and p_pad > n_real,
                f"{name}: the case lacks duplicates or padding")
        nbytes = (n_real * row_bytes + 4 * len(staged) + 4 * n_words
                  + (4 * n_words if fwords is not None else 0))
        entry(name, "src/repro_torch/kernels/csrc/bitmap_scatter.cu",
              "src/repro/kernels/pac_decode/kernel.py:540"
              if fwords is None else
              "src/repro/kernels/label_filter/kernel.py:231",
              max_err(kw, rw), cuda_ms(torch, lambda: kern(False), 20),
              cuda_ms(torch, plain, 3), nbytes)
        log(f"kernels: {name} equal (want_ids both ways) at p_pad={p_pad}, "
            f"{n_real} pages, {total} rows, {dups} duplicate ids, "
            f"{len(staged) - p_pad - 1 - total} padding rows")
    return rows


def pac_key(pac):
    return [(p, pac.bitmaps[p].tobytes()) for p in sorted(pac.bitmaps)]


def slice_phase(torch, adj, vt, batches, card):
    import repro_torch.core as TC
    from repro_torch.core.page_cache import DecodedPageCache
    enc = adj.table["<dst>"].encoded
    cond = (TC.L("L0") & TC.L("L1")) | ~TC.L("L2")
    filt = TC.LabelFilter(vt, cond)
    results = []
    log(f"slice: host ms per batch on {card}, each run equal to numpy")

    def run(engine, vs, f, cache):
        enc.page_cache = cache
        meter = TC.IOMeter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pac = TC.retrieve_neighbors_batch(adj, vs, PAGE_SIZE, meter,
                                          engine=engine, filter=f)
        torch.cuda.synchronize()
        return pac, meter, (time.perf_counter() - t0) * 1e3

    for b in BATCHES:
        vs = batches[b]
        for f in (None, filt):
            # one untimed call per shape: plan upload, predicate plane
            run(ENGINE, vs, f, None)
            caches = {ENGINE: DecodedPageCache(CACHE_PAGES),
                      "numpy": DecodedPageCache(CACHE_PAGES)}
            for mode in ("none", "cold", "warm"):
                times = []
                for rep in range(REPS if mode != "cold" else 1):
                    outs = {}
                    for engine in (ENGINE, "numpy"):
                        cache = None if mode == "none" else caches[engine]
                        pac, meter, ms = run(engine, vs, f, cache)
                        outs[engine] = (pac_key(pac), meter.nbytes,
                                        meter.nrequests,
                                        None if cache is None else
                                        (cache.hits, cache.misses,
                                         cache.evictions))
                        if engine == ENGINE:
                            times.append(ms)
                    require(outs[ENGINE] == outs["numpy"],
                            f"batch {b} filter={f is not None} {mode}: "
                            f"cuda differs from the numpy oracle")
                res = {"batch": b, "filtered": f is not None, "cache": mode,
                       "median_ms": statistics.median(times), "runs": times,
                       "pages": len(outs[ENGINE][0]),
                       "io_bytes": outs[ENGINE][1],
                       "io_requests": outs[ENGINE][2],
                       "lru": outs[ENGINE][3]}
                results.append(res)
                log(f"slice: batch {b:5d} filtered={f is not None!s:5} "
                    f"cache={mode:4s} median {res['median_ms']:.3f} ms "
                    f"({len(times)} runs), {res['pages']} PAC pages, "
                    f"io {res['io_bytes']} B / {res['io_requests']} req, "
                    f"lru {res['lru']}")
    enc.page_cache = None
    return results


def traversal_slice_phase(torch, adj, vt, card):
    """The traversal entry points on the card: ``k_hop`` (timed meterless,
    held against the host-loop oracle with a meter, with no cache and a
    cold then warm LRU), ``two_hop_pac`` against the staged numpy path
    and ``frontier_edge_counts`` against a numpy bincount."""
    import numpy as np
    import repro_torch.core as TC
    from repro_torch.core.page_cache import DecodedPageCache
    from repro_torch.kernels.traversal import ops as TO
    enc = adj.table["<dst>"].encoded
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    plan = TO.traversal_plan(adj, ENGINE)
    plan.device(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"traversal: plan built and uploaded in {build_s:.1f} s "
        f"({plan.rows} rows, {len(plan.key_sorted)} padded, "
        f"{plan.n_value} segments)")
    # a fresh filter: its predicate plane is built on this path
    filt = TC.LabelFilter(vt, (TC.L("L0") & TC.L("L1")) | ~TC.L("L2"))
    rng = np.random.default_rng(3)
    seeds_of = {s: rng.integers(0, N_VERTICES, s) for s in SEED_COUNTS}
    results = {"plan_build_s": build_s, "k_hop": []}
    log(f"traversal: k_hop host ms on {card}, each metered run equal to "
        f"the host-loop oracle")
    for n_seeds, seeds in seeds_of.items():
        for hops in (2, 3):
            for kind in ("none", "filter", "per_hop"):
                f = {"none": None, "filter": filt,
                     "per_hop": [None] + [filt] * (hops - 1)}[kind]
                ids = TC.k_hop(adj, seeds, hops, engine=ENGINE, filter=f)
                times = []
                for _ in range(REPS):
                    r0 = plan.device_roundtrips
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    TC.k_hop(adj, seeds, hops, engine=ENGINE, filter=f)
                    times.append((time.perf_counter() - t0) * 1e3)
                    require(plan.device_roundtrips == r0 + 1,
                            "a meterless k_hop made more than one round "
                            "trip")
                sizes = plan.last_frontier_sizes.tolist()
                caches = {ENGINE: DecodedPageCache(CACHE_PAGES),
                          "numpy": DecodedPageCache(CACHE_PAGES)}
                io = {}
                for mode in ("none", "cold", "warm"):
                    outs = {}
                    for engine, fused in ((ENGINE, None), ("numpy", False)):
                        cache = None if mode == "none" else caches[engine]
                        enc.page_cache = cache
                        meter = TC.IOMeter()
                        got = TC.k_hop(adj, seeds, hops, meter,
                                       engine=engine, filter=f, fused=fused)
                        outs[engine] = (got.tobytes(), meter.nbytes,
                                        meter.nrequests,
                                        None if cache is None else
                                        (cache.hits, cache.misses,
                                         cache.evictions))
                    enc.page_cache = None
                    require(outs[ENGINE] == outs["numpy"]
                            and outs[ENGINE][0] == ids.tobytes(),
                            f"k_hop seeds={n_seeds} hops={hops} {kind} "
                            f"{mode}: cuda differs from the oracle")
                    io[mode] = outs[ENGINE][1:]
                res = {"seeds": n_seeds, "hops": hops, "filter": kind,
                       "median_ms": statistics.median(times), "runs": times,
                       "ids": len(ids), "frontier_sizes": sizes, "io": io}
                results["k_hop"].append(res)
                log(f"traversal: k_hop seeds {n_seeds:2d} hops {hops} "
                    f"{kind:7s} median {res['median_ms']:.3f} ms, "
                    f"{len(ids)} ids, sizes {sizes}, io/lru {io}")

    f = [None, filt, filt]
    wall, busy = profile_ms(torch, lambda: TC.k_hop(
        adj, seeds_of[64], 3, engine=ENGINE, filter=f))
    results["k_hop_profile"] = {"wall_ms": wall, "device_ms": busy}
    log(f"traversal: k_hop profile (64 seeds, 3 hops, per-hop filter): "
        f"{wall:.3f} ms per call under the profiler, device busy "
        + (f"{sum(busy.values()):.3f} ms (idle share "
           f"{1 - sum(busy.values()) / wall:.3f}): " + ", ".join(
               f"{k[:40]} {v:.3f}" for k, v in sorted(
                   busy.items(), key=lambda kv: -kv[1]))
           if busy else "not measured (the profiler saw no device time)"))

    seed = int(seeds_of[1][0])
    m_k, m_o = TC.IOMeter(), TC.IOMeter()
    pac = TO.two_hop_pac(adj, adj, [seed], PAGE_SIZE, filt, m_k, ENGINE)
    created = TC.neighbor_ids_batch(adj, [seed], m_o, engine="numpy")
    want = TC.retrieve_neighbors_batch(adj, created, PAGE_SIZE, m_o,
                                       "numpy", filter=filt)
    require(pac_key(pac) == pac_key(want) and pac.count() > 0
            and (m_k.nbytes, m_k.nrequests) == (m_o.nbytes, m_o.nrequests),
            "two_hop_pac differs from the staged numpy path")
    times = [host_ms(torch, lambda: TO.two_hop_pac(
        adj, adj, [seed], PAGE_SIZE, filt, engine=ENGINE))
        for _ in range(REPS)]
    results["two_hop_pac"] = {"median_ms": statistics.median(times),
                              "runs": times, "ids": pac.count()}
    log(f"traversal: two_hop_pac from vertex {seed}: {pac.count()} ids, "
        f"median {statistics.median(times):.3f} ms, equal to the staged "
        f"numpy path (PAC, io {m_k.nbytes} B / {m_k.nrequests} req)")

    starts, ends = TC.LabelFilter(vt, TC.L("L0")).intervals("numpy")
    off = np.asarray(adj.offsets["<offset>"].values, np.int64)
    los, his = off[starts], off[ends]
    m_k, m_o = TC.IOMeter(), TC.IOMeter()
    counts = TO.frontier_edge_counts(adj, starts, ends, los, his, m_k,
                                     ENGINE)
    rows = TC.decode_edge_ranges(adj, los, his, m_o, "numpy")
    require(np.array_equal(counts, np.bincount(rows, minlength=N_VERTICES))
            and (m_k.nbytes, m_k.nrequests) == (m_o.nbytes, m_o.nrequests),
            "frontier_edge_counts differs from the numpy bincount")
    times = [host_ms(torch, lambda: TO.frontier_edge_counts(
        adj, starts, ends, los, his, engine=ENGINE)) for _ in range(REPS)]
    results["frontier_edge_counts"] = {
        "median_ms": statistics.median(times), "runs": times,
        "intervals": len(starts), "edges": int(counts.sum())}
    log(f"traversal: frontier_edge_counts over L0's {len(starts)} "
        f"intervals: {int(counts.sum())} edges, median "
        f"{statistics.median(times):.3f} ms, equal to the numpy bincount "
        f"(io {m_k.nbytes} B / {m_k.nrequests} req)")
    results["inputs"] = {"plan": plan, "filt": filt, "seeds": seeds_of,
                         "intervals": (starts, ends)}
    return results


def profile_ms(torch, fn, reps: int = 5):
    """``torch.profiler`` over ``reps`` calls of ``fn``: host wall ms per
    call, and device ms per call by kernel or copy name (empty when the
    profiler sees no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    busy = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.name] = (busy.get(e.name, 0.0)
                            + e.time_range.elapsed_us() / 1e3 / reps)
    return wall, busy


def host_ms(torch, fn) -> float:
    """Host wall milliseconds of one call, synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def needed_rows(torch, ks, voff, frontier, active):
    """Row mask of the ``key_sorted`` rows an expansion of ``frontier``
    must read for the value ids marked ``active``: each segment up to its
    first selected row, or whole where none is selected (the early exit
    of kernels 5 and 6)."""
    n = voff.numel() - 1
    nk = frontier.numel()
    rows = int(voff[-1])
    ksl = ks[:rows].long()
    sel = (ksl < nk) & (frontier[ksl.clamp(max=nk - 1)] != 0)
    lens = (voff[1:] - voff[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(n, device=ks.device), lens)
    r = torch.arange(rows, device=ks.device)
    first = torch.full((n,), rows, dtype=torch.int64, device=ks.device)
    first = first.scatter_reduce(0, seg[sel], r[sel], "amin")
    return active[seg] & (r <= first[seg])


def traversal_kernel_phase(torch, inputs):
    """Kernels 5-7 against their plain versions on the card, bit for bit,
    at the shapes the traversal slice gives them (and with padding keys,
    sentinel seeds and intervals, overlapping intervals and an end equal
    to ``n_key``), each timed beside its bound."""
    import numpy as np
    from repro_torch.kernels._pad import size_class
    from repro_torch.kernels.traversal import kernel as TK
    from repro_torch.kernels.traversal import ops as TO
    from repro_torch.kernels.traversal import ref as TR
    dev = torch.device(DEVICE)
    plan, filt = inputs["plan"], inputs["filt"]
    ks, voff = plan.device(dev)
    n = plan.n_value
    n_words = -(-n // 32)
    rng = np.random.default_rng(4)
    hit = torch.from_numpy(rng.choice(plan.rows, 4096, replace=False)) \
        .to(dev)
    ks_pad = ks.clone()
    ks_pad[hit] = plan.n_key
    fwords = filt.plan().device_bitmap(dev, n_words)
    ones = torch.full((n_words,), -1, dtype=torch.int32, device=dev)
    rows = []

    def to_dev(a):
        return torch.from_numpy(a).to(dev)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def bits_of(words, count):
        return TR._filter_bits(words, count).bool()

    # -- 5: khop_scan at the 64-seed, 3-hop, per-hop-filter shape, and with
    #    padding keys, duplicate and sentinel seeds
    sv = to_dev(TO._seed_vector(np.unique(inputs["seeds"][64]), n))
    sv_junk = sv.clone()
    sv_junk[40:] = n
    sv_junk[30:40] = sv[:10]
    fw3 = torch.stack([ones, fwords, fwords])
    want = TR.khop_scan(ks, voff, sv, fw3, n)
    got = TK.khop_scan(ks, voff, sv, fw3, n)
    require(equal(got, want), "khop_scan differs")
    err = max(max_err(a, b) for a, b in zip(got, want))
    for k, s_ in ((ks_pad, sv), (ks, sv_junk), (ks_pad, sv_junk)):
        require(equal(TK.khop_scan(k, voff, s_, fw3, n),
                      TR.khop_scan(k, voff, s_, fw3, n)),
                "khop_scan differs with padding keys or sentinel seeds")
    visited, planes, _ = want
    frontier = TR._seed_plane(sv, n)
    seen = frontier.clone()
    need = torch.zeros(int(voff[-1]), dtype=torch.bool, device=dev)
    for h in range(fw3.shape[0]):
        active = (seen == 0) & bits_of(fw3[h], n)
        need |= needed_rows(torch, ks, voff, frontier, active)
        frontier = planes[h]
        seen = seen + frontier
    nbytes = 4 * (int(need.sum()) + (n + 1) + sv.numel() + fw3.numel()
                  + n + planes.numel() + fw3.shape[0])
    rows.append(kernel_row(
        "khop_scan", "src/repro_torch/kernels/csrc/traversal.cu",
        "src/repro/kernels/traversal/kernel.py:42", err,
        cuda_ms(torch, lambda: TK.khop_scan(ks, voff, sv, fw3, n), 10),
        cuda_ms(torch, lambda: TR.khop_scan(ks, voff, sv, fw3, n), 2),
        nbytes))
    log(f"kernels: khop_scan equal at 3 hops, {plan.rows} rows, "
        f"{int(sv.lt(n).sum())} seeds (and with {len(hit)} padding keys, "
        f"duplicate and sentinel seeds); sizes {want[2].tolist()}, "
        f"{int(need.sum())} rows needed")

    # -- 6: two_hop at the one-seed IC-8 shape (63 sentinel seeds)
    sv1 = to_dev(TO._seed_vector(inputs["seeds"][1][:1], n))
    kw = dict(n_key=n, n_mid=n, n_out=n, n_words=n_words)
    want = TR.two_hop(ks, voff, ks, voff, sv1, fwords, **kw)
    got = TK.two_hop(ks, voff, ks, voff, sv1, fwords, **kw)
    require(equal(got, want), "two_hop differs")
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(equal(TK.two_hop(ks_pad, voff, ks_pad, voff, sv_junk, fwords,
                             **kw),
                  TR.two_hop(ks_pad, voff, ks_pad, voff, sv_junk, fwords,
                             **kw)),
            "two_hop differs with padding keys or sentinel seeds")
    all_v = torch.ones(n, dtype=torch.bool, device=dev)
    need_a = needed_rows(torch, ks, voff, TR._seed_plane(sv1, n), all_v)
    need_b = needed_rows(torch, ks, voff, want[0], all_v)
    nbytes = 4 * (int(need_a.sum()) + int(need_b.sum()) + 2 * (n + 1)
                  + sv1.numel() + 2 * n_words + n)
    rows.append(kernel_row(
        "two_hop", "src/repro_torch/kernels/csrc/traversal.cu",
        "src/repro/kernels/traversal/kernel.py:74", err,
        cuda_ms(torch, lambda: TK.two_hop(ks, voff, ks, voff, sv1, fwords,
                                          **kw), 10),
        cuda_ms(torch, lambda: TR.two_hop(ks, voff, ks, voff, sv1, fwords,
                                          **kw), 2),
        nbytes))
    log(f"kernels: two_hop equal from 1 seed ({int(want[0].sum())} mid "
        f"ids; and with padding keys, sentinel seeds)")

    # -- 7: count_hop over L0's intervals padded with the sentinel, and
    #    with overlapping intervals and an end equal to n_key
    starts, ends = inputs["intervals"]

    def bounds(st, en):
        i_pad = size_class(len(st), TO.INTERVAL_CLASS_MIN)
        s_ = np.full(i_pad, plan.n_key + 1, np.int32)
        e_ = np.full(i_pad, plan.n_key + 1, np.int32)
        s_[:len(st)] = st
        e_[:len(en)] = en
        return to_dev(s_), to_dev(e_)

    s_, e_ = bounds(starts, ends)
    kw = dict(n_key=plan.n_key, n_out=n)
    want = TR.count_hop(ks, voff, s_, e_, **kw)
    got = TK.count_hop(ks, voff, s_, e_, **kw)
    require(torch.equal(got, want), "count_hop differs")
    err = max_err(got, want)
    s2, e2 = bounds(np.r_[starts, starts[:3], n - 1000],
                    np.r_[ends, ends[:3] + 5000, n])
    require(torch.equal(TK.count_hop(ks_pad, voff, s2, e2, **kw),
                        TR.count_hop(ks_pad, voff, s2, e2, **kw)),
            "count_hop differs with overlapping intervals or end == n_key")
    nbytes = 4 * (int(voff[-1]) + (n + 1) + s_.numel() + e_.numel() + n)
    rows.append(kernel_row(
        "count_hop", "src/repro_torch/kernels/csrc/traversal.cu",
        "src/repro/kernels/traversal/kernel.py:113", err,
        cuda_ms(torch, lambda: TK.count_hop(ks, voff, s_, e_, **kw), 10),
        cuda_ms(torch, lambda: TR.count_hop(ks, voff, s_, e_, **kw), 2),
        nbytes))
    log(f"kernels: count_hop equal over {len(starts)} intervals "
        f"(i_pad {s_.numel()}; and overlapping, end == n_key), "
        f"{int(want.sum())} edges")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"1. device: {torch.cuda.get_device_name(0)} ({card}), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.label_filter import kernel as LK
    from repro_torch.kernels.pac_decode import kernel as PK
    from repro_torch.kernels.traversal import kernel as TK
    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.library()
    log(f"2. build: {time.perf_counter() - t0:.1f} s ({lib.name})")
    report = lib.with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"   ptxas: {line.strip()}")

    adj, vt, batches = build_graph()
    t0 = time.perf_counter()
    rows = kernel_phase(torch, adj, vt, batches)
    log(f"3. kernels: the four retrieval kernels equal to their plain "
        f"versions ({time.perf_counter() - t0:.1f} s)")

    wrappers = {"gather_decode": PK.gather_decode,
                "fused_gather_decode_bitmap_batch":
                    PK.fused_gather_decode_bitmap_batch,
                "cond_bitmap": LK.cond_bitmap,
                "fused_gather_decode_filter_bitmap_batch":
                    LK.fused_gather_decode_filter_bitmap_batch,
                "khop_scan": TK.khop_scan, "two_hop": TK.two_hop,
                "count_hop": TK.count_hop}

    def drive(phase, *args):
        """Run one slice phase with every launch count set to 0 just
        before it; returns its result and the counts read just after."""
        for w in wrappers.values():
            w.launches = 0
        out = phase(*args)
        return out, {n: w.launches for n, w in wrappers.items()}

    t0 = time.perf_counter()
    results, launches = drive(slice_phase, torch, adj, vt, batches, card)
    require(all(launches[n] for n in RETRIEVAL_KERNELS),
            f"a retrieval kernel never launched: {launches}")
    log(f"4. slice: {len(results)} configurations equal to the numpy "
        f"oracle, launches {launches} ({time.perf_counter() - t0:.1f} s) "
        f"on {card}")

    t0 = time.perf_counter()
    trav, t_launches = drive(traversal_slice_phase, torch, adj, vt, card)
    require(all(t_launches[n] for n in TRAVERSAL_KERNELS),
            f"a traversal-path kernel never launched: {t_launches}")
    log(f"5. traversal: {len(trav['k_hop'])} k_hop configurations, "
        f"two_hop_pac and frontier_edge_counts equal to their oracles, "
        f"launches {t_launches} ({time.perf_counter() - t0:.1f} s) "
        f"on {card}")

    t0 = time.perf_counter()
    rows += traversal_kernel_phase(torch, trav["inputs"])
    log(f"6. traversal kernels: all three equal to their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    for r in rows:
        r["launches"] = launches[r["name"]] + t_launches[r["name"]]

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
