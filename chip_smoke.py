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
     launched.
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

    def entry(name, source, replaces, err, ms, plain_ms, nbytes, nops=0):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / INT32_OPS_PER_S * 1e3
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "library_ms": None})

    def max_err(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

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
    log(f"3. kernels: all four equal to their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")

    wrappers = {"gather_decode": PK.gather_decode,
                "fused_gather_decode_bitmap_batch":
                    PK.fused_gather_decode_bitmap_batch,
                "cond_bitmap": LK.cond_bitmap,
                "fused_gather_decode_filter_bitmap_batch":
                    LK.fused_gather_decode_filter_bitmap_batch}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    results = slice_phase(torch, adj, vt, batches, card)
    launches = {n: w.launches for n, w in wrappers.items()}
    for r in rows:
        r["launches"] = launches[r["name"]]
    require(all(launches.values()), f"a kernel never launched: {launches}")
    log(f"4. slice: {len(results)} configurations equal to the numpy "
        f"oracle, launches {launches} ({time.perf_counter() - t0:.1f} s) "
        f"on {card}")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
