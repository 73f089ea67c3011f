#!/usr/bin/env python3
"""Time the forms of kernel 13 and the block sizes of kernel 14 side by
side on one card.

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 tools/rle_select_forms.py [--parent DIR] [--forms A,C/128,...]
    python3 tools/rle_select_forms.py --stamps

Builds ``tools/rle_select_forms.cu`` (kernel 13's forms A, B, B2, C1,
D, C and Cp and their variants, and kernel 14 at several block sizes; see
its header)
and, with ``--parent``, the ``rle_filter.cu`` and ``bitmap_select.cu`` of
the checkout in DIR, each with ``nvcc`` into a library of its own under
``build/forms/``.  It holds every variant bit for bit against the plain
versions (``rle_filter/ref.py``, ``bitmap_select/ref.py``) on the edge
cases of ``tests/_torch_cases.py`` (``rle_case`` with ``want`` 0 and 1,
``select_case`` with the values aligned and 4 bytes past a 16-byte
boundary), then at ``chip_smoke.py``'s shapes: kernel 13 over the
scattered column (4,847,571 rows) and the clustered label ``L0``, kernel
14 over the soc-LiveJournal1 batch-16384 PAC's 2,367 pages of 2048 with
the seeded ``age`` values.  Each variant's time a call (CUDA events around
20 back-to-back calls) and its device time queued behind the host are
timed in the order of the list and then in reverse, beside the port's own
kernels, the parent's and, for kernel 14, ``torch.masked_select`` with the
mask precomputed and ``torch.zeros`` of the output's shape (a fill of the
bytes the kernel must write).  The card's name and power limit come first,
the launch floor and each shape's bound after the build.  ``--stamps``
instead runs forms B, C1, D and C, a kernel that only reads the
positions and C with plain stores in place of its atomics, with each
block's timing stamps on kernel 13's two columns.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as CS  # noqa: E402

OUT = ROOT / "build" / "forms"
CSRC = "src/repro_torch/kernels/csrc"
#: kernel 13's variants: name -> (form, threads a block)
RLE_VARIANTS = {"A": (0, 256), "B": (1, 256),
                **{f"C1/{t}": (2, t) for t in (64, 128, 256)},
                "C1~/128": (3, 128), "C1~/256": (3, 256),
                "C1'/64": (6, 64), "C1'/128": (6, 128),
                **{f"B2/{t}": (4, t) for t in (128, 256)},
                **{f"B2~/{t}": (5, t) for t in (128, 256)},
                **{f"D/{t}": (8, t) for t in (64, 128, 256)},
                **{f"C/{t}": (9, t) for t in (64, 128, 256)},
                **{f"Cp/{t}": (11, t) for t in (128, 256)}}
#: kernel 14's variants: name -> (threads a block, 4-lane groups a thread)
SELECT_VARIANTS = {f"S/{t}x{q}": (t, q) for t, q in (
    (32, 4), (64, 1), (64, 2), (64, 4), (128, 2), (128, 4), (256, 1))}
P = ctypes.c_void_p
I = ctypes.c_int


def build(srcs, include: Path, name: str):
    """Start ``nvcc`` on the sources; returns the process and the
    library."""
    lib = OUT / f"lib{name}.so"
    from repro_torch.kernels import _build
    cmd = [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas=-v", "-I", str(include), *map(str, srcs), "-o", str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout whose rle_filter.cu and "
                    "bitmap_select.cu are timed beside the forms")
    ap.add_argument("--stamps", action="store_true",
                    help="only time the phases of forms B and C inside each "
                    "block (kernel 13's columns, no graph)")
    ap.add_argument("--forms", default=",".join([*RLE_VARIANTS,
                                                 *SELECT_VARIANTS]),
                    help="the variants to time, comma-separated (default: "
                    "all)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("rle_select_forms: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    import repro_torch.core as TC
    from _torch_cases import RLE_CASES, SELECT_CASES, rle_case, select_case
    from repro_torch.data.synthetic import clustered_labels, scattered_labels
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitmap_select import kernel as BK
    from repro_torch.kernels.bitmap_select import ops as BO
    from repro_torch.kernels.bitmap_select import ref as BR
    from repro_torch.kernels.rle_filter import kernel as FK
    from repro_torch.kernels.rle_filter import ops as FO
    from repro_torch.kernels.rle_filter import ref as FR
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = [build([ROOT / "tools/rle_select_forms.cu"], ROOT / CSRC,
                  "rle_select_forms")]
    if args.parent:
        pc = Path(args.parent).resolve() / CSRC
        jobs.append(build([pc / "rle_filter.cu", pc / "bitmap_select.cu"],
                          pc, "rle_select_parent"))
    _build.library()
    for proc, lib in jobs:
        text, _ = proc.communicate()
        for line in text.splitlines():
            if any(w in line for w in ("error", "registers", "spill",
                                       "Compiling entry")):
                print(f"   nvcc {lib.name}: {line.strip()}")
        if proc.returncode:
            print(text)
            raise SystemExit(f"FAILED: nvcc on {lib.name}")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    forms = ctypes.CDLL(str(jobs[0][1]))
    forms.forms_rle_to_bitmap.argtypes = [I, I, P, I, P, P, I, P]
    forms.forms_bitmap_select.argtypes = [I, I, P, P, I, I, P, P, P]
    forms.forms_rle_stamped.argtypes = [I, P, I, P, P, I, P, P]
    parent = ctypes.CDLL(str(jobs[1][1])) if args.parent else None
    if parent:
        parent.rt_rle_to_bitmap.argtypes = [P, I, P, P, I, P]
        parent.rt_bitmap_select.argtypes = [P, P, I, I, P, P, P]
    dev = torch.device("cuda:0")
    one, each = CS.launch_floor_ms(torch, dev)
    print(f"launch floor: {one:.4f} ms from launch to completion, "
          f"{each:.4f} ms each queued back to back", flush=True)

    def stream():
        return P(torch.cuda.current_stream(dev).cuda_stream)

    def call(rc):
        if rc:
            raise RuntimeError(f"CUDA error {rc}")

    def ptr(t):
        return P(t.data_ptr())

    def rle_fn(v, pos_t, meta_t, nw):
        def run():
            if v == "port":
                return FK.rle_to_bitmap(pos_t, meta_t, nw)
            words = torch.empty(nw, dtype=torch.int32, device=dev)
            fn, lead = (parent.rt_rle_to_bitmap, ()) if v == "parent" else \
                (forms.forms_rle_to_bitmap, RLE_VARIANTS[v])
            call(fn(*lead, ptr(pos_t), pos_t.shape[1], ptr(meta_t),
                    ptr(words), nw, stream()))
            return words
        return run

    def select_fn(v, vals_t, words_t, ps):
        def run():
            if v == "port":
                return BK.bitmap_select(vals_t, words_t, ps)
            n = vals_t.shape[0]
            out = torch.empty((n, ps), dtype=torch.int32, device=dev)
            counts = torch.empty((n, 1), dtype=torch.int32, device=dev)
            fn, lead = (parent.rt_bitmap_select, ()) if v == "parent" else \
                (forms.forms_bitmap_select, SELECT_VARIANTS[v])
            call(fn(*lead, ptr(vals_t), ptr(words_t), n, ps, ptr(out),
                    ptr(counts), stream()))
            return out.view(torch.float32), counts
        return run

    picked = args.forms.split(",")
    extra = ["port"] + (["parent"] if parent else [])
    rle_all = [v for v in picked if v in RLE_VARIANTS] + extra
    select_all = [v for v in picked if v in SELECT_VARIANTS] + extra

    def same_select(a, b):
        return torch.equal(a[1], b[1]) and torch.equal(
            a[0].view(torch.int32), b[0].view(torch.int32))

    # -- the edge cases, each variant against the plain version
    for case in RLE_CASES:
        for want_value in (0, 1):
            pos, meta, nw = rle_case(case, want_value)
            pos_t = torch.from_numpy(pos).to(dev)
            meta_t = torch.from_numpy(meta).to(dev)
            want = FR.rle_to_bitmap(pos_t, meta_t, nw)
            for v in rle_all:
                CS.require(torch.equal(rle_fn(v, pos_t, meta_t, nw)(), want),
                           f"kernel 13 {v} differs on {case}, want "
                           f"{want_value}")
    for kind, ps in SELECT_CASES:
        vals, words = select_case(kind, ps)
        words_t = torch.from_numpy(words.view(np.int32)).to(dev)
        flat = torch.zeros(vals.size + 1, dtype=torch.float32, device=dev)
        for vals_t in (flat[:vals.size], flat[1:]):
            vals_t.copy_(torch.from_numpy(vals.reshape(-1)))
            vals_t = vals_t.view(vals.shape)
            want = BR.bitmap_select(vals_t, words_t, ps)
            for v in select_all:
                CS.require(same_select(select_fn(v, vals_t, words_t, ps)(),
                                       want),
                           f"kernel 14 {v} differs on {kind} {ps} at byte "
                           f"offset {vals_t.data_ptr() % 16}")
    torch.cuda.synchronize()
    print("edge cases: every variant equal to the plain versions",
          flush=True)

    # -- chip_smoke.py's shapes
    n = CS.N_VERTICES
    columns = {"scattered": scattered_labels(n, ["S"], seed=5)["S"],
               "L0": clustered_labels(n, CS.LABELS, density=0.3,
                                      run_scale=512, seed=0)["L0"]}
    cases = []
    for name, dense in columns.items():
        pos, meta, nw = FO.stage_rle(TC.rle_encode_bool(dense), True)
        pos_t = torch.from_numpy(pos).to(dev)
        meta_t = torch.from_numpy(meta).to(dev)
        bound = (4 * pos.shape[1] + 12 + 4 * nw) / CS.HBM_BYTES_PER_S * 1e3
        print(f"kernel 13 on {name}: {pos.shape[1]} positions, {nw} words, "
              f"bound {bound:.5f} ms")
        cases.append((f"13 {name}", rle_all, FR.rle_to_bitmap(
            pos_t, meta_t, nw), torch.equal,
            lambda v, p=pos_t, m=meta_t, w=nw: rle_fn(v, p, m, w),
            (pos_t, meta_t, nw)))
    if args.stamps:
        stamped(torch, np, forms, cases, stream, dev)
        return 0
    adj, _, batches, _ = CS.build_graph()
    pac = TC.retrieve_neighbors_batch(adj, batches[CS.BATCHES[-1]],
                                      CS.PAGE_SIZE, None, engine="numpy")
    del adj
    age = np.random.default_rng(4).integers(0, 100, n).astype(np.float32)
    page_values = {p: age[p * CS.PAGE_SIZE:(p + 1) * CS.PAGE_SIZE]
                   for p in pac.pages()}
    vals, words = BO.stage_pages(pac, page_values)
    n_pages, ps = vals.shape
    vals_t = torch.from_numpy(vals).to(dev)
    words_t = torch.from_numpy(words.view(np.int32)).to(dev)
    want = BR.bitmap_select(vals_t, words_t, ps)
    selected = int(want[1].sum())
    bound = (4 * selected + 4 * n_pages * (ps // 32) + 4 * n_pages * ps
             + 4 * n_pages) / CS.HBM_BYTES_PER_S * 1e3
    print(f"kernel 14: {n_pages} pages of {ps}, {selected} selected, bound "
          f"{bound:.5f} ms")
    cases.append(("14 pac", select_all, want, same_select,
                  lambda v: select_fn(v, vals_t, words_t, ps), None))
    lanes = torch.arange(ps, device=dev)
    mask = ((words_t.long()[:, lanes >> 5] >> (lanes & 31)) & 1).bool()
    for what, names, want, same, make, _ in cases:
        for v in names:
            CS.require(same(make(v)(), want), f"{v} differs on {what}")
    times = {}
    for flip in (False, True):
        for what, names, _, _, make, _ in cases:
            for v in (names[::-1] if flip else names):
                fn = make(v)
                times.setdefault((what, v), []).append(
                    (CS.cuda_ms(torch, fn, 20), CS.queued_ms(torch, fn, 50)))
            if what.startswith("14"):
                # the library call, and a fill of the output's bytes
                for name, fn in (
                        ("masked_select",
                         lambda: torch.masked_select(vals_t, mask)),
                        ("zeros", lambda: torch.zeros(
                            (n_pages, ps), dtype=torch.int32, device=dev))):
                    times.setdefault((what, name), []).append(
                        (CS.cuda_ms(torch, fn, 20),
                         CS.queued_ms(torch, fn, 50)))
    print("shapes: every variant equal to the plain versions; ms a call "
          f"(device ms queued), the list's order then reversed, on {card}")
    for (what, v), ts in times.items():
        print(f"  {what:14s} {v:13s} " + "  ".join(
            f"{a:.4f} ({b:.4f})" for a, b in ts))
    print(json.dumps({"card": card, "times": {
        f"{w}|{v}": ts for (w, v), ts in times.items()}}))
    return 0

def stamped(torch, np, forms, cases, stream, dev):
    """Forms B, C1 and D with each block's stamps: per phase the median and
    the largest SM clocks a block spent, and the span from the first
    block's start to the last block's end on the global timer, beside the
    kernel's device time queued behind the host."""
    for what, _, want, _, _, (pos_t, meta_t, nw) in cases:
        for form, name, threads in ((0, "B", 256), (2, "C1/128", 128),
                                    (3, "C1/256", 256), (4, "C1/128s", 128),
                                    (8, "D/128", 128), (9, "C/128", 128),
                                    (10, "plain", 128), (7, "read", 128)):
            n_pos = pos_t.shape[1]
            blocks = -(-n_pos // (128 * 16)) if form == 7 else \
                -(-n_pos // min(max(-(-n_pos * 128 // (4 * nw)) * 4, 4),
                               128 * 16 - 64)) if form == 8 else \
                -(-nw // threads)
            st = torch.zeros((blocks, 6), dtype=torch.int64, device=dev)
            words = torch.empty(nw, dtype=torch.int32, device=dev)

            def run():
                rc = forms.forms_rle_stamped(
                    form, ctypes.c_void_p(pos_t.data_ptr()), pos_t.shape[1],
                    ctypes.c_void_p(meta_t.data_ptr()),
                    ctypes.c_void_p(words.data_ptr()), nw,
                    ctypes.c_void_p(st.data_ptr()), stream())
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")

            device = CS.queued_ms(torch, run, 50)
            run()
            torch.cuda.synchronize()
            CS.require(form in (7, 10) or torch.equal(words, want),
                       f"stamped {name} differs")
            s = st.cpu().numpy()
            phases = {"search": s[:, 3] - s[:, 2], "slice": s[:, 4] - s[:, 3],
                      "rest": s[:, 5] - s[:, 4], "block": s[:, 5] - s[:, 2]}
            span = (s[:, 1].max() - s[:, 0].min()) / 1e3
            starts = (s[:, 0] - s[:, 0].min()) / 1e3
            print(f"  {what:14s} {name:6s} device {device:.4f} ms, blocks "
                  f"span {span:.2f} us, last start {starts.max():.2f} us; "
                  "clocks median/max: " + ", ".join(
                      f"{k} {int(np.median(v))}/{int(v.max())}"
                      for k, v in phases.items()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
