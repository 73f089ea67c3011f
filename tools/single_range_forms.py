#!/usr/bin/env python3
"""Time the scatter forms of kernels 11 and 12 side by side on one card.

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 tools/single_range_forms.py [--parent DIR] [--forms A/256,...]

Builds ``tools/single_range_forms.cu`` (forms A-D of the scatter on one
decode; see its header) and, with ``--parent``, the ``single_range.cu``
of the checkout in DIR, each with ``nvcc`` into a library of its own under
``build/forms/``.  It holds every variant bit for bit against the plain
versions (``pac_decode/ref.py``) on small cases (page sizes 99, 2048 and
4099, a window of several cluster passes, an unaligned ids view), then on
the soc-LiveJournal1 graph of ``chip_smoke.py``: kernel 12 over the whole
``<dst>`` and ``<src>`` columns and kernel 11 over the 68,980,934 sorted
``<src>`` ids.  Each variant's time a call (CUDA events around 20
back-to-back calls) and its device time queued behind the host are timed
in the order of the list and then in reverse, and printed beside the
port's own kernels (``PK.fused_decode_bitmap`` and ``PK.bitmap``) and the
parent's.  The card's name and power limit come first.
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

import chip_smoke as CS  # noqa: E402

OUT = ROOT / "build" / "forms"
CSRC = "src/repro_torch/kernels/csrc"
#: (name, form, threads a block, param): form 0-4 is A-D and D+; param is C's
#: cluster size (C8/512: 8 blocks of 512 threads) and D's window words a
#: warp (D512/256: 512 words, blocks of 256 threads; D+ loads a pass
#: ahead); ``--forms`` picks
VARIANTS = {v[0]: v for v in [
    ("A/256", 0, 256, 1), ("B/256", 1, 256, 1),
    ("C4/512", 2, 512, 4), ("C4/1024", 2, 1024, 4),
    ("C8/512", 2, 512, 8), ("C8/1024", 2, 1024, 8),
    ("C16/1024", 2, 1024, 16),
    ("D256/256", 3, 256, 256), ("D512/256", 3, 256, 512),
    ("D1024/256", 3, 256, 1024), ("D512/512", 3, 512, 512),
    ("D128/256", 3, 256, 128), ("D256/512", 3, 512, 256),
    ("D+256/256", 4, 256, 256), ("D+256/512", 4, 512, 256),
    ("D+128/256", 4, 256, 128)]}
P = ctypes.c_void_p
I = ctypes.c_int


def build(src: Path, include: Path, name: str):
    """Start ``nvcc`` on one source; returns the process and the library."""
    lib = OUT / f"lib{name}.so"
    from repro_torch.kernels import _build
    cmd = [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas=-v", "-I", str(include), str(src), "-o", str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def load(lib: Path, prefix: str):
    so = ctypes.CDLL(str(lib))
    ids = getattr(so, f"{prefix}ids_bitmap")
    fused = getattr(so, f"{prefix}fused_decode_bitmap")
    lead = [I, I, I] if prefix == "forms_" else []
    ids.argtypes = lead + [P, I, I, P, I, P]
    fused.argtypes = lead + [P] * 6 + [I] * 5 + [P, I, P]
    ids.restype = fused.restype = I
    return ids, fused


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout whose single_range.cu is "
                    "timed beside the forms")
    ap.add_argument("--forms", default=",".join(VARIANTS),
                    help="the variants to time, comma-separated (default: "
                    "all)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("single_range_forms: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from repro_torch.core.encoding import delta_encode_column
    from repro_torch.kernels import _build
    from repro_torch.kernels.pac_decode import kernel as PK
    from repro_torch.kernels.pac_decode import ops
    from repro_torch.kernels.pac_decode import ref as PR
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = [build(ROOT / "tools/single_range_forms.cu", ROOT / CSRC,
                  "forms")]
    if args.parent:
        pc = Path(args.parent).resolve() / CSRC
        jobs.append(build(pc / "single_range.cu", pc, "parent"))
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
    f_ids, f_fused = load(jobs[0][1], "forms_")
    parent = load(jobs[1][1], "rt_") if args.parent else None
    dev = torch.device("cuda:0")

    def stream():
        return P(torch.cuda.current_stream(dev).cuda_stream)

    def call(fn, *a):
        rc = fn(*a)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")

    def fused_fn(v, shipped, base, nw, ps):
        """A call of kernel 12 in variant v (a VARIANTS entry, "port" or
        "parent") on the shipped pages."""
        def run():
            if v == "port":
                return PK.fused_decode_bitmap(*shipped, base=base,
                                              page_size=ps, words_out=nw)
            words = torch.empty(nw, dtype=torch.int32, device=dev)
            lead = [] if v == "parent" else list(v[1:])
            fn = parent[1] if v == "parent" else f_fused
            call(fn, *lead, *[P(t.data_ptr()) for t in shipped],
                 shipped[0].shape[0], shipped[1].shape[1],
                 shipped[4].shape[1], ps, base, P(words.data_ptr()), nw,
                 stream())
            return words
        return run

    def ids_fn(v, ids_t, count, base, nw):
        def run():
            if v == "port":
                return PK.bitmap(ids_t, count, base, nw)
            words = torch.empty(nw, dtype=torch.int32, device=dev)
            lead = [] if v == "parent" else list(v[1:])
            fn = parent[0] if v == "parent" else f_ids
            call(fn, *lead, P(ids_t.data_ptr()), count, base,
                 P(words.data_ptr()), nw, stream())
            return words
        return run

    everyone = [VARIANTS[f] for f in args.forms.split(",")] + ["port"] + \
        (["parent"] if parent else [])

    def name(v):
        return v if isinstance(v, str) else v[0]


    # -- small cases, each variant against the plain version; a variant
    #    the card refuses (a cluster it cannot place) is dropped
    for v in list(everyone):
        try:
            fused_fn(v, ops.ship_pages(ops.pack_pages(delta_encode_column(
                np.arange(5000), 2048), 0, 3), dev), 0, 1 << 10, 2048)()
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"{name(v)} dropped: {e}")
            everyone.remove(v)
    rng = np.random.default_rng(0)
    for ps in (99, 2048, 4099):
        vals = np.concatenate([np.sort(rng.integers(0, 1 << 20, 7 * ps)),
                               rng.integers(-(1 << 30), 1 << 30, 3 * ps),
                               rng.integers(0, 5000, 77)])
        enc = delta_encode_column(vals, ps)
        shipped = ops.ship_pages(ops.pack_pages(enc, 0, len(enc.pages)), dev)
        for base, nw in ((0, 1 << 15), (-(1 << 20), 1 << 16), (4096, 1)):
            want = PR.fused_decode_bitmap(*shipped, base, ps, nw)
            for v in everyone:
                got = fused_fn(v, shipped, base, nw, ps)()
                CS.require(torch.equal(got, want),
                           f"{name(v)} differs at page size {ps}, base {base}")
    # 2^20 words: 2-6 passes of the cluster forms
    ids = np.sort(rng.integers(0, 1 << 25, 3_000_001)).astype(np.int32)
    ids_t = torch.from_numpy(ids).to(dev)
    for view, count, nw in ((ids_t, len(ids), 1 << 20),
                            (ids_t[1:], len(ids) - 5, 1 << 20),
                            (ids_t[3:], 1000, 64)):
        want = PR.bitmap(view, count, 0, nw)
        for v in everyone:
            got = ids_fn(v, view, count, 0, nw)()
            CS.require(torch.equal(got, want),
                       f"{name(v)} differs on ids ({count}, {nw} words)")
    print("small cases: every variant equal to the plain versions",
          flush=True)

    # -- soc-LiveJournal1
    adj, _, _, _ = CS.build_graph()
    words_out = -(-CS.N_VERTICES // 2048) * 64
    cases = []
    for col in ("<dst>", "<src>"):
        enc = adj.table[col].encoded
        args_np = ops.pack_pages(enc, 0, len(enc.pages))
        shipped = ops.ship_pages(args_np, dev)
        want = PR.fused_decode_bitmap(*shipped, 0, CS.PAGE_SIZE, words_out)
        cases.append((f"fused {col}", want, lambda v, s=shipped: fused_fn(
            v, s, 0, words_out, CS.PAGE_SIZE)))
    src_ids = np.repeat(np.arange(CS.N_VERTICES, dtype=np.int32),
                        adj.degrees().astype(np.int64))
    src_t = torch.from_numpy(src_ids).to(dev)
    n_src = src_t.shape[0]
    want = PR.bitmap(src_t, n_src, 0, words_out)
    cases.append(("ids <src>", want, lambda v: ids_fn(
        v, src_t, n_src, 0, words_out)))
    times = {}
    for what, want, make in cases:
        for v in everyone:
            CS.require(torch.equal(make(v)(), want),
                       f"{name(v)} differs on {what}")
    for order in (everyone, everyone[::-1]):
        for what, _, make in cases:
            for v in order:
                fn = make(v)
                times.setdefault((what, name(v)), []).append(
                    (CS.cuda_ms(torch, fn, 20), CS.queued_ms(torch, fn, 50)))
    print("LiveJournal: every variant equal to the plain versions; ms a call "
          f"(device ms queued), the list's order then reversed, on {card}")
    for (what, v), ts in times.items():
        print(f"  {what:12s} {v:9s} " + "  ".join(
            f"{a:.4f} ({b:.4f})" for a, b in ts))
    print(json.dumps({"card": card, "times": {
        f"{w}|{v}": ts for (w, v), ts in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
