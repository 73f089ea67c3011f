#!/usr/bin/env python3
"""Time the host side of one ``gather_decode`` call (kernel 2) at the
non-fused path's small shape, for the port in this checkout or in another.

Run on a machine with one NVIDIA GPU:

    python3 tools/gather_decode_host.py [--root DIR] [--calls N]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels, packs a column of 64 pages of 2048 sorted ids and places it
on ``cuda:0``, then times ``N`` back-to-back calls at 8 rows on the host
clock (the device takes a few microseconds a call, so the host sets the
pace), the median of five runs of ``N`` after a warm-up.  A checkout whose
column has ``device_pages`` is called as ``gather_decode(pages, idx)``,
an older one as ``gather_decode(*device_plan, idx)``.  For the former it
also times the pieces of a call one by one: ``note_shape``, the check of
``idx``, the output's allocation (``torch.empty`` and ``new_empty``), the
stream's lookup (``torch.cuda.current_stream`` and ``_build.stream``),
the pointer of a tensor, and the C entry with and without
``_build.launch``.  Prints the card's name and power
limit first and one JSON line last, in microseconds a call.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def per_call_us(torch, fn, calls: int) -> float:
    """Mean host microseconds a call of ``fn`` over ``calls`` back-to-back
    calls (median of five runs), synchronised at both ends."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(runs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("gather_decode_host: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.encoding import delta_encode_column, pack_column
    from repro_torch.kernels import _build as B
    from repro_torch.kernels._pad import note_shape
    from repro_torch.kernels.pac_decode import kernel as PK
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}, torch {torch.__version__}, root {root}")
    B.library()
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    ps = 2048
    packed = pack_column(delta_encode_column(
        np.sort(rng.integers(0, 1 << 24, 64 * ps)), ps))
    idx = torch.from_numpy(rng.integers(0, 64, 8).astype(np.int32)).to(dev)
    n = args.calls
    out = {"card": card, "root": str(root), "calls": n}
    if hasattr(packed, "device_pages"):
        pages = packed.device_pages(dev)
        out["wrapper_us"] = per_call_us(
            torch, lambda: PK.gather_decode(pages, idx), n)
        buf = torch.empty((8, ps), dtype=torch.int32, device=dev)
        lib = B.library()
        s = B.stream(dev)
        args_c = (*pages.args, B.ptr(idx), 8, B.ptr(buf), s)
        out["pieces_us"] = {
            "note_shape": per_call_us(
                torch, lambda: note_shape("gather_decode", 8, pages.shape),
                n),
            "check_idx": per_call_us(
                torch, lambda: (idx.device != pages.device
                                or idx.dtype != torch.int32
                                or idx.dim() != 1
                                or not idx.is_contiguous()), n),
            "torch_empty": per_call_us(
                torch, lambda: torch.empty((8, ps), dtype=torch.int32,
                                           device=dev), n),
            "new_empty": per_call_us(
                torch, lambda: idx.new_empty((8, ps)), n),
            "current_stream": per_call_us(
                torch, lambda: torch.cuda.current_stream(dev).cuda_stream,
                n),
            "stream": per_call_us(torch, lambda: B.stream(dev), n),
            "ptr": per_call_us(torch, lambda: B.ptr(idx), n),
            "launch": per_call_us(
                torch, lambda: B.launch("rt_gather_decode", *args_c), n),
            "c_entry": per_call_us(
                torch, lambda: lib.rt_gather_decode(*args_c), n),
        }
    else:
        plan = packed.device_plan(dev)
        out["wrapper_us"] = per_call_us(
            torch, lambda: PK.gather_decode(*plan, idx), n)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
