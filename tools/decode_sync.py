#!/usr/bin/env python3
"""Count the host syncs of one continuous-batching decode step and time it,
for the port in this checkout or in another.

Run on a machine with one NVIDIA GPU:

    python3 tools/decode_sync.py [--root DIR] [--steps N]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
smollm-360m at full width (bf16, ``init(seed=0)``) on ``cuda:0`` and the
serving engine's cache: 8 slots of 1024 positions, float32, a per-slot
index at 100, 300, ..., 1500 (the last four past the cache's end, where
the write is dropped).  It counts the syncs of one ``decode_step`` with
the tokens already on the card, as ``torch.cuda.set_sync_debug_mode
("warn")`` reports them (phase 14's ``chip_smoke.sync_count``), then
times ``N`` steps: the host wall until ``decode_step`` returns (the
dispatch) and until the card has finished, each the median over the
steps.  Prints the card's name and power limit
first and one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import sync_count       # phase 14's count
    # (after chip_smoke, which puts this checkout's src first)
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("decode_sync: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    model = build_model(get_config("smollm-360m", use_flash=True)).init(0)
    cache = model.init_cache(8, 1024, dtype=torch.float32,
                             vector_index=True)
    idx = torch.arange(100, 1700, 200, dtype=torch.int32, device="cuda")
    cache["index"] = idx
    for layer in cache["layers"]:
        layer["kv"]["index"] = idx.clone()
    tokens = torch.full((8, 1), 5, dtype=torch.int32, device="cuda")
    model.decode_step(tokens, cache)
    syncs = sync_count(torch, lambda: model.decode_step(tokens, cache))
    dispatch, total = [], []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_step(tokens, cache)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dispatch.append((t1 - t0) * 1e3)
        total.append((t2 - t0) * 1e3)
    out = {"root": args.root, "syncs": syncs,
           "dispatch_ms": statistics.median(dispatch),
           "step_ms": statistics.median(total)}
    print(f"decode_step: {syncs} host syncs; dispatch {out['dispatch_ms']:.3f}"
          f" ms, step {out['step_ms']:.3f} ms (median of {args.steps})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
