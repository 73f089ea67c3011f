#!/usr/bin/env python3
"""Count the aten ops of one train step under each ``remat`` mode and time
the step on the card, to show what a remat policy costs the host.

    python3 tools/remat_overhead.py [--units N] [--seq S] [--reps R]

Builds reduced smollm-360m with ``N`` units (32 by default: the full
depth, at the reduced width, so the step is nearly all dispatch) on
``cuda:0`` and runs ``make_train_step`` (AdamW, 4 microbatches of 2 x
``S`` tokens) once to warm up, once under a counting ``TorchDispatchMode``
(the aten ops the step dispatches, the recompute's among them), and ``R``
times timed (host wall to a synchronize, the median), for ``remat``
``"none"``, ``"full"`` and ``"dots"``.  Prints the card's name and power
limit, one line a mode and one JSON line last.  Exits with 2 without a
card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--units", type=int, default=32)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    if not torch.cuda.is_available():
        print("remat_overhead: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)

    import repro_torch.configs as RC
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import (make_train_step, model_params,
                                              unit_layout)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(0)
    out = {"card": card, "units": args.units, "seq": args.seq}
    for remat in ("none", "full", "dots"):
        cfg = RC.get_config("smollm-360m").reduced().with_(
            n_units=args.units, remat=remat)
        model = build_model(cfg).init(0)
        params = model_params(model)
        opt = adamw(1e-3)
        state = opt.init(params, unit_layout(model))
        step = make_train_step(model, opt, 4)
        batch = {k: rng.integers(0, cfg.vocab_size, (8, args.seq)
                                 ).astype(np.int32)
                 for k in ("tokens", "labels")}
        step(params, state, batch)
        count = Count()
        with count:
            step(params, state, batch)
        times = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        out[remat] = {"aten_ops": count.n, "step_ms": ms}
        print(f"remat {remat}: {count.n} aten ops a step, {ms:.1f} ms a "
              f"step (median of {args.reps}) on {card}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
