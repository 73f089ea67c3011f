"""Serving launcher CLI: the continuous-batching engine demo.

The JAX package's ``launch/serve.py`` on PyTorch, on the card by default:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      [--reduced] [--requests 8] [--device cuda:0|cpu]

The model is built on ``--device`` (``cuda:0`` unless given; with no card
that raises, as the model does) and filled by ``init(0)``; the port's
``ServeEngine`` holds the model and takes no ``params``.  Prompts come
from ``numpy.random.default_rng(0)`` as the reference's do, and
``eos_id`` is -1, so the ticks and decode steps depend on scheduling
alone.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max_new_tokens", type=int, default=16)
    ap.add_argument("--max_len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; cpu for the plain "
                    "versions)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.encoder_layers or cfg.num_vision_tokens:
        raise SystemExit("serve CLI demo supports decoder-only archs; "
                         "multimodal prefill needs frames/vision inputs")
    with torch.no_grad():
        model = build_model(cfg, args.device).init(0)
        eng = ServeEngine(model, max_slots=args.slots, max_len=args.max_len,
                          eos_id=-1)
        rng = np.random.default_rng(0)
        for rid in range(args.requests):
            prompt = rng.integers(4, cfg.vocab_size,
                                  size=int(rng.integers(8, 32))
                                  ).astype(np.int32)
            eng.submit(Request(rid, prompt,
                               max_new_tokens=args.max_new_tokens))
        t0 = time.perf_counter()
        ticks = 0
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            ticks += 1
            if ticks > 10_000:
                break
        dt = time.perf_counter() - t0
    total = args.requests * args.max_new_tokens
    print(f"served {args.requests} requests in {ticks} ticks "
          f"({eng.steps} batched decode steps, {total/dt:.1f} tok/s)")
    return {"requests": len(eng.finished), "ticks": ticks,
            "steps": eng.steps,
            "tokens": sum(len(r.output) for r in eng.finished),
            "seconds": dt}


if __name__ == "__main__":
    main()
