"""End to end on the PyTorch port: train a ~100M-param LM on a
GraphAr document lake.

The full production path at laptop scale: synthetic corpus -> GraphAr
storage -> label-filtered, link-expanded data pipeline (its label filter
on the port's kernels) -> smollm-family model -> AdamW + cosine +
grad-accum trainer with checkpointing and simulated failure recovery.
The initial weights come from a ``torch.Generator`` seeded with 0, so the
losses are not the JAX package's.

Run:  PYTHONPATH=src python examples/train_graph_corpus_torch.py \\
          [--steps 200] [--device cpu]
(defaults are sized for a few minutes on CPU; --full_100m uses the real
 ~100M config.)
"""
import argparse
import os
import tempfile

import torch

from _torch_example import add_device_arg, open_device
from repro_torch.configs import get_config
from repro_torch.core import (EdgeTypeSchema, GraphArBuilder, L,
                              PropertySchema, VertexTypeSchema)
from repro_torch.data.pipeline import GraphCorpusPipeline, PipelineConfig
from repro_torch.data.synthetic import document_graph
from repro_torch.models import build_model, param_count
from repro_torch.train.optimizer import adamw
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq_len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full_100m", action="store_true",
                    help="use a true ~100M-param config (slow on CPU)")
    ap.add_argument("--fail_at", type=int, default=None,
                    help="simulate a crash at this step (FT demo)")
    add_device_arg(ap)
    args = ap.parse_args()
    engine, device, where = open_device(args.device)

    # -- the lake -----------------------------------------------------------
    lake = document_graph(num_docs=4000, vocab=4096, mean_len=200, seed=0)
    b = GraphArBuilder("corpus")
    b.add_vertices(
        VertexTypeSchema("doc", [PropertySchema("tokens", "tokens")],
                         labels=list(lake.labels), page_size=1024),
        {"tokens": lake.tokens}, lake.labels)
    b.add_edges(EdgeTypeSchema("doc", "links", "doc", page_size=1024),
                lake.links_src, lake.links_dst)
    graph = b.build()

    # -- the pipeline: quality-filtered + link-expanded ----------------------
    cond = (L("HighQuality") | L("News")) & ~L("Spam")
    pcfg = PipelineConfig(seq_len=args.seq_len, batch_size=args.batch)
    pipe = GraphCorpusPipeline(graph, cond, pcfg, engine=engine)
    print(f"pipeline: {len(pipe.eligible)} eligible docs after filtering")
    stream = pipe.batches()
    batches = {}

    def batch_fn(step):
        while step not in batches:
            nxt = next(stream)
            batches[nxt["step"]] = {
                k: torch.as_tensor(nxt[k], device=device)
                for k in ("tokens", "labels")}
            if len(batches) > 64:
                batches.pop(min(batches))
        return batches[step]

    # -- the model ------------------------------------------------------------
    if args.full_100m:
        cfg = get_config("smollm-360m").with_(
            n_units=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=4096,
            param_dtype="float32", compute_dtype="float32", remat="none")
    else:
        cfg = get_config("smollm-360m").reduced().with_(
            vocab_size=4096, n_units=4)
    model = build_model(cfg, device).init(0)
    n_params = param_count(model)
    print(f"model: {cfg.name} derivative, {n_params/1e6:.1f}M params")

    opt = adamw(warmup_cosine(3e-4, 20, args.steps))
    ckpt_dir = os.path.join(tempfile.gettempdir(), "graphar_train_ckpt")
    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=50,
                         checkpoint_dir=ckpt_dir, log_every=10)
    trainer = Trainer(model, opt, tcfg, batch_fn)
    out = trainer.run(simulate_failure_at=args.fail_at)
    for h in out["history"]:
        print(f"  step {h['step']:>5}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.2f}  {h['sec_per_step']:.2f}s/step"
              f"  [on {where}]")
    first, last = out["history"][0], out["history"][-1]
    print(f"loss {first['loss']:.3f} -> {last['loss']:.3f} "
          f"({out['failures']} failures recovered)")
    io = pipe.io_stats()
    print(f"lake I/O: {io.nbytes/1e6:.1f} MB in {io.nrequests} requests")


if __name__ == "__main__":
    main()
