"""Training launcher CLI.

The JAX package's ``launch/train.py`` on the port.  Laptop-scale end to
end (the trainer on seeded random batches), on the card by default:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 50 [--device cpu]

Production check of one cell with no execution: ``--lower-only`` runs
the port's dry-run (``launch/dryrun.py``: the ``train_4k`` cell traced on
``meta`` over the 16x16 mesh, no card needed) in a subprocess, as the
reference runs its own, and exits with its code:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --lower-only
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized reduced config")
    ap.add_argument("--lower-only", action="store_true",
                    help="trace the production train cell on meta and exit")
    ap.add_argument("--seq_len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--checkpoint_dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; cpu for the plain "
                    "versions)")
    args = ap.parse_args(argv)

    if args.lower_only:
        import subprocess
        import sys
        raise SystemExit(subprocess.call(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             args.arch, "--shape", "train_4k", "--mesh", "single"]))

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, param_count
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, args.device)
    print(f"{cfg.name}: {param_count(model.init(0))/1e6:.1f}M params")

    def batch_fn(step):
        r = np.random.default_rng(step)
        b = {"tokens": r.integers(0, cfg.vocab_size, (args.batch,
                                                      args.seq_len)
                                  ).astype(np.int32)}
        b["labels"] = r.integers(0, cfg.vocab_size, (args.batch,
                                                     args.seq_len)
                                 ).astype(np.int32)
        if cfg.encoder_layers:
            b["frames"] = r.standard_normal(
                (args.batch, cfg.default_encoder_len, cfg.d_model)
            ).astype(np.float32)
        if cfg.num_vision_tokens:
            b["vision"] = r.standard_normal(
                (args.batch, cfg.num_vision_tokens, cfg.d_model)
            ).astype(np.float32)
        return b

    opt = adamw(warmup_cosine(3e-4, 10, args.steps))
    trainer = Trainer(model, opt, TrainerConfig(
        total_steps=args.steps, checkpoint_every=max(args.steps // 2, 1),
        checkpoint_dir=args.checkpoint_dir, log_every=10), batch_fn)
    out = trainer.run()
    for h in out["history"]:
        print(f"step {h['step']:>5} loss {h['loss']:.4f} "
              f"({h['sec_per_step']:.2f}s)")


if __name__ == "__main__":
    main()
