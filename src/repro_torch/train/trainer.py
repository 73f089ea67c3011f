"""Training loop: data pipeline + train_step + checkpoints + FT hooks.

The JAX package's ``train/trainer.py`` on PyTorch.  The loop is host
driven and restartable: every piece of mutable state (params, opt state,
data cursor) either lives in the checkpoint or is derived from (seed,
step).  ``Trainer.run`` survives a mid-run ``simulate_failure_at`` by
restoring the latest committed checkpoint and replaying the data cursor
-- the exact behaviour the FT coordinator triggers on real failures.  The
model's device (``cuda:0`` unless it was built elsewhere) is where the
parameters, the optimizer state and every batch of ``batch_fn`` live (the
train step moves each batch there).

Given a distributed ``mesh`` (``launch/mesh.py``), the trainer runs one
rank's part: the parameters and optimizer state are DTensors placed by
the sharding rules, ``batch_fn`` gives the rank's local batch (its data
shard's, ``data/pipeline.py``) and the step sees the global batch
(``global_batch``), the history holds the global loss, checkpoints are
the global arrays (``checkpoint/checkpointer.py``) and a crash restores
onto the same mesh, each rank its own part.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint.checkpointer import (latest_checkpoint,
                                                 prune_checkpoints,
                                                 restore_checkpoint,
                                                 save_checkpoint)
from repro_torch.data.pipeline import global_batch
from repro_torch.distributed.sharding import (is_distributed, place,
                                              shard_params)
from repro_torch.ft.coordinator import Action, Coordinator
from repro_torch.models.model import LM

from .optimizer import Optimizer
from .train_step import make_train_step, model_params, unit_layout


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    keep_checkpoints: int = 3
    log_every: int = 10
    n_micro: int = 1


class Trainer:
    def __init__(self, model: LM, opt: Optimizer, cfg: TrainerConfig,
                 batch_fn: Callable[[int], Dict],
                 coordinator: Optional[Coordinator] = None, mesh=None):
        if mesh is not None and not is_distributed(mesh):
            mesh = None              # one card: nothing to place
        self.mesh = mesh
        self.model = model
        self.opt = opt
        self.cfg = cfg
        self.batch_fn = batch_fn
        self.coordinator = coordinator
        self.step_fn = make_train_step(model, opt, cfg.n_micro)
        self.layout = unit_layout(model)
        self.history: List[Dict] = []

    def _init_state(self):
        params = model_params(self.model.init(0))
        if self.mesh is not None:
            params = self._place(params)
        opt_state = self.opt.init(params, self.layout)
        if self.mesh is not None:
            opt_state = self._place(opt_state)
        return params, opt_state, 0

    def _place(self, tree):
        return place(tree, shard_params(tree, self.mesh, self.model.cfg))

    def _batch(self, step: int) -> Dict:
        batch = self.batch_fn(step)
        return batch if self.mesh is None else global_batch(batch, self.mesh)

    def _step(self, params, opt_state, batch):
        if self.mesh is None:
            return self.step_fn(params, opt_state, batch)
        with self.mesh:
            return self.step_fn(params, opt_state, batch)

    def _try_restore(self, params, opt_state):
        step = latest_checkpoint(self.cfg.checkpoint_dir)
        if step is None:
            return params, opt_state, 0
        tree, extra = restore_checkpoint(
            self.cfg.checkpoint_dir, step,
            like={"params": params, "opt": opt_state})
        return tree["params"], tree["opt"], int(extra["next_step"])

    def run(self, resume: bool = True,
            simulate_failure_at: Optional[int] = None) -> Dict:
        params, opt_state, start = self._init_state()
        if resume:
            params, opt_state, start = self._try_restore(params, opt_state)
        step = start
        failures = 0
        while step < self.cfg.total_steps:
            t0 = time.perf_counter()
            if simulate_failure_at is not None and step == simulate_failure_at:
                simulate_failure_at = None
                failures += 1
                # crash-restart: drop live state, restore committed ckpt
                params, opt_state, step = self._init_state()
                params, opt_state, step = self._try_restore(params,
                                                            opt_state)
                continue
            params, opt_state, metrics = self._step(params, opt_state,
                                                   self._batch(step))
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = time.perf_counter() - t0
            if self.coordinator is not None:
                self.coordinator.heartbeat(0, step, dt)
                decision = self.coordinator.tick(
                    latest_checkpoint(self.cfg.checkpoint_dir))
                if decision.action in (Action.RESTART_FROM_CHECKPOINT,
                                       Action.ELASTIC_SCALE_DOWN):
                    params, opt_state, step = self._init_state()
                    params, opt_state, step = self._try_restore(params,
                                                                opt_state)
                    failures += 1
                    continue
            step += 1
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                self.history.append({"step": step, "loss": loss,
                                     "grad_norm": gnorm, "sec_per_step": dt})
            if step % self.cfg.checkpoint_every == 0:
                save_checkpoint(self.cfg.checkpoint_dir, step,
                                {"params": params, "opt": opt_state},
                                extra={"next_step": step})
                prune_checkpoints(self.cfg.checkpoint_dir,
                                  self.cfg.keep_checkpoints)
        return {"params": params, "opt_state": opt_state,
                "history": self.history, "failures": failures,
                "final_step": step}
