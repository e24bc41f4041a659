"""Trainer: epochs, curriculum, LR schedules, history, checkpoints, resume.

Counterpart of ``gnn_bfs_rans_tpu/train/trainer.py`` (behavioural parity
with the reference's ``train.py main()``):

* per epoch: shuffled batches → train steps; "validation" over the same
  data (the reference has no split), on the eval forward or, with BN
  recalibration on, on the exact-batch-statistics forward; the plateau
  scheduler steps on the val loss; per-field errors every 10 epochs;
* curriculum: phase 1 freezes the pressure output, phase 2 unfreezes it
  and halves the LR;
* ``best`` on val-loss improvement and ``epoch_N`` every ``save_every``
  epochs, saved with exact BN statistics when recalibration is on, plus the
  optimizer state that ``resume`` continues from;
* ``training_history.json`` in the reference schema and ``metrics.jsonl``;
* on ``KeyboardInterrupt`` (Ctrl-C, or SIGTERM raised as one): the last
  completed epoch saved as ``epoch_<N>`` with ``interrupted: True`` and the
  history written, then the interrupt re-raised, so ``resume`` continues.

It trains on every backend (``pallas``, ``dense``, ``segment``; a
``pallas`` model on a mesh without a band takes the convs' dense
branches).  It runs on the card unless asked for the CPU, and has no
fallback: a CUDA tensor goes to the kernels or the step raises.  Not
ported: the JAX trainer's device-resident epoch blocks
(``epoch_block > 1``), its Mosaic compile retries and dense-backend
fallback (``kernels/fallback.py``: a TPU workaround that would hide a
kernel fault here), its AOT executable cache, its tqdm bar and
``ModelConfig.remat`` (constructing a trainer for it raises).  Dropout
masks and kernel seeds come from one ``torch.Generator`` on the training
device, seeded from ``TrainConfig.seed``; parameters are initialized from a
CPU generator with the same seed.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models.flow_gnn import FlowGNN, ModelConfig
from .checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    load_train_state,
    save_checkpoint,
)
from .data import FlowDataset
from .loop import (
    ReduceLROnPlateau,
    TrainConfig,
    check_trainable,
    cosine_lr,
    eval_step,
    iterate_batches,
    make_optimizer,
    train_step,
)
from .recal import exact_stats, resolve_bn_recal

FIELDS = ("U", "p", "k", "epsilon", "nut")


def empty_history() -> dict:
    return {"epoch": [], "train_loss": [], "val_loss": [],
            "field_errors": {f: [] for f in FIELDS}, "learning_rate": []}


class Trainer:
    def __init__(
        self,
        dataset: FlowDataset,
        model_config: ModelConfig,
        train_config: TrainConfig,
        output_dir: str | Path = "checkpoints",
        log_fn=print,
        device: str | torch.device = "cuda",
    ):
        if train_config.epoch_block > 1:
            raise NotImplementedError(
                "epoch_block > 1 (the JAX package's on-device lax.scan of "
                "whole epochs) is not ported yet")
        check_trainable(model_config)
        self.device = resolve_device(device)
        self.dataset = dataset
        self.model_config = model_config
        self.config = train_config
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.log = log_fn

        self.model = FlowGNN(
            model_config,
            generator=torch.Generator().manual_seed(train_config.seed),
        ).to(self.device)
        self.optimizer = make_optimizer(self.model, train_config)
        self.graph = dataset.graph.to(self.device)
        self.targets = torch.from_numpy(dataset.targets).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            train_config.seed)
        self.np_rng = np.random.default_rng(train_config.seed)
        self.bn_recal = resolve_bn_recal(train_config.bn_recal, model_config)
        self.history = empty_history()
        self.start_epoch = 1
        self.scheduler = ReduceLROnPlateau(
            train_config.lr, factor=train_config.plateau_factor,
            patience=train_config.plateau_patience,
            threshold=train_config.plateau_threshold,
            min_lr=train_config.plateau_min_lr)
        self.best_val = float("inf")

    # ------------------------------------------------------------------ setup
    def initialize(self, resume: bool = False) -> None:
        if resume:
            name = latest_checkpoint(self.output_dir)
            if name is not None:
                state, meta = load_checkpoint(self.output_dir, name)
                self.model.load_state_dict(state)
                train_state = load_train_state(self.output_dir, name)
                self.optimizer.load_state_dict(train_state["optimizer"])
                self.start_epoch = int(meta.get("epoch", 0)) + 1
                self.best_val = float(meta.get("best_val",
                                               meta.get("val_loss", np.inf)))
                self.scheduler.lr = float(meta.get("lr", self.config.lr))
                self.scheduler.best = float(meta.get("sched_best",
                                                     self.best_val))
                hist = self.output_dir / "training_history.json"
                if hist.exists():
                    self.history = json.loads(hist.read_text())
                self._truncate_metrics_jsonl(self.start_epoch)
                self.log(f"Resumed from {name} at epoch {self.start_epoch}")
        n_params = sum(p.numel() for p in self.model.parameters())
        self.log(f"Model parameters: {n_params:,}")
        if self.bn_recal:
            self.log("BN recalibration ON: val loss / best selection on "
                     "exact batch statistics; checkpoints saved recalibrated")

    def _truncate_metrics_jsonl(self, start_epoch: int) -> None:
        """Drop metrics.jsonl rows at/after ``start_epoch`` so a resumed run
        does not record those epochs twice."""
        path = self.output_dir / "metrics.jsonl"
        if not path.exists():
            return
        kept = []
        for line in path.read_text().splitlines():
            try:
                if int(json.loads(line).get("epoch", -1)) < start_epoch:
                    kept.append(line)
            except (ValueError, json.JSONDecodeError):
                kept.append(line)
        path.write_text("".join(ln + "\n" for ln in kept))

    # ------------------------------------------------------------------ train
    def train(self) -> dict:
        """Run the epoch loop.  On ``KeyboardInterrupt`` it saves
        ``epoch_<last completed epoch>`` (``epoch_0`` before the first, with
        an infinite val loss) with ``interrupted: True`` and the history,
        then re-raises, as the JAX trainer does (whose state may not exist
        yet; this trainer holds its model from construction)."""
        try:
            return self._train_loop()
        except KeyboardInterrupt:
            epoch = self.history["epoch"][-1] if self.history["epoch"] else 0
            val_loss = (self.history["val_loss"][-1] if epoch
                        else float("inf"))
            self._save(f"epoch_{epoch}", epoch, val_loss, {
                "best_val": self.best_val, "lr": self.scheduler.lr,
                "sched_best": self.scheduler.best, "interrupted": True})
            self.save_history()
            self.log(f"Interrupted: checkpoint saved at epoch {epoch}")
            raise

    def _train_loop(self) -> dict:
        cfg = self.config
        n = self.dataset.n_snapshots
        lr = self.scheduler.lr
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            freeze = False
            if cfg.curriculum_epochs > 0:
                if epoch <= cfg.curriculum_epochs:
                    freeze = True
                elif epoch == cfg.curriculum_epochs + 1:
                    self.scheduler.lr *= 0.5
                    lr = self.scheduler.lr
                    self.log(f"Curriculum phase 2: unfreezing pressure, "
                             f"lr → {lr:.3e}")
            if cfg.scheduler == "cosine":
                lr = cosine_lr(cfg, epoch)

            t0 = time.perf_counter()
            losses = [
                train_step(self.model, self.optimizer, self.graph,
                           self.targets[torch.from_numpy(idx).to(self.device)],
                           lr, cfg, self.generator, freeze_pressure=freeze)
                for idx in iterate_batches(n, cfg.batch_size, self.np_rng)]
            train_loss = float(torch.stack(losses).mean())
            if not np.isfinite(train_loss):
                self.save_history()
                raise FloatingPointError(
                    f"non-finite training loss at epoch {epoch} "
                    f"(loss={train_loss})")

            val_loss, errors, _ = eval_step(self.model, self.graph,
                                            self.targets, cfg,
                                            recal=self.bn_recal)
            val_loss = float(val_loss)
            lr_used = lr
            if cfg.scheduler == "plateau":
                lr = self.scheduler.step(val_loss)

            detailed = epoch % 10 == 0
            self.history["epoch"].append(epoch)
            self.history["train_loss"].append(train_loss)
            self.history["val_loss"].append(val_loss)
            self.history["learning_rate"].append(lr_used)
            for f in FIELDS:
                self.history["field_errors"][f].append(
                    float(errors[f]) if detailed else None)
            if detailed:
                self.log(f"Epoch {epoch} field errors: " + ", ".join(
                    f"{f}={float(errors[f]):.6f}" for f in FIELDS))
            dt = time.perf_counter() - t0
            self.log(f"Epoch {epoch}: train={train_loss:.6f} "
                     f"val={val_loss:.6f} lr={lr_used:.3e} ({dt:.2f}s)")
            with open(self.output_dir / "metrics.jsonl", "a") as fh:
                fh.write(json.dumps({
                    "epoch": epoch, "train_loss": train_loss,
                    "val_loss": val_loss, "lr": lr_used, "epoch_seconds": dt,
                    **({f"err_{k}": float(errors[k]) for k in FIELDS}
                       if detailed else {}),
                }) + "\n")

            extra = {"best_val": min(self.best_val, val_loss), "lr": lr,
                     "sched_best": self.scheduler.best}
            if val_loss < self.best_val:
                self.best_val = val_loss
                self._save("best", epoch, val_loss, extra)
            if epoch % cfg.save_every == 0:
                self._save(f"epoch_{epoch}", epoch, val_loss, extra)
        self.save_history()
        return self.history

    def _save(self, name: str, epoch: int, val_loss: float,
              extra: dict) -> None:
        state = self.model.state_dict()
        if self.bn_recal:
            # exact batch statistics for the saved parameters; the training
            # state keeps its running averages
            state = {**state, **exact_stats(self.model, self.graph)}
            extra = {**extra, "bn_recalibrated": True}
        save_checkpoint(
            self.output_dir, name, state, model_config=self.model_config,
            normalizer=self.dataset.normalizer, epoch=epoch,
            val_loss=val_loss, train_config=self.config.to_dict(),
            extra=extra,
            train_state={"optimizer": self.optimizer.state_dict()})

    def save_history(self) -> Path:
        path = self.output_dir / "training_history.json"
        path.write_text(json.dumps(self.history, indent=2))
        return path
