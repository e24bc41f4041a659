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
  optimizer state that ``resume`` continues from: a snapshot in host
  memory, taken in the card's stream order, whose files a writer thread
  writes while the next epochs run (``checkpoint.CheckpointWriter``); the
  loops return, or raise, only once every queued write has ended;
* ``training_history.json`` in the reference schema and ``metrics.jsonl``;
* on ``KeyboardInterrupt`` (Ctrl-C, or SIGTERM raised as one): the last
  completed epoch saved as ``epoch_<N>`` with ``interrupted: True`` and the
  history written, then the interrupt re-raised, so ``resume`` continues;
* ``progress``: a live tqdm bar over the epochs, log lines routed through
  ``tqdm.write`` (the JAX trainer's ``--progress``).  The per-epoch loop
  shows each batch's loss, which costs one host synchronization a batch;
  the blocked loop advances the bar once a block.  Without tqdm it logs
  that and trains on (a display option only).

It trains on every backend (``pallas``, ``dense``, ``segment``; a
``pallas`` model on a mesh without a band takes the convs' dense
branches).  It runs on the card unless asked for the CPU, and has no
fallback: a CUDA tensor goes to the kernels or the step raises.

On the card the steps replay CUDA graphs (``train/graphs.py``), as the
JAX trainer always jits: the per-epoch loop replays the train step's graph
once a batch (one graph with the pressure freeze, one without, one per
batch size) and the eval step's once an epoch, and synchronizes the host
once an epoch; ``epoch_block > 1`` (the JAX trainer's device-resident
blocks) replays a graph of one whole epoch (``loop.epoch_body``) once an
epoch and synchronizes once a block.  The first call of each graph runs
eagerly (its warm-up) and the second captures it.  On the CPU the same
functions run eagerly.  Not ported: the JAX trainer's Mosaic compile
retries and dense-backend fallback (``kernels/fallback.py``: a TPU
workaround that would hide a kernel fault here) and its AOT executable
cache.  Dropout masks, kernel seeds and the blocks' snapshot
permutations come from one ``torch.Generator`` on the training device,
seeded from ``TrainConfig.seed``; parameters are initialized from a CPU
generator with the same seed.

The trainer's work is traced by ``utils/trace.py``: ``trainer.init``
(``trainer.model_init``, ``trainer.to_device``, ``trainer.optimizer``),
``trainer.run`` a ``_run_blocks`` call, ``trainer.block`` a block
(``trainer.enqueue`` with its device time, ``trainer.sync``,
``trainer.record``, its checkpoints), ``trainer.save_state`` and
``trainer.save`` (``checkpoint.exact_stats`` and the snapshot), and
``checkpoint.wait`` (for the checkpoint writer; at a run's end, its last
writes).  On the
card the blocked loop's log line gives each block's device ms an epoch and
its block end (from the synchronization to the block's last checkpoint);
``train()`` ends with one line of each span's count and mean and each
counter.
"""

from __future__ import annotations

import contextlib
import json
import signal
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models.factory import build_model
from ..models.flow_gnn import ModelConfig
from ..utils import trace
from .checkpoint import (
    CheckpointWriter,
    checkpoint_meta,
    latest_checkpoint,
    load_checkpoint,
    load_train_state,
)
from .data import FlowDataset
from .graphs import Graphed
from .loop import (
    FIELDS,
    ReduceLROnPlateau,
    TrainConfig,
    cosine_lr,
    epoch_batches,
    epoch_body,
    eval_step,
    init_epoch_block_carry,
    iterate_batches,
    load_optimizer_state,
    make_optimizer,
    train_step,
)
from .recal import exact_stats, resolve_bn_recal


def empty_history() -> dict:
    return {"epoch": [], "train_loss": [], "val_loss": [],
            "field_errors": {f: [] for f in FIELDS}, "learning_rate": []}


@contextlib.contextmanager
def _interrupt_after():
    """Hold a SIGINT that arrives inside the block until it ends, then
    raise it as ``KeyboardInterrupt``: an epoch of the blocked loop either
    runs whole or not at all (only the main thread receives signals)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    held = []
    previous = signal.signal(signal.SIGINT, lambda *_: held.append(1))
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, previous)
    if held:
        raise KeyboardInterrupt


class Trainer:
    def __init__(
        self,
        dataset: FlowDataset,
        model_config: ModelConfig,
        train_config: TrainConfig,
        output_dir: str | Path = "checkpoints",
        log_fn=print,
        device: str | torch.device = "cuda",
        progress: bool = False,
    ):
        with trace.span("trainer.init"):
            self.device = resolve_device(device)
            self.dataset = dataset
            self.model_config = model_config
            self.config = train_config
            self.output_dir = Path(output_dir)
            self.output_dir.mkdir(parents=True, exist_ok=True)
            self.log = log_fn
            self.progress = progress
            self._pbar = None

            with trace.span("trainer.model_init"):
                model = build_model(
                    model_config,
                    generator=torch.Generator().manual_seed(train_config.seed))
            with trace.span("trainer.to_device"):
                self.model = model.to(self.device)
                self.graph = dataset.graph.to(self.device)
                self.targets = torch.from_numpy(dataset.targets).to(
                    self.device)
                self.generator = torch.Generator(
                    device=self.device).manual_seed(train_config.seed)
            with trace.span("trainer.optimizer"):
                self.optimizer = make_optimizer(self.model, train_config)
            self.np_rng = np.random.default_rng(train_config.seed)
            self.bn_recal = resolve_bn_recal(train_config.bn_recal,
                                             model_config)
            self.history = empty_history()
            self.start_epoch = 1
            self.scheduler = ReduceLROnPlateau(
                train_config.lr, factor=train_config.plateau_factor,
                patience=train_config.plateau_patience,
                threshold=train_config.plateau_threshold,
                min_lr=train_config.plateau_min_lr)
            self.best_val = float("inf")
            # the step, eval and epoch graphs: one memory pool, the generator
            # registered with each
            self._pool = (torch.cuda.graph_pool_handle()
                          if self.device.type == "cuda" else None)
            self._graphs: dict = {}
            self.carry = None
            self._block_end = None
            self.checkpoints = CheckpointWriter(self.device)

    def _graphed(self, key, fn, zero_grad: bool = False) -> Graphed:
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = Graphed(
                fn, self.device, pool=self._pool,
                generators=(self.generator,),
                before_capture=(lambda: self.optimizer.zero_grad(
                    set_to_none=True)) if zero_grad else None)
        return g

    # ------------------------------------------------------------------ setup
    def initialize(self, resume: bool = False) -> None:
        if resume:
            name = latest_checkpoint(self.output_dir)
            if name is not None:
                state, meta = load_checkpoint(self.output_dir, name)
                self.model.load_state_dict(state)
                train_state = load_train_state(self.output_dir, name)
                load_optimizer_state(self.optimizer, train_state["optimizer"])
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

    def _open_pbar(self) -> None:
        """Start the epoch bar and route log lines through ``tqdm.write``,
        so they do not tear it."""
        if not self.progress:
            return
        try:
            from tqdm import tqdm
        except ImportError:
            self.log("tqdm not installed — --progress disabled")
            self.progress = False
            return
        self._pbar = tqdm(total=self.config.epochs,
                          initial=self.start_epoch - 1, desc="Training",
                          unit="epoch", dynamic_ncols=True)
        self._plain_log, self.log = self.log, tqdm.write

    def _close_pbar(self) -> None:
        if self._pbar is not None:
            self._pbar.close()
            self._pbar = None
            self.log = self._plain_log

    def _advance_pbar(self, epochs: int, train_loss: float, val_loss: float,
                      lr: float) -> None:
        if self._pbar is not None:
            self._pbar.set_postfix(train=f"{train_loss:.6f}",
                                   val=f"{val_loss:.6f}", lr=f"{lr:.1e}")
            self._pbar.update(epochs)

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
        yet; this trainer holds its model from construction).  In the
        blocked loop the epochs whose graphs were queued are recorded
        first, so the saved parameters are those of the epoch the name
        says."""
        since = trace.mark()
        try:
            history = self._train_loop()
        except KeyboardInterrupt:
            epoch = self.history["epoch"][-1] if self.history["epoch"] else 0
            val_loss = (self.history["val_loss"][-1] if epoch
                        else float("inf"))
            with self._writes_joined():
                self._save(f"epoch_{epoch}", epoch, val_loss, {
                    "best_val": self.best_val, "lr": self.scheduler.lr,
                    "sched_best": self.scheduler.best, "interrupted": True})
            self.save_history()
            self.log(f"Interrupted: checkpoint saved at epoch {epoch}")
            raise
        line = trace.summary(since)
        if line:
            self.log(f"Trace: {line}")
        return history

    def _train_loop(self) -> dict:
        cfg = self.config
        n = self.dataset.n_snapshots
        blocked = cfg.epoch_block > 1 and n % min(cfg.batch_size, n) == 0
        if cfg.epoch_block > 1 and not blocked:
            self.log(f"epoch_block={cfg.epoch_block} needs n_snapshots ({n}) "
                     f"divisible by batch_size ({cfg.batch_size}); falling "
                     "back to the per-epoch loop")
        self._open_pbar()
        try:
            if blocked:
                return self._train_loop_blocked()
            self._run_epochs()
        finally:
            self._close_pbar()
        self.save_history()
        return self.history

    def _step(self, freeze: bool, size: int) -> Graphed:
        """The train step on the batch ``targets[idx]`` (idx: ``size``
        device indices) at learning rate ``lr``: ``step(idx, lr)``."""
        def step(idx, lr):
            return train_step(self.model, self.optimizer, self.graph,
                              self.targets[idx], lr, self.config,
                              self.generator, freeze_pressure=freeze)
        return self._graphed(("step", freeze, size), step, zero_grad=True)

    def _eval(self) -> Graphed:
        def evaluate():
            loss, errors, _ = eval_step(self.model, self.graph, self.targets,
                                        self.config, recal=self.bn_recal)
            return torch.stack([loss, *(errors[f] for f in FIELDS)])
        return self._graphed("eval", evaluate)

    def _run_epochs(self) -> None:
        cfg = self.config
        n = self.dataset.n_snapshots
        lr = self.scheduler.lr
        with self._writes_joined():
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
                batches = iterate_batches(n, cfg.batch_size, self.np_rng)
                # the epoch's order on the device in one copy that does not
                # wait for the card (pinned memory); each batch a view
                order = torch.from_numpy(np.concatenate(batches))
                if self.device.type == "cuda":
                    order = order.pin_memory().to(self.device,
                                                  non_blocking=True)
                losses, start = [], 0
                for idx in batches:
                    step = self._step(freeze, len(idx))
                    # a replay's loss is overwritten by the next: keep a copy
                    losses.append(step(order[start:start + len(idx)],
                                       lr).clone())
                    start += len(idx)
                    if self._pbar is not None:
                        # the batch's loss: one host synchronization a batch
                        self._pbar.set_postfix(loss=f"{losses[-1].item():.6f}")
                vals = torch.cat([torch.stack(losses).mean().float()[None],
                                  self._eval()().float()]).tolist()
                train_loss, val_loss = vals[0], vals[1]
                errors = dict(zip(FIELDS, vals[2:]))
                if not np.isfinite(train_loss):
                    self.save_history()
                    raise FloatingPointError(
                        f"non-finite training loss at epoch {epoch} "
                        f"(loss={train_loss})")
                lr_used = lr
                if cfg.scheduler == "plateau":
                    lr = self.scheduler.step(val_loss)
                dt = time.perf_counter() - t0
                self._record(epoch, train_loss, val_loss, lr_used, errors, dt)
                self.log(f"Epoch {epoch}: train={train_loss:.6f} "
                         f"val={val_loss:.6f} lr={lr_used:.3e} ({dt:.2f}s)")
                self._advance_pbar(1, train_loss, val_loss, lr_used)

                extra = {"best_val": min(self.best_val, val_loss), "lr": lr,
                         "sched_best": self.scheduler.best}
                if val_loss < self.best_val:
                    self.best_val = val_loss
                    self._save("best", epoch, val_loss, extra)
                if epoch % cfg.save_every == 0:
                    self._save(f"epoch_{epoch}", epoch, val_loss, extra)

    def _record(self, epoch: int, train_loss: float, val_loss: float,
                lr: float, errors: dict, seconds: float) -> None:
        """One epoch's history and ``metrics.jsonl`` rows (field errors
        every 10 epochs)."""
        detailed = epoch % 10 == 0
        self.history["epoch"].append(epoch)
        self.history["train_loss"].append(train_loss)
        self.history["val_loss"].append(val_loss)
        self.history["learning_rate"].append(lr)
        for f in FIELDS:
            self.history["field_errors"][f].append(
                errors[f] if detailed else None)
        if detailed:
            self.log(f"Epoch {epoch} field errors: " + ", ".join(
                f"{f}={errors[f]:.6f}" for f in FIELDS))
        with open(self.output_dir / "metrics.jsonl", "a") as fh:
            fh.write(json.dumps({
                "epoch": epoch, "train_loss": train_loss,
                "val_loss": val_loss, "lr": lr, "epoch_seconds": seconds,
                **({f"err_{k}": errors[k] for k in FIELDS}
                   if detailed else {}),
            }) + "\n")

    # ---------------------------------------------------------- epoch blocks
    def _train_loop_blocked(self) -> dict:
        """Device-resident epoch loop: blocks of up to ``cfg.epoch_block``
        epochs, each epoch one call of ``loop.epoch_body`` (on the card a
        replay of its CUDA graph), the host synchronized once a block (the
        JAX trainer's ``_train_loop_blocked``).

        Blocks are cut at ``save_every`` multiples, at the curriculum
        boundary and at the last epoch, so periodic checkpoints and the
        freeze/LR-halving switch land on the same epochs as in the
        per-epoch loop; the plateau scheduler runs on the device (f32
        state).  Two deviations, the JAX package's: the snapshot order
        comes from the device generator instead of the host numpy stream,
        and a ``best`` checkpoint holds the best epoch's parameters and
        buffers with the block-end optimizer state (``resume`` normally
        continues from the latest ``epoch_N``, which is exact)."""
        cfg = self.config
        carry = self.carry = init_epoch_block_carry(
            self.model, self.scheduler.lr, cfg.epoch_block)
        # resume: the device scheduler starts from the host's state
        carry.sched.best.fill_(self.scheduler.best)
        carry.best_val.fill_(self.best_val)
        self._run_blocks(carry)
        self.save_history()
        return self.history

    def _epoch(self, freeze: bool) -> Graphed:
        """One epoch on ``self.carry``: one graph per carry, which its
        closure keeps alive (a graph reads its carry's memory)."""
        n_batches = epoch_batches(self.dataset.n_snapshots,
                                  self.config.batch_size)
        carry = self.carry

        def body():
            epoch_body(self.model, self.optimizer, self.graph, self.targets,
                       carry, self.config, n_batches, self.generator,
                       freeze=freeze, recal=self.bn_recal)
        return self._graphed(("epoch", freeze, id(carry)), body,
                             zero_grad=True)

    def _run_blocks(self, carry) -> None:
        cfg = self.config
        epoch = self.start_epoch
        with trace.span("trainer.run", counters=True), \
                self._writes_joined():
            while epoch <= cfg.epochs:
                if (cfg.curriculum_epochs > 0
                        and epoch == cfg.curriculum_epochs + 1):
                    new_lr = float(carry.sched.lr) * 0.5
                    carry.sched.lr.fill_(new_lr)
                    self.log(f"Curriculum phase 2: unfreezing pressure, "
                             f"lr → {new_lr:.3e}")
                freeze = (cfg.curriculum_epochs > 0
                          and epoch <= cfg.curriculum_epochs)
                # block end: epoch_block cap, save_every multiple, curriculum
                # boundary, final epoch — whichever comes first
                stop = min(epoch + cfg.epoch_block - 1,
                           ((epoch - 1) // cfg.save_every + 1)
                           * cfg.save_every, cfg.epochs)
                if freeze:
                    stop = min(stop, cfg.curriculum_epochs)
                with trace.span("trainer.block", counters=True, first=epoch,
                                last=stop):
                    self._run_block(carry, epoch, stop, freeze)
                epoch = stop + 1

    def _run_block(self, carry, epoch: int, stop: int,
                   freeze: bool) -> None:
        """Epochs ``epoch``..``stop``: queued, read, recorded, saved."""
        cfg = self.config
        k = stop - epoch + 1
        t0 = time.perf_counter()
        carry.epoch.fill_(epoch - 1)
        carry.slot.zero_()
        body = self._epoch(freeze)
        try:
            with trace.span("trainer.enqueue",
                            device=self.device.type == "cuda") as enqueued:
                for _ in range(k):
                    with _interrupt_after():
                        body()
        except KeyboardInterrupt:
            # the epochs queued before it ran whole: record them
            self._end_block(carry, epoch, int(carry.slot), t0)
            self._log_block(None)
            raise
        with _interrupt_after():
            extra = self._end_block(carry, epoch, k, t0)
            if stop % cfg.save_every == 0 or stop == cfg.epochs:
                self._save(f"epoch_{stop}", stop,
                           self.history["val_loss"][-1], extra)
            self._log_block(enqueued)

    def _log_block(self, enqueued) -> None:
        """The block's log line, at its end: with ``enqueued`` (the
        block's ``trainer.enqueue`` span, on the card) also the device ms
        an epoch and the block end's ms, from the synchronization on."""
        if self._block_end is None:
            return
        line, k, synced = self._block_end
        self._block_end = None
        device = trace.device_ms(enqueued)
        if device is not None and k:
            line += (f"; device {device / k:.2f} ms/epoch, block end "
                     f"{(time.perf_counter() - synced) * 1e3:.0f} ms")
        self.log(line + ")")

    def _end_block(self, carry, epoch: int, k: int, t0: float) -> dict:
        """Read the block's ``k`` epochs (one host synchronization), record
        them, take the scheduler state back to the host and save ``best``
        from the carry when the block improved on it.  Returns the resume
        fields a checkpoint of the block's end carries."""
        with trace.span("trainer.sync"):
            vals = torch.cat([
                carry.outs[:k].flatten(),
                torch.stack([carry.sched.lr, carry.sched.best, carry.best_val,
                             carry.best_epoch.float()]),
            ]).tolist()
        synced = time.perf_counter()
        dt = synced - t0
        rows = np.asarray(vals[:-4], np.float64).reshape(k, 3 + len(FIELDS))
        lr, best, block_best, best_epoch = vals[-4:]
        if not np.isfinite(rows[:, 0]).all():
            bad = epoch + int(np.argmax(~np.isfinite(rows[:, 0])))
            self.save_history()
            raise FloatingPointError(
                f"non-finite training loss at epoch {bad} "
                f"(block {epoch}..{epoch + k - 1})")
        with trace.span("trainer.record"):
            for j, row in enumerate(rows):
                self._record(epoch + j, float(row[0]), float(row[1]),
                             float(row[2]),
                             dict(zip(FIELDS, map(float, row[3:]))), dt / k)
            if k:
                # logged at the block's end (``_log_block``)
                self._block_end = (
                    f"Epochs {epoch}-{epoch + k - 1}: "
                    f"train={rows[-1, 0]:.6f} val={rows[-1, 1]:.6f} "
                    f"lr={rows[-1, 2]:.3e} "
                    f"({dt:.2f}s, {dt / k * 1e3:.0f} ms/epoch", k, synced)
                self._advance_pbar(k, *map(float, rows[-1, :3]))
        self.scheduler.lr, self.scheduler.best = lr, best
        extra = {"best_val": min(self.best_val, block_best),
                 "lr": self.scheduler.lr, "sched_best": self.scheduler.best}
        if block_best < self.best_val:
            self.best_val = block_best
            self._save_state("best", int(best_epoch), block_best, extra,
                             carry.best_state)
        return extra

    def _save_state(self, name: str, epoch: int, val_loss: float,
                    extra: dict, state: dict) -> None:
        """``_save`` of the parameters and buffers ``state``: copied into
        the model in place (the captured graphs keep reading its tensors)
        and back."""
        with trace.span("trainer.save_state", name=name):
            current = {k: v.clone()
                       for k, v in self.model.state_dict().items()}
            self.model.load_state_dict(state)
            try:
                self._save(name, epoch, val_loss, extra)
            finally:
                self.model.load_state_dict(current)

    def _save(self, name: str, epoch: int, val_loss: float,
              extra: dict) -> None:
        """Queue the checkpoint ``name`` of the model and optimizer as they
        are now (``self.checkpoints``: a snapshot in stream order, the
        files written on the writer's thread)."""
        with trace.span("trainer.save", counters=True, name=name):
            state = self.model.state_dict()
            if self.bn_recal:
                # exact batch statistics for the saved parameters; the
                # training state keeps its running averages
                with trace.span("checkpoint.exact_stats"):
                    state = {**state, **exact_stats(self.model, self.graph)}
                extra = {**extra, "bn_recalibrated": True}
            self.checkpoints.save(
                self.output_dir, name, state, checkpoint_meta(
                    model_config=self.model_config,
                    normalizer=self.dataset.normalizer, epoch=epoch,
                    val_loss=val_loss, train_config=self.config.to_dict(),
                    extra=extra),
                train_state={"optimizer": self.optimizer.state_dict()})

    @contextlib.contextmanager
    def _writes_joined(self):
        """Leave only once every checkpoint queued has been written; a
        failed write is raised here, or, while another exception leaves,
        at the next save or join."""
        try:
            yield
        except BaseException:
            self.checkpoints.wait(raise_failed=False)
            raise
        self.checkpoints.wait()

    def save_history(self) -> Path:
        path = self.output_dir / "training_history.json"
        path.write_text(json.dumps(self.history, indent=2))
        return path
