"""Training step, eval step, LR schedules, batching and the epoch block.

Counterpart of ``gnn_bfs_rans_tpu/train/loop.py``:

* ``train_step`` — forward (training mode: in-kernel dropout, batch
  statistics), field-wise weighted loss averaged over the batch's targets,
  backward, curriculum pressure-freeze mask, global-norm clip, then
  ``torch.optim.Adam`` with L2 weight decay — optax's clip →
  ``add_decayed_weights`` → ``scale_by_adam(eps=1e-8)`` chain
  (``loop.py:105-111``);
* ``eval_step`` — loss and per-field errors through the eval forward, or
  through the exact-batch-statistics forward when BN recalibration is on;
* ``ReduceLROnPlateau`` (torch's, mode 'min', rel threshold), its device
  form ``plateau_update``, the cosine schedule, ``iterate_batches``;
* ``epoch_body`` — one whole epoch on the device (shuffled batches → train
  steps → eval → plateau scheduler → best-epoch tracking), the body of the
  JAX package's ``make_epoch_block`` scan (``loop.py:374-476``), on an
  :class:`EpochBlockCarry` updated in place.

On the card the trainer replays these as CUDA graphs (``train/graphs.py``,
the counterpart of ``jax.jit``), so the optimizer is ``capturable`` there,
with its learning rate a device tensor that ``train_step`` writes in place
(a float assigned to the group would be frozen into the graph); on the CPU
the same functions run eagerly.

The pressure freeze masks the gradient of ``out_3``'s pressure column
(weight row 3 and bias 3) and also its update: the JAX package masks the
post-optimizer update too (``loop.py:180-188``), because the L2 term added
inside the chain would otherwise move the frozen column.  Adam cannot mask
its own update, so the column is saved before ``step()`` and restored
after; the moments then evolve exactly as optax's do
(:func:`apply_update`, which the data-parallel, multi-case and
partitioned steps of ``parallel/`` share).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..graph.structs import Graph
from ..models.flow_gnn import FlowGNN
from .metrics import compute_field_errors
from .normalization import weighted_fieldwise_mse


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig`` fields (defaults mirror the
    reference's ``train.py:283-298``), so its meta files parse."""

    lr: float = 3e-4
    weight_decay: float = 1e-5
    grad_clip: float = 1.0
    epochs: int = 100
    batch_size: int = 1
    pressure_ref_weight: float = 0.1
    curriculum_epochs: int = 0
    save_every: int = 10
    seed: int = 0
    plateau_factor: float = 0.5
    plateau_patience: int = 10
    plateau_threshold: float = 1e-4
    plateau_min_lr: float = 0.0
    scheduler: str = "plateau"
    rng_impl: str = "auto"
    bn_recal: str = "auto"
    epoch_block: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def make_optimizer(model: FlowGNN, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with L2 weight decay folded into the gradient (torch's
    ``weight_decay``, optax's ``add_decayed_weights`` before
    ``scale_by_adam``).  On the card it is ``capturable``, its learning
    rate a 0-d f32 tensor there, so a CUDA graph can replay its step, and
    ``fused`` (one multi-tensor kernel where the capturable ``foreach``
    form launches a dozen); the CPU has no capturable Adam."""
    dev = next(model.parameters()).device
    card = dev.type == "cuda"
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=dev) if card \
        else cfg.lr
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay,
                            capturable=card, fused=card or None)


def set_lr(optimizer: torch.optim.Optimizer, lr) -> None:
    """Set every group's learning rate to ``lr`` (a float or a 0-d
    tensor): written in place into a tensor learning rate, so that a
    captured step reads the value of its replay."""
    for group in optimizer.param_groups:
        cur = group["lr"]
        if isinstance(cur, torch.Tensor):
            if lr is not cur:
                (cur.copy_ if isinstance(lr, torch.Tensor) else cur.fill_)(lr)
        else:
            group["lr"] = float(lr)


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state: dict) -> None:
    """Load an optimizer state saved on either device into ``optimizer``,
    keeping its own implementation flags (``capturable``, ``fused``,
    ``foreach``) and learning-rate tensor (which a captured step reads):
    ``load_state_dict`` takes them from the saved groups.  Load before any
    capture: the state tensors are replaced."""
    flags = ("capturable", "fused", "foreach")
    keep = [({k: g[k] for k in flags}, g["lr"])
            for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, (own, lr) in zip(optimizer.param_groups, keep):
        saved = float(group["lr"])
        group.update(own)
        capturable = own["capturable"]
        if isinstance(lr, torch.Tensor):
            lr.fill_(saved)
            group["lr"] = lr
        else:
            group["lr"] = saved
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(
                    device=p.device if capturable else "cpu",
                    dtype=torch.float32)


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: g ← g / (‖g‖/max_norm) when the global
    norm exceeds ``max_norm``; no host synchronization.  Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    div = torch.where(norm < max_norm, torch.ones_like(norm), norm / max_norm)
    torch._foreach_div_(grads, div)
    return norm


def _pressure_column(model: FlowGNN):
    """The head's pressure output (``out_3`` in a FlowGNN): weight row 3
    and bias element 3 (the flax kernel's column 3)."""
    return ((model.head.weight, (3, slice(None))),
            (model.head.bias, (3,)))


def batch_loss(out: torch.Tensor, targets: torch.Tensor, graph: Graph,
               cfg: TrainConfig) -> torch.Tensor:
    """Mean over the batch's targets [B, N_pad, 7] of the weighted loss."""
    return torch.stack([
        weighted_fieldwise_mse(out, t, graph.node_mask,
                               pressure_ref_weight=cfg.pressure_ref_weight)
        for t in targets]).mean()


def apply_update(model: FlowGNN, optimizer: torch.optim.Optimizer, lr,
                 cfg: TrainConfig, freeze_pressure: bool = False) -> None:
    """The update from the gradients in ``p.grad``: the pressure freeze,
    the global-norm clip, then Adam at ``lr`` (the JAX steps' order)."""
    frozen = []
    if freeze_pressure:
        for p, idx in _pressure_column(model):
            p.grad[idx].zero_()
            frozen.append((p, idx, p.detach()[idx].clone()))
    clip_by_global_norm_(model.parameters(), cfg.grad_clip)
    set_lr(optimizer, lr)
    optimizer.step()
    with torch.no_grad():
        for p, idx, saved in frozen:
            p[idx] = saved


def train_step(model: FlowGNN, optimizer: torch.optim.Optimizer,
               graph: Graph, targets: torch.Tensor, lr,
               cfg: TrainConfig, generator: torch.Generator | None = None,
               freeze_pressure: bool = False) -> torch.Tensor:
    """One optimizer step on a batch of snapshots; returns the loss (a
    device scalar: no host synchronization).  ``lr``: a float or a 0-d
    tensor (:func:`set_lr`).  Dropout masks and kernel seeds come from
    ``generator`` (None: deterministic).  The step captures into a CUDA
    graph (``train/graphs.py``), ``freeze_pressure`` being part of what is
    captured, as the JAX step's static argument."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(graph, train=True, generator=generator)
    loss = batch_loss(out, targets, graph, cfg)
    loss.backward()
    apply_update(model, optimizer, lr, cfg, freeze_pressure)
    return loss.detach()


@torch.no_grad()
def eval_step(model: FlowGNN, graph: Graph, targets: torch.Tensor,
              cfg: TrainConfig, recal: bool = False):
    """(loss, per-field errors averaged over snapshots, prediction).

    ``recal``: the deterministic train-mode forward — BatchNorm normalizes
    with the exact batch statistics of the current parameters (the loss an
    eval-mode forward reports after BN re-estimation), and the running
    statistics are left as they are."""
    model.eval()
    out = model(graph, exact_bn=recal)
    loss = batch_loss(out, targets, graph, cfg)
    per = [compute_field_errors(out, t, graph.node_mask) for t in targets]
    errors = {k: torch.stack([e[k] for e in per]).mean() for k in per[0]}
    return loss, errors, out


def cosine_lr(cfg: TrainConfig, epoch: int) -> float:
    """The cosine schedule of the JAX trainer (1-based epoch)."""
    return cfg.plateau_min_lr + 0.5 * (cfg.lr - cfg.plateau_min_lr) * (
        1 + math.cos(math.pi * (epoch - 1) / max(cfg.epochs - 1, 1)))


class ReduceLROnPlateau:
    """Host-side re-implementation of torch's plateau scheduler
    (mode='min', threshold_mode='rel'), factor/patience from the
    reference (``train.py:374-376``)."""

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


def iterate_batches(n_samples: int, batch_size: int,
                    rng: np.random.Generator) -> list[np.ndarray]:
    """Shuffled batch index lists (drop nothing; last batch may be short)."""
    order = rng.permutation(n_samples)
    return [order[i:i + batch_size] for i in range(0, n_samples, batch_size)]


FIELDS = ("U", "p", "k", "epsilon", "nut")


@dataclasses.dataclass
class PlateauState:
    """Device ReduceLROnPlateau state (see :func:`plateau_update`)."""

    lr: torch.Tensor       # f32 scalar
    best: torch.Tensor     # f32 scalar
    num_bad: torch.Tensor  # int32 scalar


def plateau_init(lr: float, device="cpu") -> PlateauState:
    return PlateauState(
        lr=torch.tensor(lr, dtype=torch.float32, device=device),
        best=torch.tensor(float("inf"), dtype=torch.float32, device=device),
        num_bad=torch.zeros((), dtype=torch.int32, device=device))


def plateau_update(s: PlateauState, metric: torch.Tensor,
                   cfg: TrainConfig) -> PlateauState:
    """torch's ``ReduceLROnPlateau`` step (mode 'min', rel threshold) on
    device tensors: the state machine of :class:`ReduceLROnPlateau` in f32,
    with no host synchronization (the JAX ``plateau_update``)."""
    metric = metric.float()
    improved = metric < s.best * (1.0 - cfg.plateau_threshold)
    num_bad = torch.where(improved, 0, s.num_bad + 1)
    reduce = num_bad > cfg.plateau_patience
    lr = torch.where(reduce, torch.clamp_min(s.lr * cfg.plateau_factor,
                                             cfg.plateau_min_lr), s.lr)
    return PlateauState(lr=lr, best=torch.where(improved, metric, s.best),
                        num_bad=torch.where(reduce, 0, num_bad))


@dataclasses.dataclass
class EpochBlockCarry:
    """What the epoch body carries beside the model and optimizer, which
    it updates in place: the plateau state, the best epoch's parameters
    and buffers (``best_state``, state-dict keys), its val loss and
    number, the number of the epoch last run (``epoch``), and the block's
    outputs: row ``slot`` of ``outs`` [K, 8] holds train loss, val loss,
    lr and the five field errors of the block's epoch ``slot``.  Every
    tensor is made before any capture and written in place, so a replayed
    body reads and writes the same memory."""

    sched: PlateauState
    best_state: dict
    best_val: torch.Tensor    # f32
    best_epoch: torch.Tensor  # int32
    epoch: torch.Tensor       # int32
    slot: torch.Tensor        # int64 [1]
    outs: torch.Tensor        # f32 [K, 8]


def init_epoch_block_carry(model: FlowGNN, lr: float,
                           block: int) -> EpochBlockCarry:
    """A carry on the model's device for blocks of up to ``block``
    epochs."""
    dev = next(model.parameters()).device
    return EpochBlockCarry(
        sched=plateau_init(lr, dev),
        best_state={k: v.detach().clone()
                    for k, v in model.state_dict().items()},
        best_val=torch.tensor(float("inf"), dtype=torch.float32, device=dev),
        best_epoch=torch.zeros((), dtype=torch.int32, device=dev),
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
        slot=torch.zeros(1, dtype=torch.int64, device=dev),
        outs=torch.zeros(block, 3 + len(FIELDS), dtype=torch.float32,
                         device=dev))


def epoch_batches(n_snapshots: int, batch_size: int) -> int:
    """The number of equal batches an epoch block splits the snapshots
    into (the JAX block's static batch shape); raises when they do not
    split evenly."""
    bsz = min(batch_size, n_snapshots)
    if n_snapshots % bsz:
        raise ValueError(
            f"epoch block needs n_snapshots ({n_snapshots}) divisible by "
            f"batch_size ({bsz}); fall back to epoch_block=1")
    return n_snapshots // bsz


@torch.no_grad()
def _track_best(model: FlowGNN, carry: EpochBlockCarry,
                val_loss: torch.Tensor, epoch: torch.Tensor) -> None:
    improved = val_loss < carry.best_val
    for name, t in model.state_dict().items():
        best = carry.best_state[name]
        torch.where(improved, t, best, out=best)
    carry.best_val.copy_(torch.where(improved, val_loss.float(),
                                     carry.best_val))
    carry.best_epoch.copy_(torch.where(improved, epoch, carry.best_epoch))


def epoch_body(model: FlowGNN, optimizer: torch.optim.Optimizer,
               graph: Graph, targets: torch.Tensor, carry: EpochBlockCarry,
               cfg: TrainConfig, n_batches: int,
               generator: torch.Generator | None = None,
               freeze: bool = False, recal: bool = False) -> None:
    """One epoch on the device, the JAX ``make_epoch_block``'s scan body:
    the epoch counter advanced; the lr (cosine from that counter, else the
    plateau state's); the snapshots in ``n_batches`` equal batches (in
    order for one batch, else a permutation drawn from ``generator``),
    one train step each; the eval step (exact batch statistics with
    ``recal``); ``plateau_update``; the best epoch tracked; the epoch's row
    written at ``carry.slot``, which advances.  No host synchronization,
    so the whole body captures into one CUDA graph, replayed once an
    epoch."""
    dev = targets.device
    carry.epoch.add_(1)
    epoch = carry.epoch
    if cfg.scheduler == "cosine":
        frac = (epoch - 1).float() / max(cfg.epochs - 1, 1)
        lr = cfg.plateau_min_lr + 0.5 * (cfg.lr - cfg.plateau_min_lr) * (
            1.0 + torch.cos(math.pi * frac))
    else:
        lr = carry.sched.lr.clone()
    n = targets.shape[0]
    if n_batches > 1:
        order = torch.rand(n, generator=generator, device=dev).argsort()
    else:
        order = torch.arange(n, device=dev)
    losses = [train_step(model, optimizer, graph, targets[idx], lr, cfg,
                         generator, freeze_pressure=freeze)
              for idx in order.view(n_batches, n // n_batches)]
    train_loss = torch.stack(losses).mean()
    val_loss, errors, _ = eval_step(model, graph, targets, cfg, recal=recal)
    new = plateau_update(carry.sched, val_loss, cfg)
    for name in ("lr", "best", "num_bad"):
        getattr(carry.sched, name).copy_(getattr(new, name))
    _track_best(model, carry, val_loss, epoch)
    row = torch.stack([train_loss.float(), val_loss.float(), lr.float(),
                       *(errors[f].float() for f in FIELDS)])
    carry.outs.index_copy_(0, carry.slot, row[None])
    carry.slot.add_(1)
