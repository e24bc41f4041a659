"""Training traffic: the ``Trainer``'s device-resident epoch loop.

The traffic file gives the mesh, the snapshot times (drifting analytic
fields), the batch size, ``epoch_block`` and ``save_every``.  Set-up
builds one ``Trainer`` on the program's graph of the mesh with the
benchmark's targets and weights, and drives it from the seed through its
first two epochs with the program's own blocked loop
(``Trainer._train_loop_blocked``): epoch 1 is the epoch graph's eager
warm-up, epoch 2 its capture and first replay.  Then one block, which it
times.  The window hands that same trainer as many more blocks as that
time says fill ``--seconds``, in one call of its loop
(``Trainer._run_blocks``: each block one replay of the epoch graph an
epoch, ending in the host's one synchronization and its history; the
checkpoints fall every ``save_every`` epochs and at the run's last
epoch, under ``TMPDIR``).  Blocks after the first two epochs start at
epoch ``epoch_block + 1``, so that every block is whole.

The program's readings for the check (``reference/train.py``): hooks
that read and change nothing take each training forward's prediction of
epoch 1 and the gradient Adam took at step 1 (its first moment ÷
(1 − β1)); after epoch 2, the first replay, set-up reads every
parameter's and running statistic's change, Adam's first moments and the
two epochs' training and eval losses as the trainer recorded them.  The
window's own work is read too: for which parameters its steps advanced
Adam's state (the first moment changed, the step count by the window's
steps).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import shutil
import time

import numpy as np
import torch

from gnn_bfs_rans_tpu_torch.kernels import _build
from gnn_bfs_rans_tpu_torch.train.data import FlowDataset
from gnn_bfs_rans_tpu_torch.train.normalization import FieldNormalizer
from gnn_bfs_rans_tpu_torch.train.trainer import Trainer

from ..core import program
from ..core.context import derive
from ..reference import graph as ref_graph
from ..reference import train as ref_train
from ..yardstick import meshes
from ..yardstick.weights import make_weights

BETA1 = 0.9


@dataclasses.dataclass
class State:
    trainer: Trainer | None
    mesh: meshes.Mesh
    targets: np.ndarray            # [S, n, 7] cell order
    weights: dict                  # the initial weights (CPU)
    readings: dict
    train_seed: int
    next_epoch: int
    n_nodes: int
    n_edges: int
    block_s: float = 0.0
    saves: list = dataclasses.field(default_factory=list)


def _readings_hooks(trainer: Trainer, n_rows: int, n_steps: int) -> tuple:
    """Epoch 1's ``n_steps`` training predictions and step 1's gradient."""
    model, opt = trainer.model, trainer.optimizer
    names = {id(p): k for k, p in model.named_parameters()}
    got: dict = {"outputs": [], "steps": 0}

    def on_forward(module, args, output):
        if module.training and len(got["outputs"]) < n_steps:
            got["outputs"].append(output[:n_rows].detach().float().cpu())

    def on_step(optimizer, args, kwargs):
        got["steps"] += 1
        if got["steps"] == 1:
            got["grad1"] = {
                names[id(p)]: optimizer.state[p]["exp_avg"].cpu()
                / (1 - BETA1)
                for g in optimizer.param_groups for p in g["params"]}

    return (model.register_forward_hook(on_forward),
            opt.register_step_post_hook(on_step)), got


def _state_readings(trainer: Trainer, w0: dict) -> dict:
    """The change of every parameter and running statistic, Adam's first
    moments and the recorded losses, after the epochs run so far."""
    state = trainer.model.state_dict()
    opt = trainer.optimizer
    return {
        "change": {k: float((state[k].float() - w0[k]).norm()) for k in w0},
        "moment": {k: float(opt.state[p]["exp_avg"].norm())
                   for k, p in trainer.model.named_parameters()
                   if "exp_avg" in opt.state.get(p, {})},
        "epoch_losses": list(trainer.history["train_loss"]),
        "val": list(trainer.history["val_loss"]),
    }


def setup(ctx) -> State:
    cfg, traffic = ctx.config, ctx.traffic
    t0 = time.perf_counter()
    if torch.device(ctx.device).type == "cuda":
        _build.build_all()
    ctx.setup_phases["build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mesh = meshes.make_mesh(traffic["mesh"])
    snaps = [meshes.drifting_fields(mesh.centers, float(t))
             for t in traffic["snapshot_times"]]
    targets = meshes.normalized_targets(snaps)
    graph = program.program_graph(mesh, cfg["layer_type"])
    dataset = FlowDataset(
        graph=graph, targets=program.to_rows(targets, graph),
        raw_fields=snaps,
        time_dirs=[str(t) for t in traffic["snapshot_times"]],
        normalizer=FieldNormalizer().fit({
            k: np.concatenate([s[k] for s in snaps]) for k in snaps[0]}),
        mesh=None, case_path=f"synthetic:{ctx.workload['traffic']}")
    ctx.setup_phases["data_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    train_seed = derive(ctx.seed, "train")
    out_dir = ctx.out_dir / "checkpoints"
    shutil.rmtree(out_dir, ignore_errors=True)
    trainer = Trainer(dataset, program.model_config(cfg),
                      program.train_config(cfg, traffic, train_seed),
                      output_dir=out_dir, log_fn=lambda *a, **k: None,
                      device=ctx.device)
    weights = make_weights(cfg, derive(ctx.seed, "weights"), ctx.device)
    trainer.model.load_state_dict(weights, strict=True)
    trainer.initialize()
    ctx.setup_phases["model_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    steps = -(-len(traffic["snapshot_times"]) // traffic["batch_size"])
    hooks, got = _readings_hooks(trainer, graph.n_nodes, steps)
    # epochs 1 (eager) and 2 (captured, replayed) through the trainer's
    # own blocked loop: a run of two epochs
    trainer.config = dataclasses.replace(trainer.config,
                                         epochs=ref_train.EPOCHS)
    trainer._train_loop_blocked()
    for h in hooks:
        h.remove()
    got.update(_state_readings(trainer, weights))
    block = traffic["epoch_block"]
    state = State(trainer=trainer, mesh=mesh, targets=targets,
                  weights={k: v.cpu() for k, v in weights.items()},
                  readings=got, train_seed=train_seed,
                  next_epoch=block + 1, n_nodes=graph.n_nodes,
                  n_edges=graph.n_edges)
    _wrap(ctx, trainer, state)
    t1 = time.perf_counter()
    run_blocks(state, 1)
    state.block_s = time.perf_counter() - t1
    ctx.setup_phases["warmup_s"] = time.perf_counter() - t0
    return state


def _adam_on_host(trainer: Trainer) -> dict:
    """Each parameter's Adam first moment and step count."""
    opt = trainer.optimizer
    return {k: (opt.state[p]["exp_avg"].to("cpu", copy=True),
                float(opt.state[p]["step"]))
            for k, p in trainer.model.named_parameters()
            if "exp_avg" in opt.state.get(p, {})}


def _wrap(ctx, trainer: Trainer, state: State) -> None:
    """The benchmark's spans around the trainer's block end and saves,
    and each save's checkpoint name."""
    inner_end, inner_save = trainer._end_block, trainer._save

    def end_block(*a, **k):
        with ctx.tracer.span("end_block"):
            return inner_end(*a, **k)

    def save(*a, **k):
        state.saves.append(a[0])
        with ctx.tracer.span("save"):
            return inner_save(*a, **k)

    trainer._end_block, trainer._save = end_block, save


def run_blocks(state: State, n: int) -> None:
    """``n`` blocks in one call of ``Trainer._run_blocks``: a run whose last
    epoch is the last block's."""
    tr = state.trainer
    block = tr.config.epoch_block
    tr.start_epoch = state.next_epoch
    tr.config = dataclasses.replace(
        tr.config, epochs=state.next_epoch + n * block - 1)
    tr._run_blocks(tr.carry)
    state.next_epoch += n * block


def window(ctx, state: State) -> dict:
    traffic = ctx.traffic
    block = traffic["epoch_block"]
    cells = block * len(traffic["snapshot_times"]) * state.n_nodes
    limit = ctx.seconds if not ctx.trace else traffic["trace_seconds"]
    n = max(1, math.ceil(limit / state.block_s))
    steps_per_epoch = -(-len(traffic["snapshot_times"])
                        // traffic["batch_size"])
    before = _adam_on_host(state.trainer)
    lr0 = state.trainer.scheduler.lr
    state.saves.clear()
    with ctx.tracer.window(ctx.device):
        t_start = time.perf_counter()
        with ctx.tracer.span("blocks"):
            run_blocks(state, n)
        t_end = time.perf_counter()
    # the optimizer's state, not the parameters: the plateau scheduler
    # may bring the learning rate to 0 within the window
    after = _adam_on_host(state.trainer)
    steps = block * n * steps_per_epoch
    state.readings["stepped"] = {
        k: k in before and bool((m != before[k][0]).any())
        and t - before[k][1] == steps for k, (m, t) in after.items()}
    ctx.log(f"window saved {state.saves.count('best')} best and "
            f"{len(state.saves) - state.saves.count('best')} epoch "
            f"checkpoints in {n} blocks, learning rate {lr0!r} → "
            f"{state.trainer.scheduler.lr!r}")
    return {"kind": "train", "blocks": n, "cells": n * cells,
            "seconds": t_end - t_start, "epochs": block * n,
            "steps": block * n * steps_per_epoch,
            "attempted": n, "failed": 0}


def release(state: State) -> None:
    out_dir = state.trainer.output_dir
    state.trainer = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)


def check(ctx, state: State, quant: str = "f32") -> dict[str, float]:
    """The numbers compared (see ``reference/train.py``); another
    ``quant`` than ``'f32'`` puts the reference computed in that precision
    in the program's place (the control: ``reference/model.py``)."""
    cfg = ctx.config
    dev = torch.device(ctx.device)
    g = ref_graph.build(state.mesh).to(dev)
    targets = torch.from_numpy(state.targets[:, g.order]).to(dev)
    weights = {k: v.to(dev) for k, v in state.weights.items()}
    tcfg = cfg["train"]
    eval_mode = "exact" if _recal(cfg) else "eval"
    ref = ref_train.reference_steps(cfg, tcfg, g, g.coords, targets, weights,
                                    state.train_seed, eval_mode=eval_mode)
    if quant == "f32":
        prog = state.readings
    else:
        prog = ref_train.reference_steps(cfg, tcfg, g, g.coords, targets,
                                         weights, state.train_seed,
                                         quant=quant, eval_mode=eval_mode)
    prog = dict(prog, outputs=[o.to(dev) for o in prog["outputs"]])
    worst = ref_train.worst_leaves(prog, ref)
    ctx.log("worst leaves " + " ".join(f"{k} {v[1]} {v[0]!r}"
                                       for k, v in worst.items()))
    return ref_train.judge(prog, ref, targets, tcfg["pressure_ref_weight"])


def _recal(cfg: dict) -> bool:
    mode = cfg["train"].get("bn_recal", "auto")
    if mode == "auto":
        return cfg["compute_dtype"] in ("bfloat16", "mixed")
    return mode == "on"
