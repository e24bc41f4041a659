"""Streamed multi-case training and the geometry-generalization report.

Counterpart of ``gnn_bfs_rans_tpu/parallel/generalization.py``: the
streamed case loader (``train/streaming.py``) feeding the multi-case step
(``parallel/multicase.py``), and the report: train on a family of
perturbed geometries, then measure the error on held-out perturbations
never seen in training.  The synthetic family's targets are analytic
functions of the cell centres (:func:`analytic_targets`), so every
geometry has a ground truth.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

import numpy as np
import torch

from ..graph.structs import Graph
from ..models.flow_gnn import FlowGNN, ModelConfig
from ..train.loop import TrainConfig, make_optimizer
from ..train.streaming import Prefetcher, perturbed_case_source, stage
from .distributed import rank_of, world_size
from .multicase import (cell_order, gather_case_predictions, local_cases,
                        make_multicase_forward, make_multicase_train_step,
                        shard_cases)


def analytic_targets(cid: int, coords: np.ndarray) -> np.ndarray:
    """Smooth geometry-dependent fields [N, 7] (normalized scale):
    Ux = sin(2πx̂)cos(2πŷ), Uy = −cos(2πx̂)sin(2πŷ), p = cos(2πx̂)cos(2πŷ),
    k, ε, ν_t smooth and positive, all of the (perturbed) coordinates."""
    x, y = coords[:, 0], coords[:, 1]
    lo = np.array([x.min(), y.min()])
    span = np.array([max(x.max() - lo[0], 1e-9), max(y.max() - lo[1], 1e-9)])
    xh = (x - lo[0]) / span[0]
    yh = (y - lo[1]) / span[1]
    two_pi = 2 * np.pi
    out = np.zeros((coords.shape[0], 7), dtype=np.float32)
    out[:, 0] = np.sin(two_pi * xh) * np.cos(two_pi * yh)
    out[:, 1] = -np.cos(two_pi * xh) * np.sin(two_pi * yh)
    out[:, 2] = 0.0
    out[:, 3] = np.cos(two_pi * xh) * np.cos(two_pi * yh)
    out[:, 4] = 0.5 + 0.4 * np.sin(two_pi * xh) * np.sin(two_pi * yh)
    out[:, 5] = 0.5 + 0.4 * np.cos(two_pi * (xh + yh))
    out[:, 6] = 0.3 + 0.2 * np.sin(two_pi * (xh - yh))
    return out


def train_multicase_streamed(model: FlowGNN, tcfg: TrainConfig,
                             graph: Graph,
                             source_factory: Callable[[], Iterable],
                             epochs: int = 1, lr: float | None = None,
                             log_every: int = 0, prefetch_depth: int = 2,
                             group=None, timings: list | None = None
                             ) -> tuple[FlowGNN, list[dict]]:
    """Train ``model`` (on its device) over a streamed case source; returns
    ``(model, history)`` with the JAX history entries (epoch, loss,
    seconds).

    ``source_factory()`` returns a fresh iterator of CaseBatch chunks (each
    chunk's case count divisible by the world size), once an epoch; each
    chunk is one step.  A :class:`Prefetcher` stages this rank's block of
    the next chunks on a side stream while the step runs; on the card the
    step is a replay of the multi-case step's CUDA graph (one a chunk
    size: a short last chunk has its own), whose copy of the chunk into
    the capture runs on the consumer's stream after it has waited on the
    chunk's staging event.  Dropout draws
    from a generator seeded with ``tcfg.seed``.  ``timings``: a list that
    gets one entry an epoch: chunks, the steps' seconds (ending in a
    synchronize) and the consumer's wait on the prefetch queue."""
    dev = next(model.parameters()).device
    n_world, rank = world_size(group), rank_of(group)
    optimizer = make_optimizer(model, tcfg)
    step = make_multicase_train_step(model, optimizer, tcfg, group)
    generator = torch.Generator(device=dev).manual_seed(tcfg.seed)
    lr = tcfg.lr if lr is None else lr
    graph_dev = graph.to(dev)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    history = []
    n_steps = 0
    for epoch in range(epochs):
        pf = Prefetcher(source_factory(), dev, depth=prefetch_depth,
                        put=lambda b: stage(local_cases(b, n_world, rank),
                                            dev, side))
        losses = []
        step_s = 0.0
        t0 = time.time()
        for batch in pf:
            t1 = time.perf_counter()
            losses.append(step(graph_dev, batch, lr, generator))
            if timings is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_s += time.perf_counter() - t1
            n_steps += 1
            if log_every and n_steps % log_every == 0:
                print(f"step {n_steps}: loss={float(losses[-1]):.6f}",
                      flush=True)
        ep_loss = float(np.mean([float(v) for v in losses]))
        history.append({"epoch": epoch + 1, "loss": ep_loss,
                        "seconds": time.time() - t0})
        if timings is not None:
            timings.append({"chunks": len(losses), "step_s": step_s,
                            "prefetch_wait_s": pf.wait_s})
    return model, history


def run_geometry_generalization(
    base_graph: Graph,
    n_train_cases: int = 16,
    n_test_cases: int = 4,
    epochs: int = 30,
    amplitude: float = 0.05,
    model_cfg: ModelConfig | None = None,
    lr: float = 3e-3,
    seed: int = 0,
    device: str | torch.device = "cuda",
    group=None,
) -> dict:
    """Train on perturbed geometries of ``base_graph``, evaluate on held-out
    ones; the JAX result keys: per-field mean absolute errors on the
    training family and on held-out geometries, their ratio (≈ 1: the
    model interpolates across geometry rather than memorizing cases), the
    history, the case counts, the amplitude and the number of ranks
    (``devices``).  The model, a ``FlowGNN`` of ``model_cfg`` seeded 0,
    trains on ``device``."""
    n_dev = world_size(group)
    if n_train_cases % n_dev or n_test_cases % n_dev:
        raise ValueError("case counts must be divisible by the data axis size")
    mcfg = model_cfg or ModelConfig(
        hidden_dim=64, num_layers=3, layer_type="GCN", dropout=0.0,
        norm_type="layer", backend="dense",
    )
    model = FlowGNN(mcfg).to(device)
    tcfg = TrainConfig(lr=lr, seed=seed)

    def make_source():
        return perturbed_case_source(
            base_graph, n_train_cases, chunk=n_dev, amplitude=amplitude,
            seed=seed, targets_for=analytic_targets)

    model, history = train_multicase_streamed(
        model, tcfg, base_graph, make_source, epochs=epochs, lr=lr,
        group=group)

    dev = next(model.parameters()).device
    fwd = make_multicase_forward(model)
    graph_dev = base_graph.to(dev)

    def eval_family(seed_offset: int, n_cases: int) -> dict:
        batch = next(iter(perturbed_case_source(
            base_graph, n_cases, chunk=n_cases, amplitude=amplitude,
            seed=seed + seed_offset, targets_for=analytic_targets)))
        out = fwd(graph_dev, shard_cases(batch, device=dev))
        pred = gather_case_predictions(out, base_graph, group)
        true = cell_order(batch.targets, base_graph)
        mask = base_graph.node_mask.numpy()[: base_graph.n_nodes]
        errs = {}
        names = {"U": (0, 3), "p": (3, 4), "k": (4, 5),
                 "epsilon": (5, 6), "nut": (6, 7)}
        for name, (a, b) in names.items():
            diff = pred[:, mask, a:b] - true[:, mask, a:b]
            if name == "U":
                errs[name] = float(np.linalg.norm(diff, axis=-1).mean())
            else:
                errs[name] = float(np.abs(diff).mean())
        return errs

    # the training family: the seeds of the first training cases
    train_errs = eval_family(0, min(n_train_cases, max(n_dev, 4)))
    # held out: per-case streams seeded past every training case id
    test_errs = eval_family(n_train_cases, n_test_cases)
    gap = {k: (test_errs[k] / train_errs[k] if train_errs[k] > 0
               else float("inf")) for k in train_errs}
    return {
        "train_errors": train_errs,
        "heldout_errors": test_errs,
        "generalization_ratio": gap,
        "history": history,
        "n_train_cases": n_train_cases,
        "n_test_cases": n_test_cases,
        "amplitude": amplitude,
        "devices": int(n_dev),
    }
