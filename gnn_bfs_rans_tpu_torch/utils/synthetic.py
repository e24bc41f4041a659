"""Synthetic structured-mesh graphs for scale benchmarking.

Counterpart of ``gnn_bfs_rans_tpu/utils/synthetic.py``.  The BFS-class
case (12k cells) is small for an H100; these generators build arbitrarily
large quad-grid "meshes" (the 4-neighbour topology of a 2D CFD mesh) to
measure the large-mesh regime.

Grid cells are numbered row-major with ``nx`` columns, so the adjacency is
already banded with bandwidth ``nx`` — ``nx < tile`` (default 96) gives
the 3-tile window; wider grids up to ``nx ≤ 2·tile`` use the 5-tile window
(see ``graph/band.py``) without reordering, and wider ones get no band.

The JAX module's ``run_partition_shard_benchmark`` waits for the port of
``parallel/partition.py`` (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..graph.band import ALL_COMPONENTS, LAYER_COMPONENTS, build_band
from ..graph.structs import Graph, build_padded_graph


def build_grid_graph(
    nx: int, ny: int, with_band: bool = True, tile: int = 128,
    band_components: tuple[str, ...] | None = None,
) -> Graph:
    """A quad-grid graph of ``nx × ny`` cells with 4-neighbour adjacency
    (CPU tensors)."""
    n = nx * ny
    idx = np.arange(n).reshape(ny, nx)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()])
    up = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()])
    und = np.concatenate([right, up], axis=1)
    senders = np.concatenate([und[0], und[1]]).astype(np.int32)
    receivers = np.concatenate([und[1], und[0]]).astype(np.int32)

    xs = (np.arange(nx) + 0.5) / nx
    ys = (np.arange(ny) + 0.5) / ny
    coords = np.stack(
        [np.tile(xs, ny), np.repeat(ys, nx), np.zeros(n)], axis=1
    ).astype(np.float32)
    direction = coords[receivers] - coords[senders]
    dist = np.linalg.norm(direction, axis=1, keepdims=True)
    unit = direction / np.maximum(dist, 1e-12)
    edge_feat = np.concatenate([unit, dist], axis=1).astype(np.float32)

    graph = build_padded_graph(
        senders, receivers, edge_feat, coords,
        node_align=tile, edge_align=tile,
    )
    if with_band:
        comps = band_components or ALL_COMPONENTS
        ne = graph.n_edges
        band = build_band(
            graph.senders.numpy()[:ne],
            graph.receivers.numpy()[:ne],
            graph.n_pad,
            graph.node_mask.numpy(),
            graph.in_degree.numpy(),
            tile=tile,
            components=comps,
            edge_feat=(graph.edge_feat.numpy()[:ne]
                       if ("edge" in comps or "geo" in comps) else None),
            node_pos=graph.node_feat.numpy(),
        )
        if band is not None:
            graph = dataclasses.replace(graph, band=band)
    return graph


def run_scale_benchmark(
    n_nodes: int = 1_000_000,
    layer_type: str = "GAT",
    num_layers: int = 4,
    hidden_dim: int = 128,
    backend: str = "dense",
    compute_dtype: str = "float32",
    steps: int = 20,
    nx: int = 96,
    mode: str = "forward",
    remat: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Forward or full-train-step benchmark on a synthetic ~n_nodes grid.

    ``mode='train'`` runs the train step (forward + loss + backward + Adam,
    a CUDA graph on the card) on one all-zero snapshot; the parameters
    advance in place from step to step, and a parameter non-finite after
    the timing raises.  ``remat=True`` raises, as the
    port's training does (``train/loop.py::check_trainable``).
    """
    from ..device import resolve_device
    from ..models.flow_gnn import FlowGNN, ModelConfig
    from ..train.loop import check_trainable
    from .bench import _check_finite, _train_chain, chained_marginal_time

    dev = resolve_device(device)
    mcfg = ModelConfig(
        hidden_dim=hidden_dim, num_layers=num_layers, layer_type=layer_type,
        backend=backend, dropout=0.0, compute_dtype=compute_dtype,
        remat=remat,
    )
    check_trainable(mcfg)
    ny = max(n_nodes // nx, 1)
    graph = build_grid_graph(
        nx, ny, with_band=(backend == "pallas"),
        band_components=LAYER_COMPONENTS[layer_type],
    ).to(dev)
    model = FlowGNN(mcfg, generator=torch.Generator().manual_seed(0)).to(dev)

    if mode == "forward":
        model.eval()
        step_s = chained_marginal_time(model, graph,
                                       reps=max(steps, 8)).step_s
    else:
        targets = torch.zeros((1, graph.n_pad, 7), dtype=torch.float32,
                              device=dev)
        step, fence = _train_chain(
            model, graph, targets, torch.Generator(device=dev).manual_seed(1))

        def best(k, trials=3):
            for _ in range(k):
                step()
            fence()
            b = float("inf")
            for _ in range(trials):
                t = time.perf_counter()
                for _ in range(k):
                    step()
                fence()
                b = min(b, time.perf_counter() - t)
            return b

        base, reps = 2, max(steps, 8)
        step_s = max((best(reps) - best(base)) / (reps - base), 1e-9)
        _check_finite(model)

    msgs = num_layers * graph.n_edges
    return {
        "metric": "edge_messages_per_sec_per_chip",
        "value": msgs / step_s,
        "unit": "msgs/s",
        "mode": mode,
        "remat": remat,
        "n_nodes": graph.n_nodes,
        "n_edges": graph.n_edges,
        "layer_type": layer_type,
        "backend": backend,
        "compute_dtype": compute_dtype,
        "hidden_dim": hidden_dim,
        "num_layers": num_layers,
        "step_median_s": step_s,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
    }
