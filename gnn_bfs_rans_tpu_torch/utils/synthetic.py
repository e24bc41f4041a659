"""Synthetic structured-mesh graphs for scale benchmarking.

Counterpart of ``gnn_bfs_rans_tpu/utils/synthetic.py``.  The BFS-class
case (12k cells) is small for an H100; these generators build arbitrarily
large quad-grid "meshes" (the 4-neighbour topology of a 2D CFD mesh) to
measure the large-mesh regime.

Grid cells are numbered row-major with ``nx`` columns, so the adjacency is
already banded with bandwidth ``nx`` — ``nx < tile`` (default 96) gives
the 3-tile window; wider grids up to ``nx ≤ 2·tile`` use the 5-tile window
(see ``graph/band.py``) without reordering, and wider ones get no band.

``run_partition_shard_benchmark`` times one shard of a node-partitioned
mesh (``parallel/partition.py``) on one card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..graph.band import LAYER_COMPONENTS
from ..graph.build import attach_band
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
    return attach_band(graph, band_components, tile) if with_band else graph


def run_partition_shard_benchmark(
    global_nodes: int = 1_000_000,
    n_shards: int = 8,
    layer_type: str = "GAT",
    num_layers: int = 4,
    hidden_dim: int = 128,
    compute_dtype: str = "bfloat16",
    nx: int = 96,
    halo: int = 128,
    steps: int = 12,
    device: str | torch.device = "cuda",
) -> dict:
    """The banded forward of ONE shard of a partitioned mesh, on one card.

    The per-card throughput of partitioned training at scale: a shard of a
    ``global_nodes``-cell grid is ``global_nodes / n_shards`` owned rows
    plus ``2·halo`` halo rows, run by the same partitioned forward
    (``make_partitioned_forward``, a 1-shard partition carrying its band
    slices) as every rank runs; the per-layer halo exchange (2·halo rows
    of H features to each neighbour) is the part not measured.  Time: the
    chained marginal forward (``utils/bench.py``)."""
    from ..device import resolve_device
    from ..models.flow_gnn import FlowGNN, ModelConfig
    from ..parallel.partition import (build_partition,
                                      make_partitioned_forward,
                                      shard_partition)
    from .bench import chained_marginal_time

    dev = resolve_device(device)
    n_loc_target = max(global_nodes // n_shards, nx)
    ny = max(n_loc_target // nx, 1)
    graph = build_grid_graph(nx, ny, with_band=True,
                             band_components=LAYER_COMPONENTS[layer_type])
    if graph.band is None:
        raise ValueError(f"grid nx={nx} is not band-limited at tile=128")
    pg = build_partition(graph, 1, halo=halo)
    if not pg.has_band:
        raise ValueError("the partition carries no band slices")
    pg = shard_partition(pg, 0, dev)
    mcfg = ModelConfig(
        hidden_dim=hidden_dim, num_layers=num_layers, layer_type=layer_type,
        backend="pallas", dropout=0.0, compute_dtype=compute_dtype)
    model = FlowGNN(mcfg, generator=torch.Generator().manual_seed(0)).to(dev)
    # the chain captures the forward itself: its eager form
    fwd = make_partitioned_forward(model, halo=halo).eager
    step_s = chained_marginal_time(fwd, pg, reps=max(steps, 8)).step_s
    msgs = num_layers * graph.n_edges
    return {
        "metric": "edge_messages_per_sec_per_chip",
        "value": msgs / step_s,
        "unit": "msgs/s",
        "mode": "partitioned_shard_forward",
        "global_nodes": global_nodes,
        "n_shards": n_shards,
        "shard_nodes": graph.n_nodes,
        "n_edges": graph.n_edges,
        "halo": halo,
        "layer_type": layer_type,
        "backend": "pallas",
        "compute_dtype": compute_dtype,
        "hidden_dim": hidden_dim,
        "num_layers": num_layers,
        "step_median_s": step_s,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "timing": "chained_marginal",
    }


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
    the timing raises.  ``remat=True`` trains with each conv
    rematerialized (``models/flow_gnn.py``).
    """
    from ..device import resolve_device
    from ..models.flow_gnn import FlowGNN, ModelConfig
    from .bench import _check_finite, _train_chain, chained_marginal_time

    dev = resolve_device(device)
    mcfg = ModelConfig(
        hidden_dim=hidden_dim, num_layers=num_layers, layer_type=layer_type,
        backend=backend, dropout=0.0, compute_dtype=compute_dtype,
        remat=remat,
    )
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
