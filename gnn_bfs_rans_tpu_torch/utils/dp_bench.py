"""Data-parallel scaling efficiency: the DP step at 1 and N ranks.

Counterpart of ``gnn_bfs_rans_tpu/utils/dp_bench.py``.  Weak scaling, the
deployment regime: a fixed number of snapshots a rank, so N ranks train N×
the snapshots a step, and

    efficiency = T_step(1 rank) / T_step(N ranks)

(ideal 1.0; the gradient and loss all-reduces are the overhead measured).
One rank a card over NCCL (``parallel/distributed.py``); with
``device='cpu'``, gloo ranks on the host's cores, an overhead bound rather
than an interconnect measurement.  At one rank the efficiency is 1 by
construction.

Timing: the marginal step time from K chained steps ending in one fence
(``utils/bench.py::_marginal_time``'s form): ``(T(K) − T(base)) / (K −
base)``, best of ``trials``.  Each step updates the parameters the next
one reads, and on the card each is a replay of the DP step's CUDA graph
(``parallel/data_parallel.py``, over NCCL; ``timing: chained_replay``),
as the JAX harness times a jitted chain of steps; gloo ranks on the CPU
run eager steps (``timing: marginal_eager``).  Every rank runs the same
steps (they meet in the all-reduces); rank 0's times are reported, and a
collapsed delta is retried once at 4× the steps on every rank before it
raises, as the JAX harness does.
"""

from __future__ import annotations

import time

import torch

from ..device import resolve_device

BASELINE_EFFICIENCY = 0.90   # BASELINE.json: ≥ 90% from 1 to N


def time_dp_step(rank: int, world: int, case_path: str, model_cfg: dict,
                 snapshots_per_device: int, steps: int, device: str,
                 base: int = 2, trials: int = 3) -> dict:
    """Marginal seconds a DP step on this rank of a ``world``-rank group
    (inside ``distributed.launch``); returns the seconds, the graph's
    edge count and the timing's name."""
    from ..graph.band import LAYER_COMPONENTS
    from ..models.flow_gnn import FlowGNN, ModelConfig
    from ..parallel.data_parallel import (make_dp_train_step, replicate,
                                          shard_targets)
    from ..parallel.distributed import all_reduce_, rank_device
    from ..train.data import load_dataset
    from ..train.loop import TrainConfig, make_optimizer
    from .bench import _fetch_scalar

    dev = rank_device(rank, device)
    mcfg = ModelConfig.from_dict(model_cfg)
    dataset = load_dataset(case_path, with_band=mcfg.backend == "pallas",
                           band_components=LAYER_COMPONENTS[mcfg.layer_type])
    graph = dataset.graph.to(dev)
    model = replicate(FlowGNN(mcfg).to(dev))
    tcfg = TrainConfig()
    base_targets = dataset.targets
    idx = torch.arange(snapshots_per_device * world) % base_targets.shape[0]
    targets, weights = shard_targets(base_targets[idx.numpy()], world, rank,
                                     dev)
    step = make_dp_train_step(model, make_optimizer(model, tcfg), tcfg)
    timing = "chained_replay" if step.capture else "marginal_eager"
    lr = 1e-3

    def best_time(k: int) -> float:
        best = float("inf")
        for _ in range(trials + 1):        # the first run warms up
            t0 = time.perf_counter()
            for _ in range(k):
                step(graph, targets, weights, lr)
            _fetch_scalar(model.out_3.bias)
            best = min(best, time.perf_counter() - t0)
        return best

    reps = max(steps, base + 1)
    for widen in (1, 4):
        t_base, t_full = best_time(base), best_time(widen * reps)
        delta = torch.tensor(t_full - t_base, dtype=torch.float64)
        # every rank takes the same branch: the worst delta decides
        collapsed = all_reduce_(torch.tensor([float(delta <= 0)]).to(dev))
        if collapsed.item() == 0:
            return {"step_s": float(delta) / (widen * reps - base),
                    "n_edges": dataset.graph.n_edges, "timing": timing}
    raise RuntimeError(
        "DP bench resolution collapse: T(full) <= T(base) even at 4x reps "
        f"(base={base}, reps={reps})")


def run_dp_scaling_benchmark(
    n_devices: int | None = None,
    case_path: str = "OpenFOAM-data",
    layer_type: str = "GAT",
    num_layers: int = 4,
    hidden_dim: int = 64,
    backend: str = "dense",
    compute_dtype: str = "float32",
    snapshots_per_device: int = 4,
    steps: int = 16,
    device: str | torch.device = "cuda",
) -> dict:
    """Weak-scaling DP efficiency at 1 and ``n_devices`` ranks (default:
    every visible card; 1 on the CPU); a JSON-able dict with the JAX
    harness's keys."""
    from ..models.flow_gnn import ModelConfig
    from ..parallel.distributed import launch
    from ..parallel.ranks import dp_time_rank

    dev = resolve_device(device)
    avail = torch.cuda.device_count() if dev.type == "cuda" else None
    n = n_devices or (avail or 1)
    if avail is not None and n > avail:
        raise ValueError(f"--devices {n} but only {avail} card(s) visible")
    mcfg = ModelConfig(
        hidden_dim=hidden_dim, num_layers=num_layers, layer_type=layer_type,
        backend=backend, dropout=0.0, compute_dtype=compute_dtype)
    kw = dict(case_path=str(case_path), model_cfg=mcfg.to_dict(),
              snapshots_per_device=snapshots_per_device, steps=steps,
              device=dev.type)

    def timed(world: int) -> dict:
        return launch(dp_time_rank, world, (kw,), device=dev.type,
                      join_timeout_s=None)[0]

    one = timed(1)
    t1 = one["step_s"]
    tn = t1 if n == 1 else timed(n)["step_s"]
    efficiency = t1 / tn
    edge_messages = num_layers * one["n_edges"]
    if n == 1:
        note = "one rank: efficiency is 1 by construction"
    elif dev.type == "cpu":
        note = "gloo ranks on host cores: overhead bound, not a card measurement"
    else:
        note = "NCCL ranks, one card each"
    return {
        "metric": "dp_scaling_efficiency",
        "value": efficiency,
        "unit": "ratio (weak scaling, T1/TN, ideal 1.0)",
        "vs_baseline": efficiency / BASELINE_EFFICIENCY,
        "mode": "dp",
        "n_devices": n,
        "snapshots_per_device": snapshots_per_device,
        "step_s_1dev": t1,
        "step_s_ndev": tn,
        "global_snapshots_per_sec_ndev": snapshots_per_device * n / tn,
        "edge_messages_per_sec_global": edge_messages * n / tn,
        "layer_type": layer_type,
        "num_layers": num_layers,
        "hidden_dim": hidden_dim,
        "backend": backend,
        "compute_dtype": compute_dtype,
        "n_edges": one["n_edges"],
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu"),
        "note": note,
        "timing": one["timing"],
    }
