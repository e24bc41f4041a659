"""Rank functions for ``distributed.launch``: what each rank of a group
runs, as module-level functions that spawned ranks can unpickle.

* :func:`run_jobs` runs a list of ``(name, payload)`` jobs on one rank and
  returns their results as numpy (the same on every rank where the job
  gathers): ``halo`` (:func:`models.partitioned.halo_exchange` forward and
  backward), ``partitioned_forward``, ``partitioned_step``, ``dp_step``
  and ``multicase_step`` (one step of each scale-out path from the given
  weights, and whether it ran as a CUDA graph; the multi-case forward's
  gathered predictions before it).  The CPU
  tests and ``chip_smoke.py`` hold these against the JAX package and the
  single-rank paths.
* :func:`train_multicase_rank`: one rank of CLI ``train-multicase``.
* :func:`dp_time_rank`: one rank of ``bench --mode dp``
  (``utils/dp_bench.py``).

Payload weights are state dicts of numpy arrays; configs are dicts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.flow_gnn import FlowGNN, ModelConfig
from ..train.loop import TrainConfig, make_optimizer
from .distributed import rank_device


def _model(payload: dict, device, cls=FlowGNN):
    model = cls(ModelConfig.from_dict(payload["config"]))
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in payload["state"].items()})
    return model.to(device)


def _state(model) -> dict:
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


def _stepped(model, step, *args) -> dict:
    """One call of ``step``: its loss, the state after it, the gradients
    it applied (after the clip) and whether it runs as a CUDA graph."""
    loss = step(*args)
    return {"loss": float(loss), "state": _state(model),
            "grads": {k: p.grad.float().cpu().numpy()
                      for k, p in model.named_parameters()},
            "captured": step.capture}


def _halo(rank, world, device, p):
    from ..models.partitioned import halo_exchange

    x = torch.from_numpy(p["x"][rank]).to(device).requires_grad_(True)
    y = halo_exchange(x, p["halo"])
    y.backward(torch.from_numpy(p["g"][rank]).to(device))
    return {"y": y.detach().cpu().numpy(), "dx": x.grad.cpu().numpy()}


def _partitioned_forward(rank, world, device, p):
    from .partition import (build_partition, gather_partitioned,
                            make_partitioned_forward, shard_partition)

    pg = shard_partition(build_partition(p["graph"], world, p["halo"]),
                         rank, device)
    out = make_partitioned_forward(_model(p, device), p["halo"])(pg)
    return {"out": gather_partitioned(out, pg), "has_band": pg.has_band}


def _partitioned_step(rank, world, device, p):
    from ..models.partitioned import PartitionedFlowGNN
    from .partition import (build_partition, make_partitioned_train_step,
                            shard_partition, shard_partitioned_targets)

    pg = build_partition(p["graph"], world, p["halo"])
    targets = shard_partitioned_targets(p["targets"], pg, rank, device)
    pg = shard_partition(pg, rank, device)
    model = _model(p, device, PartitionedFlowGNN)
    tcfg = TrainConfig.from_dict(p["train"])
    step = make_partitioned_train_step(model, make_optimizer(model, tcfg),
                                       tcfg, p["halo"])
    return _stepped(model, step, pg, targets, p["lr"])


def _dp_step(rank, world, device, p):
    from .data_parallel import make_dp_train_step, shard_targets

    model = _model(p, device)
    tcfg = TrainConfig.from_dict(p["train"])
    targets, weights = shard_targets(p["targets"], world, rank, device)
    step = make_dp_train_step(model, make_optimizer(model, tcfg), tcfg)
    return _stepped(model, step, p["graph"].to(device), targets, weights,
                    p["lr"])


def _multicase_step(rank, world, device, p):
    from .multicase import (gather_case_predictions, make_multicase_forward,
                            make_multicase_train_step, shard_cases)

    model = _model(p, device)
    tcfg = TrainConfig.from_dict(p["train"])
    graph = p["graph"].to(device)
    batch = shard_cases(p["batch"], world, rank, device)
    pred = gather_case_predictions(make_multicase_forward(model)(graph, batch),
                                   graph)
    step = make_multicase_train_step(model, make_optimizer(model, tcfg), tcfg)
    return {**_stepped(model, step, graph, batch, p["lr"]), "pred": pred}


JOBS = {"halo": _halo, "partitioned_forward": _partitioned_forward,
        "partitioned_step": _partitioned_step, "dp_step": _dp_step,
        "multicase_step": _multicase_step}


def run_jobs(rank: int, world: int, jobs: list, device: str = "cpu"
             ) -> list[dict]:
    """Each ``(name, payload)`` of ``jobs`` on this rank, in order."""
    dev = rank_device(rank, device)
    return [JOBS[name](rank, world, dev, payload) for name, payload in jobs]


def train_multicase_rank(rank: int, world: int, args: dict) -> dict | None:
    """One rank of ``train-multicase`` (``cli/main.py``); rank 0 returns
    what the CLI writes."""
    from ..foam.reader import FoamCase
    from ..graph.band import LAYER_COMPONENTS
    from ..graph.build import attach_band, build_graph
    from .generalization import (run_geometry_generalization,
                                 train_multicase_streamed)

    dev = rank_device(rank, args["device"])
    mcfg = ModelConfig(
        hidden_dim=args["hidden_dim"], num_layers=args["num_layers"],
        layer_type=args["layer_type"], dropout=args["dropout"],
        norm_type=args["norm_type"], backend=args["backend"])
    band = args["backend"] == "pallas"
    comps = LAYER_COMPONENTS[args["layer_type"]]
    if args["case_paths"]:
        from ..train.streaming import foam_case_source

        graph, normalizer, _ = foam_case_source(
            args["case_paths"], chunk=world, time_dir=args["time_dir"])
        if band:
            graph = attach_band(graph, comps)

        def make_source():
            return foam_case_source(
                args["case_paths"], chunk=world, time_dir=args["time_dir"],
                normalizer=normalizer)[2]

        _, history = train_multicase_streamed(
            FlowGNN(mcfg).to(dev), TrainConfig(lr=args["lr"],
                                               seed=args["seed"]),
            graph, make_source, epochs=args["epochs"], lr=args["lr"],
            log_every=args["log_every"] if rank == 0 else 0)
        return ({"normalizer": normalizer, "history": history}
                if rank == 0 else None)
    mesh = FoamCase(args["case_path"]).load_mesh()
    base_graph = build_graph(mesh, with_band=band, band_components=comps)
    res = run_geometry_generalization(
        base_graph, n_train_cases=args["n_cases"],
        n_test_cases=args["n_test_cases"], epochs=args["epochs"],
        amplitude=args["amplitude"], model_cfg=mcfg, lr=args["lr"],
        seed=args["seed"], device=dev)
    return res if rank == 0 else None


def dp_time_rank(rank: int, world: int, kw: dict) -> dict:
    """One rank of the DP scaling benchmark: marginal seconds a step
    (``utils/dp_bench.py::time_dp_step``)."""
    from ..utils.dp_bench import time_dp_step

    return time_dp_step(rank, world, **kw)
