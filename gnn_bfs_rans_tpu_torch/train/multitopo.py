"""Multi-topology training: cases with different meshes in one run.

Counterpart of ``gnn_bfs_rans_tpu/train/multitopo.py``.  Each case's mesh
becomes its own padded :class:`~..graph.structs.Graph`, padded with coarse
aligns (``node_align`` / ``edge_align``), so that meshes of similar size
land on the same padded shape, the **bucket** ``(n_pad, e_pad,
max_degree)``.  The graphs carry bucket-canonical counts (``n_nodes =
n_pad``, ``n_edges = e_pad``: the masks carry the real rows, and the
counts are read on the host only); the true counts stay on the
:class:`TopoCase`.  The parameters are shared by every bucket.

On the card the trainer keeps one CUDA graph of the train step and one of
the eval step a bucket (``train/graphs.py::Graphed``, the counterpart of
the JAX module's one compiled step a bucket): a bucket's graph is captured
on its first case and replays every case of the bucket, each case's graph
and targets copied into the capture's static copy before the replay.  On
the CPU every step runs eagerly.

No band is built, as in the JAX module: with ``backend='pallas'`` the
convs see ``graph.band is None`` and take their dense branches, so this
path launches no hand-written kernel.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..foam.reader import DEFAULT_FIELDS, FoamCase
from ..graph.build import build_graph
from ..graph.structs import Graph
from ..models.flow_gnn import FlowGNN, ModelConfig
from .checkpoint import save_checkpoint
from .graphs import Graphed
from .loop import (ReduceLROnPlateau, TrainConfig, eval_step, make_optimizer,
                   train_step)
from .normalization import FieldNormalizer, pack_targets


@dataclasses.dataclass(frozen=True)
class TopoCase:
    """One mesh and its normalized targets, padded to a bucket shape."""

    name: str
    graph: Graph          # bucket-canonical counts (see the module doc)
    n_nodes: int          # true counts (host-side slicing / writeback)
    n_edges: int
    targets: np.ndarray   # [1, n_pad, 7]

    @property
    def bucket(self) -> tuple[int, int, int]:
        g = self.graph
        return (g.n_pad, g.e_pad, g.max_degree)


@dataclasses.dataclass
class MultiTopoDataset:
    cases: list[TopoCase]
    normalizer: FieldNormalizer

    @property
    def buckets(self) -> dict[tuple[int, int, int], list[int]]:
        out: dict[tuple[int, int, int], list[int]] = {}
        for i, c in enumerate(self.cases):
            out.setdefault(c.bucket, []).append(i)
        return out


def _bucketize(graph: Graph) -> tuple[Graph, int, int]:
    """The graph with its counts set to the padded shape (the bucket),
    and its true node and edge counts."""
    true_n, true_e = graph.n_nodes, graph.n_edges
    return (dataclasses.replace(graph, n_nodes=graph.n_pad,
                                n_edges=graph.e_pad), true_n, true_e)


def load_multitopo_dataset(
    case_paths: Sequence[str | Path],
    time_dir: str = "282",
    fields: tuple[str, ...] = DEFAULT_FIELDS,
    node_align: int = 512,
    edge_align: int = 2048,
    normalizer: FieldNormalizer | None = None,
) -> MultiTopoDataset:
    """Parse every case (the meshes may differ), fit one normalizer over
    the concatenation of all their fields (unless one is given), then
    build each case's reordered padded graph (no band) and its permuted
    targets ``[1, n_pad, 7]``."""
    if not case_paths:
        raise ValueError("no case paths")
    parsed = []
    all_fields: dict[str, list[np.ndarray]] = {}
    for path in case_paths:
        case = FoamCase(path)
        mesh = case.load_mesh()
        f = case.load_fields(time_dir, fields=fields, n_cells=mesh.n_cells,
                             strict=True)
        parsed.append((str(path), mesh, f))
        for k, v in f.items():
            all_fields.setdefault(k, []).append(np.asarray(v, np.float64))
    if normalizer is None:
        normalizer = FieldNormalizer().fit(
            {k: np.concatenate(v, axis=0) for k, v in all_fields.items()})

    cases: list[TopoCase] = []
    for name, mesh, f in parsed:
        graph = build_graph(mesh, node_align=node_align,
                            edge_align=edge_align)
        packed = pack_targets(normalizer.transform(f))
        if graph.perm is not None:
            packed = packed[graph.perm.numpy()[: graph.n_nodes]]
        tg = np.zeros((1, graph.n_pad, 7), np.float32)
        tg[0, : packed.shape[0]] = packed
        bgraph, true_n, true_e = _bucketize(graph)
        cases.append(TopoCase(name=name, graph=bgraph, n_nodes=true_n,
                              n_edges=true_e, targets=tg))
    return MultiTopoDataset(cases=cases, normalizer=normalizer)


class MultiTopoTrainer:
    """Epoch loop over cases of different meshes, one train-step graph
    and one eval graph a bucket on the card (see the module doc).

    An epoch takes one step a case (all its snapshots), in the order of
    ``numpy.random.default_rng(seed).permutation``, then evaluates every
    case; the plateau scheduler steps on the mean val loss.  The history
    follows the reference schema plus ``per_case_loss``; ``best`` (on
    improvement) and ``epoch_<epochs>`` are ``Predictor``-compatible
    checkpoints with ``multitopo_cases`` in their meta.  The model is
    initialized from a generator seeded with ``train_config.seed``, or
    from ``init_state`` (a state dict, e.g. JAX weights carried over with
    ``compat/from_jax.py``); dropout draws from a device generator with
    the same seed.  It runs on the card unless asked for the CPU."""

    def __init__(
        self,
        dataset: MultiTopoDataset,
        model_config: ModelConfig,
        train_config: TrainConfig,
        output_dir: str | Path = "multitopo_out",
        log_fn: Callable = print,
        device: str | torch.device = "cuda",
        init_state: dict | None = None,
    ):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.model_config = model_config
        self.config = train_config
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.log = log_fn
        self.model = FlowGNN(
            model_config,
            generator=torch.Generator().manual_seed(train_config.seed))
        if init_state is not None:
            self.model.load_state_dict(init_state)
        self.model.to(self.device)
        self.optimizer = make_optimizer(self.model, train_config)
        self.generator = torch.Generator(device=self.device).manual_seed(
            train_config.seed)
        self.np_rng = np.random.default_rng(train_config.seed)
        self.scheduler = ReduceLROnPlateau(
            train_config.lr, factor=train_config.plateau_factor,
            patience=train_config.plateau_patience,
            threshold=train_config.plateau_threshold,
            min_lr=train_config.plateau_min_lr)
        self.graphs = [c.graph.to(self.device) for c in dataset.cases]
        self.targets = [torch.from_numpy(c.targets).to(self.device)
                        for c in dataset.cases]
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        # ("step" | "eval", bucket) → Graphed
        self._graphs: dict = {}
        self._best_val = float("inf")
        self.history = {"epoch": [], "train_loss": [], "val_loss": [],
                        "learning_rate": [], "per_case_loss": []}

    def _step(self, bucket) -> Graphed:
        key = ("step", bucket)
        if key not in self._graphs:
            def step(graph, targets, lr):
                return train_step(self.model, self.optimizer, graph, targets,
                                  lr, self.config, self.generator)
            self._graphs[key] = Graphed(
                step, self.device, pool=self._pool,
                generators=(self.generator,),
                before_capture=lambda: self.optimizer.zero_grad(
                    set_to_none=True))
        return self._graphs[key]

    def _eval(self, bucket) -> Graphed:
        key = ("eval", bucket)
        if key not in self._graphs:
            def evaluate(graph, targets):
                loss, _, out = eval_step(self.model, graph, targets,
                                         self.config)
                return loss, out
            self._graphs[key] = Graphed(evaluate, self.device,
                                        pool=self._pool)
        return self._graphs[key]

    def train(self) -> dict:
        cfg = self.config
        cases = self.dataset.cases
        buckets = self.dataset.buckets
        self.log(f"Multi-topology training: {len(cases)} cases in "
                 f"{len(buckets)} bucket(s): " + ", ".join(
                     f"{k}×{len(v)}" for k, v in sorted(buckets.items())))
        n_params = sum(p.numel() for p in self.model.parameters())
        self.log(f"Model parameters: {n_params:,}")

        lr = self.scheduler.lr
        for epoch in range(1, cfg.epochs + 1):
            t0 = time.perf_counter()
            order = self.np_rng.permutation(len(cases))
            losses: list = [None] * len(cases)
            for ci in order:
                # a replay's output is overwritten by the next: keep a copy
                losses[ci] = self._step(cases[ci].bucket)(
                    self.graphs[ci], self.targets[ci], float(lr)).clone()
            vals = []
            for ci, c in enumerate(cases):
                vals.append(self._eval(c.bucket)(self.graphs[ci],
                                                 self.targets[ci])[0].clone())
            host = torch.stack(losses + vals).double().tolist()
            train_loss = float(np.mean(host[:len(cases)]))
            val_losses = host[len(cases):]
            val_loss = float(np.mean(val_losses))
            lr_used = lr
            if cfg.scheduler == "plateau":
                lr = self.scheduler.step(val_loss)
            self.history["epoch"].append(epoch)
            self.history["train_loss"].append(train_loss)
            self.history["val_loss"].append(val_loss)
            self.history["learning_rate"].append(lr_used)
            self.history["per_case_loss"].append(val_losses)
            dt = time.perf_counter() - t0
            self.log(f"Epoch {epoch}: train={train_loss:.6f} "
                     f"val={val_loss:.6f} lr={lr_used:.3e} ({dt:.2f}s)")
            if val_loss < self._best_val:
                self._best_val = val_loss
                self._save_checkpoint("best", epoch, val_loss)
        self._save_checkpoint(f"epoch_{cfg.epochs}", cfg.epochs,
                              self.history["val_loss"][-1])
        (self.output_dir / "training_history.json").write_text(
            json.dumps(self.history))
        return self.history

    def _save_checkpoint(self, name: str, epoch: int,
                         val_loss: float) -> None:
        """A ``Predictor``-compatible checkpoint (the ``Trainer``'s
        layout, with the optimizer state)."""
        save_checkpoint(
            self.output_dir, name, self.model.state_dict(),
            model_config=self.model_config,
            normalizer=self.dataset.normalizer, epoch=epoch,
            val_loss=val_loss, train_config=self.config.to_dict(),
            extra={"multitopo_cases": [c.name for c in self.dataset.cases]},
            train_state={"optimizer": self.optimizer.state_dict()})

    def predict_case(self, case_index: int) -> np.ndarray:
        """Normalized predictions [n_nodes, 7] for one case, in the
        original cell order."""
        c = self.dataset.cases[case_index]
        _, out = self._eval(c.bucket)(self.graphs[case_index],
                                      self.targets[case_index])
        out = out.detach().cpu().numpy()[: c.n_nodes]
        if c.graph.perm is not None:
            perm = c.graph.perm.numpy()[: c.n_nodes]
            unperm = np.empty_like(out)
            unperm[perm] = out
            out = unperm
        return out
