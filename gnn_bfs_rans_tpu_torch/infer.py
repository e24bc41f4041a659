"""Checkpoint load + predict: the serving path.

Counterpart of ``gnn_bfs_rans_tpu/infer.py``.  Which backend serves a
checkpoint (``backend``, as in the JAX package's ``Predictor.from_checkpoint``
and ``predict_case``): a name overrides the checkpoint's, ``None`` keeps the
one it trained on, and ``'auto'`` (the default) serves an ordinary
checkpoint on ``pallas`` whatever its meta records (the JAX package's
``'auto'`` → ``dense`` rule exists to skip a minutes-long TPU compile that
the card does not have), so on a banded mesh it runs through the kernels
and on a mesh without a band (a window wider than 5 tiles: most 3D hex
meshes) through the convs' dense branches, as the JAX convs route
``pallas`` there.  Under ``'auto'`` a checkpoint saved with BN
recalibration (``meta['bn_recalibrated']``) keeps the backend it trained
on, as the JAX package's does (``infer.py:89-93``): its exact statistics
belong to that backend's arithmetic.  ``load_graph`` builds the band planes
the layer type reads (the Transformer's ``bias_noself`` and its geo
planes, or the generic edge planes for non-geometric features) when the
backend is ``pallas``.  ``Predictor.from_torch_checkpoint`` serves a
checkpoint in the reference's own ``.pt`` format (``compat/torch_port.py``)
under ``'auto'``.  Every checkpoint's model is built by
``models.build_model`` from its meta file's ``model_config`` (a FlowGNN,
or MeshGraphNets, which reads no band).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device
from .foam.reader import FoamCase
from .graph.band import LAYER_COMPONENTS
from .graph.build import build_graph
from .graph.structs import Graph
from .models.factory import build_model
from .models.flow_gnn import ModelConfig, split_fields
from .train.checkpoint import load_checkpoint
from .train.graphs import Graphed
from .train.normalization import FieldNormalizer
from .train.recal import exact_stats


# the graphs a Predictor keeps forwards (and their CUDA graphs) for; the
# least recently used goes first
FORWARDS_KEPT = 8


def resolve_backend(backend: str | None, trained: str,
                    recalibrated: bool) -> str:
    """The backend that serves a checkpoint trained on ``trained``:
    ``backend`` by name, ``trained`` for None, and for ``'auto'``
    ``pallas`` unless the checkpoint was saved BN-recalibrated."""
    if backend == "auto":
        return trained if recalibrated else "pallas"
    return trained if backend is None else backend


@dataclasses.dataclass
class Predictor:
    """A loaded model + normalizer on one device.

    ``exact_bn``: predict through the deterministic train-mode forward —
    BatchNorm uses the exact batch statistics of the input graph (see the
    JAX package's ``Predictor.exact_bn``).

    On the card the forward is a CUDA graph (``train/graphs.py``; the JAX
    package's jitted forward): the first ``predict_packed`` of a graph runs
    eagerly, as the warm-up every capture needs, and later calls on the
    same graph object replay, one graph per (graph, model, ``exact_bn``),
    for the ``FORWARDS_KEPT`` graphs used last.
    The graph's tensors are moved to the device once, at its first call,
    and read again by every replay; ``recalibrate_bn`` writes the model's
    statistics in place, so the replays see them.
    """

    model: torch.nn.Module
    model_config: ModelConfig
    normalizer: FieldNormalizer | None
    meta: dict
    device: torch.device
    exact_bn: bool = False
    _forwards: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint_dir: str | Path,
        name: str = "best",
        backend: str | None = "auto",
        exact_bn: bool | str = "auto",
        device: str | torch.device = "cuda",
    ) -> "Predictor":
        """``backend``: see :func:`resolve_backend`; ``exact_bn='auto'``
        follows ``meta['bn_recalibrated']``."""
        dev = resolve_device(device)
        state, meta = load_checkpoint(checkpoint_dir, name)
        normalizer = (FieldNormalizer.from_dict(meta["normalizer"])
                      if meta.get("normalizer") else None)
        return cls._build(state, ModelConfig.from_dict(meta["model_config"]),
                          normalizer, meta, backend, exact_bn, dev)

    @classmethod
    def from_torch_checkpoint(
        cls,
        path: str | Path,
        exact_bn: bool | str = "auto",
        device: str | torch.device = "cuda",
    ) -> "Predictor":
        """A checkpoint in the reference's ``.pt`` format
        (``compat/torch_port.py::load_torch_checkpoint``), served as a
        native one is under ``backend='auto'``: on ``pallas`` (such a file
        is never BN-recalibrated, so ``exact_bn='auto'`` is off)."""
        from .compat.torch_port import load_torch_checkpoint

        dev = resolve_device(device)
        state, model_config, normalizer = load_torch_checkpoint(path)
        meta = {"model_config": model_config.to_dict(),
                "torch_checkpoint": str(path)}
        return cls._build(state, model_config, normalizer, meta, "auto",
                          exact_bn, dev)

    @classmethod
    def _build(cls, state: dict, model_config: ModelConfig,
               normalizer: FieldNormalizer | None, meta: dict,
               backend: str | None, exact_bn: bool | str,
               dev: torch.device) -> "Predictor":
        recalibrated = bool(meta.get("bn_recalibrated"))
        if exact_bn == "auto":
            exact_bn = recalibrated
        model_config = dataclasses.replace(
            model_config, backend=resolve_backend(
                backend, model_config.backend, recalibrated))
        model = build_model(model_config)
        model.load_state_dict(state)
        model.eval().to(dev)
        return cls(model=model, model_config=model_config,
                   normalizer=normalizer, meta=meta, device=dev,
                   exact_bn=bool(exact_bn))

    def predict_packed(self, graph: Graph) -> np.ndarray:
        """Normalized model output in ORIGINAL cell order, [n_nodes, 7]."""
        with torch.inference_mode():
            out = self._forward(graph)()
        out = out.float().cpu().numpy()[: graph.n_nodes]
        if graph.perm is not None:
            perm = graph.perm.cpu().numpy()[: graph.n_nodes]
            orig = np.empty_like(out)
            orig[perm] = out
            out = orig
        return out

    def _forward(self, graph: Graph) -> Graphed:
        key = (id(graph), id(self.model), self.exact_bn)
        entry = self._forwards.pop(key, None)
        if entry is None:
            model, exact_bn = self.model, self.exact_bn
            on_device = graph.to(self.device)
            fwd = Graphed(lambda: model(on_device, exact_bn=exact_bn),
                          self.device)
            # the entry keeps the graph and the model alive, so no other
            # object takes their ids while it exists
            entry = (graph, model, fwd)
            if len(self._forwards) >= FORWARDS_KEPT:
                del self._forwards[next(iter(self._forwards))]
        self._forwards[key] = entry     # the most recent last
        return entry[2]

    def recalibrate_bn(self, graph: Graph) -> None:
        """Replace the BatchNorm running statistics with the exact batch
        statistics of one deterministic train-mode pass over ``graph``
        (``train/recal.py``).  No-op without batch statistics."""
        stats = exact_stats(self.model, graph.to(self.device))
        if stats:
            self.model.load_state_dict({**self.model.state_dict(), **stats})

    def predict_fields(
        self, graph: Graph, denormalize: bool = True
    ) -> dict[str, np.ndarray]:
        """Forward + slice + (optionally) denormalize."""
        fields = split_fields(self.predict_packed(graph))
        if denormalize and self.normalizer is not None:
            fields = self.normalizer.inverse_transform(fields)
        return fields


def load_graph(case_path: str | Path, layer_type: str = "GAT",
               boundary_self_loops: bool = False,
               backend: str = "pallas") -> Graph:
    """Parse a case and build its graph (CPU tensors), with the band planes
    ``layer_type`` reads when ``backend`` is ``pallas`` (``graph.band`` is
    None on a mesh whose band would be wider than 5 tiles; no band for a
    layer that reads none: MeshGraphNets)."""
    mesh = FoamCase(case_path).load_mesh()
    comps = LAYER_COMPONENTS.get(layer_type)
    return build_graph(mesh,
                       with_band=backend == "pallas" and comps is not None,
                       band_components=comps,
                       boundary_self_loops=boundary_self_loops)


def predict_case(
    checkpoint_dir: str | Path,
    case_path: str | Path,
    name: str = "best",
    backend: str | None = "auto",
    boundary_self_loops: bool = False,
    recalibrate_bn: bool = False,
    exact_bn: bool | str = "auto",
    device: str | torch.device = "cuda",
) -> tuple[Predictor, dict[str, np.ndarray], Graph]:
    """End to end: load checkpoint, parse case, build graph, (optionally)
    recalibrate BN on it, predict.  ``backend`` as in
    :meth:`Predictor.from_checkpoint`; the graph gets its band only when
    that backend is ``pallas``."""
    predictor = Predictor.from_checkpoint(checkpoint_dir, name,
                                          backend=backend, exact_bn=exact_bn,
                                          device=device)
    cfg = predictor.model_config
    graph = load_graph(case_path, cfg.layer_type, boundary_self_loops,
                       cfg.backend).to(predictor.device)
    if recalibrate_bn:
        predictor.recalibrate_bn(graph)
    fields = predictor.predict_fields(graph)
    return predictor, fields, graph
