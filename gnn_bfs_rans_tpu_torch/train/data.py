"""Snapshot dataset: parse once, normalize, pack static arrays.

Counterpart of ``gnn_bfs_rans_tpu/train/data.py``: the mesh is parsed
once, ONE canonical padded graph is built, the normalizer is fitted over
all usable snapshots, and targets are packed into a single
``[S, N_pad, 7]`` array in the graph's (reordered) node order; the band
planes are built only when asked (``with_band``: the ``pallas``
backend).  Uniform snapshots (time 0 initial conditions) are skipped by
default, as the reference's effective training set does.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..foam.reader import DEFAULT_FIELDS, FoamCase, FoamMesh
from ..graph.build import build_graph
from ..graph.structs import Graph
from .normalization import FieldNormalizer, pack_targets


@dataclasses.dataclass
class FlowDataset:
    """A static graph (CPU tensors) plus stacked normalized targets."""

    graph: Graph
    targets: np.ndarray            # [S, N_pad, 7] normalized, float32
    raw_fields: list[dict]
    time_dirs: list[str]
    normalizer: FieldNormalizer
    mesh: FoamMesh
    case_path: str

    @property
    def n_snapshots(self) -> int:
        return len(self.time_dirs)


def _is_uniform_snapshot(fields: dict[str, np.ndarray]) -> bool:
    return all(np.allclose(v, v.reshape(-1)[0]) for v in fields.values())


def load_dataset(
    case_path: str | Path,
    time_dirs: list[str] | None = None,
    fields: tuple[str, ...] = DEFAULT_FIELDS,
    include_uniform: bool = False,
    normalizer: FieldNormalizer | None = None,
    node_align: int = 128,
    edge_align: int = 128,
    with_band: bool = False,
    band_components: tuple[str, ...] | None = None,
) -> FlowDataset:
    """Load an OpenFOAM case into a dataset."""
    case = FoamCase(case_path)
    mesh = case.load_mesh()
    graph = build_graph(mesh, node_align=node_align, edge_align=edge_align,
                        with_band=with_band, band_components=band_components)
    if time_dirs is None:
        time_dirs = case.available_time_dirs()

    usable: list[tuple[str, dict]] = []
    for td in time_dirs:
        try:
            f = case.load_fields(td, fields=fields, n_cells=mesh.n_cells,
                                 strict=True)
        except (FileNotFoundError, ValueError) as e:
            print(f"Warning: skipping time dir {td}: {e}")
            continue
        if not include_uniform and _is_uniform_snapshot(f):
            print(f"Note: time dir {td} is uniform (initial conditions); "
                  "skipping (pass include_uniform=True to keep)")
            continue
        usable.append((td, f))
    if not usable:
        raise ValueError(f"no usable snapshots among {time_dirs} in "
                         f"{case_path}")

    if normalizer is None:
        normalizer = FieldNormalizer().fit({
            name: np.concatenate([f[name] for _, f in usable], axis=0)
            for name in fields})

    perm = (graph.perm.numpy()[: graph.n_nodes]
            if graph.perm is not None else None)
    targets = np.zeros((len(usable), graph.n_pad, 7), dtype=np.float32)
    for i, (_, f) in enumerate(usable):
        packed = pack_targets(normalizer.transform(f))
        if perm is not None:
            packed = packed[perm]
        targets[i, : packed.shape[0]] = packed

    return FlowDataset(graph=graph, targets=targets,
                       raw_fields=[f for _, f in usable],
                       time_dirs=[td for td, _ in usable],
                       normalizer=normalizer, mesh=mesh,
                       case_path=str(case_path))
