"""Port foam/ and graph/ vs the JAX package; import and device rules.

(a) mesh arrays, the RCM permutation, the padded graph (its COO edges and
    its dense neighbour layout ``nbr_idx`` / ``nbr_mask`` / ``nbr_edge``,
    ``e_pad``, ``max_degree``), the int8 band and the written OpenFOAM
    files equal the JAX package's exactly;
(f) the port and its CLI import no JAX;
(g) entry points raise without CUDA unless the CPU is asked for.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.foam import FoamCase as JaxFoamCase
from gnn_bfs_rans_tpu.foam import generate_box_case as jax_generate_box_case
from gnn_bfs_rans_tpu.foam import save_fields_openfoam_format as jax_save
from gnn_bfs_rans_tpu.graph.build import build_graph as jax_build_graph
from gnn_bfs_rans_tpu_torch.foam import (
    FoamCase,
    box_fields,
    generate_box_case,
    save_fields_openfoam_format,
)
from gnn_bfs_rans_tpu_torch.graph.build import build_graph

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_foam")
    # 24×14 = 336 cells: bandwidth < 64 → one half-tile band class
    info = generate_box_case(root / "port", 24, 14, 1)
    jax_generate_box_case(root / "jax", 24, 14, 1)
    return root, info


def test_generated_case_files_identical(cases):
    root, _ = cases
    files = sorted(p.relative_to(root / "port")
                   for p in (root / "port").rglob("*") if p.is_file())
    assert len(files) == 10  # 5 polyMesh files + 5 fields
    for rel in files:
        assert (root / "port" / rel).read_bytes() == \
            (root / "jax" / rel).read_bytes(), rel


def test_mesh_and_fields_equal(cases):
    root, info = cases
    mesh = FoamCase(root / "port").load_mesh()
    ref = JaxFoamCase(root / "port").load_mesh()
    for name in ("points", "face_offsets", "face_points", "owner",
                 "neighbour", "cell_centers", "internal_mask"):
        np.testing.assert_array_equal(getattr(mesh, name), getattr(ref, name))
    assert {k: vars(v) for k, v in mesh.boundaries.items()} == \
        {k: vars(v) for k, v in ref.boundaries.items()}
    assert mesh.n_cells == info["n_cells"] == 336
    got = FoamCase(root / "port").load_fields("100", strict=True)
    want = JaxFoamCase(root / "port").load_fields("100", strict=True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_graph_perm_and_band_equal(cases):
    root, _ = cases
    mesh = FoamCase(root / "port").load_mesh()
    g = build_graph(mesh, with_band=True, band_components=("bias_self",))
    ref = jax_build_graph(mesh, with_band=True,
                          band_components=("bias_self",))
    assert (g.n_nodes, g.n_edges, g.n_pad) == (ref.n_nodes, ref.n_edges,
                                               ref.n_pad)
    for name in ("node_feat", "senders", "receivers", "edge_feat",
                 "node_mask", "edge_mask", "in_degree", "perm"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert g.band.bias_self.dtype == torch.int8
    assert g.band.width_cols == 256
    np.testing.assert_array_equal(g.band.bias_self.numpy(),
                                  np.asarray(ref.band.bias_self))


@pytest.mark.parametrize("reorder,align", [("rcm", 4), ("none", 4),
                                           ("rcm", 8)])
def test_dense_neighbour_layout_equal(cases, reorder, align):
    """The padded neighbour layout the dense backend reads, with and
    without RCM and at another ``degree_align``, and its moves with
    ``Graph.to``."""
    from gnn_bfs_rans_tpu.graph.structs import build_padded_graph as jax_pad
    from gnn_bfs_rans_tpu_torch.graph.structs import build_padded_graph

    root, _ = cases
    mesh = FoamCase(root / "port").load_mesh()
    ref = jax_build_graph(mesh, reorder=reorder)
    if align != 4:
        args = [np.asarray(ref.senders)[:ref.n_edges],
                np.asarray(ref.receivers)[:ref.n_edges],
                np.asarray(ref.edge_feat)[:ref.n_edges],
                np.asarray(ref.node_feat)[:ref.n_nodes]]
        ref = jax_pad(*args, degree_align=align)
        g = build_padded_graph(*args, degree_align=align)
    else:
        g = build_graph(mesh, reorder=reorder)
    assert (g.e_pad, g.max_degree) == (ref.e_pad, ref.max_degree)
    assert g.max_degree % align == 0
    for name in ("senders", "receivers", "nbr_idx", "nbr_mask", "nbr_edge"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert g.nbr_idx.dtype == g.nbr_edge.dtype == torch.int32
    assert g.nbr_mask.dtype == torch.bool
    moved = g.to("meta")
    assert moved.nbr_idx.device.type == moved.nbr_edge.device.type == "meta"
    assert moved.nbr_mask.device.type == "meta"


def test_all_band_components_equal(cases):
    root, _ = cases
    mesh = FoamCase(root / "port").load_mesh()
    comps = ("adj", "gcn", "bias_self", "bias_noself")
    g = build_graph(mesh, with_band=True, band_components=comps)
    ref = jax_build_graph(mesh, with_band=True, band_components=comps)
    assert g.band.adj.dtype == torch.bfloat16
    for name in comps:
        np.testing.assert_array_equal(
            getattr(g.band, name).float().numpy(),
            np.asarray(getattr(ref.band, name), np.float32), name)


def test_writer_files_identical(tmp_path, cases):
    _, info = cases
    fields = box_fields(info["cell_centers"] * 1.7)
    save_fields_openfoam_format(fields, tmp_path / "port", "predicted")
    jax_save(fields, tmp_path / "jax", "predicted")
    for name in ("U", "p", "k", "epsilon", "nut"):
        assert (tmp_path / "port/predicted" / name).read_bytes() == \
            (tmp_path / "jax/predicted" / name).read_bytes()


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import gnn_bfs_rans_tpu_torch, gnn_bfs_rans_tpu_torch.cli.main\n"
        "import gnn_bfs_rans_tpu_torch.infer\n"
        "import gnn_bfs_rans_tpu_torch.compat.from_jax\n"
        "import gnn_bfs_rans_tpu_torch.kernels.epilogue\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'ml_dtypes', 'gnn_bfs_rans_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_need_cuda_unless_cpu(monkeypatch, cases):
    from gnn_bfs_rans_tpu_torch.device import resolve_device
    from gnn_bfs_rans_tpu_torch.infer import Predictor, predict_case

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor.from_checkpoint("unused")
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_case("unused", cases[0] / "port")
    assert resolve_device("cpu").type == "cpu"
