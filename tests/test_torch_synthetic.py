"""The port's synthetic grid graphs (``gnn_bfs_rans_tpu_torch/utils/
synthetic.py``) against the JAX package's, and its scale benchmark on the
CPU.

``build_grid_graph`` equals the JAX one array for array, band planes
included (exactly: the same numpy construction), at widths that give a
3-tile window, a 5-tile window and no band; the JAX module's own tests
(``tests/test_synthetic.py``) mirrored; ``run_scale_benchmark`` forward
and train at a few hundred cells.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.utils.synthetic import (
    build_grid_graph as jax_build_grid_graph,
)
from gnn_bfs_rans_tpu_torch.graph.band import ALL_COMPONENTS
from gnn_bfs_rans_tpu_torch.utils.synthetic import (
    build_grid_graph,
    run_scale_benchmark,
)

# the keys of the JAX package's run_scale_benchmark result
SCALE_KEYS = {"metric", "value", "unit", "mode", "remat", "n_nodes",
              "n_edges", "layer_type", "backend", "compute_dtype",
              "hidden_dim", "num_layers", "step_median_s", "platform"}


def _np(a):
    """A port tensor or a JAX-side array as numpy (bf16 as f32: exact)."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _assert_same(got, want, where):
    if want is None:
        assert got is None, where
        return
    assert got is not None, where
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, where
    np.testing.assert_array_equal(g, w, err_msg=where)


@pytest.mark.parametrize("nx,ny,tile,comps,window", [
    (8, 6, 16, ALL_COMPONENTS, 3),        # bandwidth < tile
    (32, 4, 16, ALL_COMPONENTS, 5),       # tile < bandwidth ≤ 2·tile
    (64, 4, 16, ALL_COMPONENTS, None),    # beyond 2·tile: no band
    (96, 12, 128, ("bias_self",), 3),     # the scale grid's shape
    (96, 5, 128, ("bias_noself", "geo", "edge"), 3),
])
def test_grid_graph_equals_jax(nx, ny, tile, comps, window):
    got = build_grid_graph(nx, ny, with_band=True, tile=tile,
                           band_components=comps)
    want = jax_build_grid_graph(nx, ny, with_band=True, tile=tile,
                                band_components=comps)
    for f in dataclasses.fields(want):
        if f.name == "band":
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, int):
            assert g == w, f.name
        else:
            _assert_same(g, w, f.name)
    if window is None:
        assert got.band is None and want.band is None
        return
    assert got.band.tile == want.band.tile == tile
    for f in dataclasses.fields(want.band):
        if f.name != "tile":
            _assert_same(getattr(got.band, f.name),
                         getattr(want.band, f.name), f"band.{f.name}")
    plane = got.band.adj if got.band.adj is not None else got.band.bias_self
    assert want.band.window == window
    if got.band.adj is not None:
        assert plane.shape[1] == window


def test_grid_graph_without_band_equals_jax():
    got = build_grid_graph(10, 7, with_band=False, tile=16)
    want = jax_build_grid_graph(10, 7, with_band=False, tile=16)
    assert got.band is None and want.band is None
    for name in ("node_feat", "senders", "receivers", "edge_feat",
                 "in_degree", "nbr_idx", "nbr_mask", "nbr_edge"):
        _assert_same(getattr(got, name), getattr(want, name), name)


class TestGridGraph:
    def test_grid_topology(self):
        g = build_grid_graph(8, 4, with_band=True, tile=16)
        # 2D grid: E = 2*(nx-1)*ny + 2*nx*(ny-1) directed edges
        assert g.n_nodes == 32
        assert g.n_edges == 2 * (7 * 4 + 8 * 3)
        deg = g.in_degree.numpy()[: g.n_nodes].reshape(4, 8)
        # corners 2, edges 3, interior 4
        assert deg[0, 0] == 2 and deg[1, 1] == 4 and deg[0, 3] == 3

    def test_band_attached_when_narrow(self):
        g = build_grid_graph(8, 8, with_band=True, tile=16)
        assert g.band is not None
        assert float(g.band.adj.double().sum()) == g.n_edges

    def test_band_widens_then_skips(self):
        g = build_grid_graph(32, 4, with_band=True, tile=16)
        assert g.band is not None and g.band.adj.shape[1] == 5
        assert float(g.band.adj.double().sum()) == g.n_edges
        g = build_grid_graph(64, 4, with_band=True, tile=16)
        assert g.band is None

    def test_edge_features_unit_directions(self):
        g = build_grid_graph(6, 5, with_band=False, tile=16)
        ef = g.edge_feat.numpy()[: g.n_edges]
        norms = np.linalg.norm(ef[:, :3], axis=1)
        np.testing.assert_allclose(norms, 1.0, rtol=1e-5)
        assert (ef[:, 3] > 0).all()

    def test_selective_components(self):
        g = build_grid_graph(8, 8, with_band=True, tile=16,
                             band_components=("bias_self",))
        assert g.band.bias_self is not None
        assert g.band.adj is None and g.band.gcn is None
        assert g.band.bias_noself is None


@pytest.mark.parametrize("mode", ["forward", "train"])
def test_run_scale_benchmark_on_the_cpu(mode):
    """GAT on the banded path (the plain versions) on a 24 × 12 grid: the
    JAX result's keys and the grid's counts."""
    for attempt in range(4):
        # µs-scale CPU timings can collapse under host contention (the
        # harness then refuses to report): retry rather than flake
        try:
            res = run_scale_benchmark(
                n_nodes=288, layer_type="GAT", num_layers=1, hidden_dim=8,
                backend="pallas", steps=2, nx=24, mode=mode, device="cpu")
            break
        except RuntimeError as e:
            if "resolution collapse" not in str(e) or attempt == 3:
                raise
    assert set(res) == SCALE_KEYS
    assert res["n_nodes"] == 288
    assert res["n_edges"] == 2 * 23 * 12 + 2 * 24 * 11
    assert res["mode"] == mode and res["platform"] == "cpu"
    assert res["step_median_s"] > 0
    assert res["value"] == res["n_edges"] / res["step_median_s"]


def test_run_scale_benchmark_refuses_remat():
    with pytest.raises(NotImplementedError, match="remat"):
        run_scale_benchmark(n_nodes=288, nx=24, mode="train", remat=True,
                            device="cpu")


def test_run_scale_benchmark_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        run_scale_benchmark(n_nodes=288, nx=24)
