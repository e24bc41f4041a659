"""The benchmark's inputs and arithmetic: traffic files, the frozen copies
of the port's generators, the FLOP and byte counts, the rate
arithmetic."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.yardstick import flops, meshes, weights

from perfbench.tests import tiny


@pytest.mark.parametrize("path", sorted((run.HERE / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_traffic_file_loads(path):
    t = json.loads(path.read_text())
    assert t["kind"] == "train"
    assert (run.HERE / "drivers" / f"{t['kind']}.py").exists()
    mesh = meshes.make_mesh(dict(t["mesh"], **(
        {"nx": 10, "ny": 4} if t["mesh"]["kind"] == "grid"
        else {"nx": 10, "ny": 4, "nz": 2})))
    assert mesh.n_edges == 2 * (mesh.owner.size if mesh.owner is not None
                                else mesh.n_edges // 2)


@pytest.mark.parametrize("cell",
                         [w["name"] for w in tiny.bench()["workloads"]])
def test_every_cell_has_its_files(cell):
    b = tiny.bench()
    f = run.cell_files(b, cell)
    assert set(f["limits"]) and all(v >= 0 for v in f["limits"].values())
    names = [m["name"] for m in run.metrics_of(b, cell, False)]
    assert "setup_s" in names and len(names) >= 2
    for trace in (False, True):
        for m in run.metrics_of(b, cell, trace):
            assert callable(run.reader(m["name"]))
    assert run.metrics_of(b, cell, True)


def test_box_mesh_matches_the_port_case(tmp_path):
    from gnn_bfs_rans_tpu_torch.foam.casegen import generate_box_case
    from gnn_bfs_rans_tpu_torch.foam.reader import FoamCase

    info = generate_box_case(tmp_path, 7, 5, 3)
    mesh = FoamCase(tmp_path).load_mesh()
    mine = meshes.box_mesh(7, 5, 3)
    n_int = mesh.n_internal_faces
    np.testing.assert_array_equal(mine.owner, mesh.owner[:n_int])
    np.testing.assert_array_equal(mine.neighbour, mesh.neighbour)
    np.testing.assert_allclose(mine.centers, info["cell_centers"])


def test_grid_mesh_matches_the_port_grid():
    from gnn_bfs_rans_tpu_torch.utils.synthetic import build_grid_graph

    g = build_grid_graph(9, 7, with_band=False)
    mine = meshes.grid_mesh(9, 7)
    order = np.lexsort((mine.senders, mine.receivers))
    ne = g.n_edges
    np.testing.assert_array_equal(mine.senders[order], g.senders[:ne])
    np.testing.assert_array_equal(mine.receivers[order], g.receivers[:ne])
    np.testing.assert_array_equal(mine.edge_feat[order], g.edge_feat[:ne])
    np.testing.assert_array_equal(mine.centers.astype(np.float32),
                                  g.node_feat[:g.n_nodes])


def test_fields_and_targets_match_the_port():
    from gnn_bfs_rans_tpu_torch.foam.casegen import drifting_box_fields
    from gnn_bfs_rans_tpu_torch.train.normalization import (FieldNormalizer,
                                                            pack_targets)

    c = meshes.box_mesh(6, 4, 2).centers
    snaps = [meshes.drifting_fields(c, t) for t in (100.0, 282.0)]
    for s, t in zip(snaps, (100.0, 282.0)):
        ref = drifting_box_fields(c, t)
        for k in ref:
            np.testing.assert_array_equal(s[k], ref[k])
    norm = FieldNormalizer().fit({k: np.concatenate([s[k] for s in snaps])
                                  for k in snaps[0]})
    want = np.stack([pack_targets(norm.transform(s)) for s in snaps])
    np.testing.assert_allclose(meshes.normalized_targets(snaps), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", tiny.configs())
def test_weights_are_the_port_model_layout(name):
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN

    from perfbench.core import program

    cfg = tiny.config(name)
    w = weights.make_weights(cfg, 5, "cpu")
    model = FlowGNN(program.model_config(cfg))
    model.load_state_dict(w, strict=True)
    again = weights.make_weights(cfg, 5, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


@pytest.mark.parametrize("layer_type", ["GCN", "GAT", "GIN", "Transformer"])
def test_flops_equal_the_port_formula(layer_type):
    from gnn_bfs_rans_tpu_torch.utils import roofline

    from perfbench.reference.archs import _flowgnn

    kw = dict(layer_type=layer_type, num_layers=3, hidden_dim=32,
              n_nodes=100, n_edges=380, heads=4)
    assert _flowgnn.forward_matmul_flops(**kw) == \
        roofline.forward_matmul_flops(**kw)
    assert _flowgnn.train_matmul_flops(**kw) == \
        roofline.train_matmul_flops(**kw)
    assert flops.DEVICE_PEAKS == roofline.DEVICE_PEAKS


def test_step_ops_on_a_tiny_graph():
    cfg = dict(tiny.files("gat4x256-bf16.train-box12k")["config"],
               hidden_dim=8, num_layers=1, heads=2)
    n, e = 10, 30
    fwd = dict((k, (f, b)) for k, f, b in flops.step_ops(cfg, n, e, False))
    # input projection: 2·n·3·8 FLOPs; x f32 in, W and y bf16
    assert fwd["input_proj"] == (2 * n * 3 * 8, n * 3 * 4 + 3 * 8 * 2
                                 + n * 8 * 2)
    # the GAT conv: projection, logits, aggregation over edges and
    # self-loops; x, W (+ attention vectors, bias), adjacency, output
    w = 8 * 16 + 2 * 16 + 8
    assert fwd["conv0"] == (2 * n * 8 * 16 + 2 * n * 16 * 4
                            + 2 * (e + n) * 16,
                            n * 8 * 2 + w * 2 + 4 * e + n * 8 * 2)
    train = flops.step_ops(cfg, n, e, True)
    names = [k for k, _, _ in train]
    assert "conv0.bwd" in names and "adam" in names
    # a product's backward is two products of its shape
    assert sum(f for k, f, _ in train
               if k.endswith(".bwd") and not k.startswith("norm")) == \
        2 * sum(f for k, f, _ in train
                if f"{k}.bwd" in names and not k.startswith("norm"))
    # the least time is the larger bound of each operation
    least = flops.least_seconds([("a", 2e12, 1.0), ("b", 1.0, 1e12)],
                                1e12, 1e12)
    assert least == pytest.approx(3.0)


def test_gcn_step_ops_on_a_tiny_graph():
    cfg = dict(tiny.config("gcn6x256-f32"), hidden_dim=8, num_layers=1)
    n, e = 10, 30
    fwd = dict((k, (f, b)) for k, f, b in flops.step_ops(cfg, n, e, False))
    # the projection, then the aggregation over edges and self-loops; x,
    # W and the bias, the adjacency, the output, all f32
    assert fwd["conv0"] == (2 * n * 8 * 8 + 2 * (e + n) * 8,
                            n * 8 * 4 + (8 * 8 + 8) * 4 + 4 * e + n * 8 * 4)
    assert fwd["input_proj"][1] == n * 3 * 4 + 3 * 8 * 4 + n * 8 * 4


def test_peaks_follow_the_compute_dtype():
    name = "NVIDIA H100 80GB HBM3"
    assert flops.peaks(name) == (989e12, 3.35e12)
    assert flops.peaks(name, "bfloat16") == (989e12, 3.35e12)
    assert flops.peaks(name, "float32") == (67e12, 3.35e12)
    assert flops.peaks("cpu") is None


def test_rate_arithmetic():
    rec = {"window": {"kind": "train", "blocks": 3, "cells": 900,
                      "seconds": 3.0}}
    assert run.reader("train_cells_per_s")(rec) == pytest.approx(300.0)
    assert run.reader("train_cells_per_s")(
        {"window": {"kind": "train", "blocks": 0}}) is None


def test_trace_metrics_read_nothing_without_a_trace():
    rec = {"trace": None, "window": {"kind": "train"}, "peaks": (1.0, 1.0)}
    for name in ("idle_share.train", "train_mfu", "kernel_roofline.train",
                 "step_device_ms.train"):
        assert run.reader(name)(rec) is None
