"""The MeshGraphNets architecture module (``reference/archs/
meshgraphnets.py``): its leaves are the port's ``state_dict``, and its
FLOP count at the grid cell's size is the published model's."""

from __future__ import annotations

import torch

from perfbench.reference import archs
from perfbench.yardstick import flops, weights

from perfbench.tests import tiny

CONFIG = "meshgraphnets15x128-bf16"
# the grid cell's mesh: real cells and directed edges
N, E = 250080, 994918


def test_leaves_are_the_port_state_dict():
    from gnn_bfs_rans_tpu_torch.models import build_model

    from perfbench.core import program

    cfg = dict(tiny.config(CONFIG), num_layers=15)
    model = build_model(program.model_config(cfg))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {leaf.name: leaf.shape for leaf in weights.param_shapes(cfg)}
    assert got == want
    assert sum(v.numel() for v in model.parameters()) == 2332679
    w = weights.make_weights(dict(cfg, num_layers=2), 5, "cpu")
    assert torch.equal(w["processor.1.edge_mlp.norm.weight"], torch.ones(128))
    assert float(w["processor.0.edge_mlp.lin_0.weight"].abs().max()) \
        <= 384 ** -0.5


def test_model_flops_are_the_hand_count():
    cfg = tiny.config(CONFIG) | {"num_layers": 15}
    assert archs.load(cfg).__name__.endswith(".meshgraphnets")
    edge = 15 * E * 2 * (384 * 128 + 2 * 128 * 128)        # 163,840 an edge
    node = 15 * N * 2 * (256 * 128 + 2 * 128 * 128)        # 131,072 a node
    enc_dec = (N * 2 * (3 * 128 + 128 * 128 + 128 * 128)
               + E * 2 * (4 * 128 + 128 * 128 + 128 * 128)
               + N * 2 * (128 * 128 + 128 * 128 + 128 * 7))
    fwd = edge + node + enc_dec
    assert flops.model_flops(cfg, N, E, False) == fwd
    assert flops.model_flops(cfg, N, E, True) == 3 * fwd
    assert abs(fwd / 3.04e12 - 1) < 0.01
    assert edge / fwd > 0.8


def test_step_ops_name_the_edge_block():
    cfg = tiny.config(CONFIG) | {"num_layers": 15}
    train = {k: (f, b) for k, f, b in flops.step_ops(cfg, N, E, True)}
    ev = {k: (f, b) for k, f, b in flops.step_ops(cfg, N, E, False)}
    assert {"mgn_edge", "mgn_edge_bwd", "edge_mlp_nodes",
            "edge_mlp_wgrad"} <= set(train)
    assert "mgn_edge" in ev and "mgn_edge_bwd" not in ev
    # the backward kernel's products: dy·W2, dh1·W1, dh0·W0_e an edge, and
    # the LayerNorm; the cotangent of v is products on the nodes
    h2 = 2 * 128 * 128
    assert train["mgn_edge_bwd"][0] == 15 * E * (3 * h2 + 2 * 8 * 128)
    assert train["edge_mlp_nodes"][0] == 15 * N * 4 * h2
    assert train["edge_mlp_wgrad"][0] == 15 * E * 3 * h2
    # the edge block moves bytes at least as long as it multiplies
    fl, by = train["mgn_edge"]
    assert by / 3.35e12 > fl / 989e12
