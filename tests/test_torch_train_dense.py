"""FlowGNN training off the banded kernels vs the JAX package (CPU).

* one f32 train step (``make_train_step(..., jit=False)``) from identical
  parameters at dropout 0 (flax's dropout keys cannot be reproduced in
  torch): loss, gradients (1e-4 of each leaf's max), updated parameters and
  batch statistics, on ``dense`` and ``segment`` with BatchNorm (the
  unfused BatchNorm training path), on ``dense`` with LayerNorm
  (``norm_type='layer'``), and on ``pallas`` with ``fuse_epilogue=False``
  (the kernels' convs, the unfused BatchNorm);
* a forward of a ``pallas`` model on a mesh without a band (the box
  unreordered, 400 cells a row: its bandwidth needs a window wider than 5
  tiles), which takes the convs' dense branches in both packages;
* ``python -m gnn_bfs_rans_tpu_torch train --backend dense`` (the JAX
  CLI's default backend) and ``--norm_type layer`` on the CPU, then
  ``infer`` of the checkpoint.

Small sizes: a 336-cell generated case with three snapshots, hidden 32,
2 layers, 4 heads.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.foam import FoamCase as JaxFoamCase
from gnn_bfs_rans_tpu.graph.build import build_graph as jax_build_graph
from gnn_bfs_rans_tpu.models.flow_gnn import FlowGNN as JaxFlowGNN
from gnn_bfs_rans_tpu.models.flow_gnn import ModelConfig as JaxModelConfig
from gnn_bfs_rans_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_bfs_rans_tpu.train.loop import TrainState, make_optimizer
from gnn_bfs_rans_tpu.train.loop import make_train_step
from gnn_bfs_rans_tpu.train.normalization import weighted_fieldwise_mse as jax_loss
from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
from gnn_bfs_rans_tpu_torch.compat.from_jax import (
    flax_tree_from_state_dict,
    state_dict_from_flax,
)
from gnn_bfs_rans_tpu_torch.foam import drifting_box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.foam.reader import FoamCase
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
from gnn_bfs_rans_tpu_torch.graph.build import build_graph
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig, batch_loss
from gnn_bfs_rans_tpu_torch.train.loop import make_optimizer as port_optimizer
from gnn_bfs_rans_tpu_torch.train.loop import train_step

TIMES = ("100", "200", "282")
LR = 1e-3
# name → ModelConfig fields
STEPS = {
    "GAT-dense-batch": dict(layer_type="GAT", backend="dense"),
    "GAT-segment-batch": dict(layer_type="GAT", backend="segment"),
    "Transformer-segment-batch": dict(layer_type="Transformer",
                                      backend="segment"),
    "GCN-dense-layer": dict(layer_type="GCN", backend="dense",
                            norm_type="layer"),
    "GIN-dense-layer": dict(layer_type="GIN", backend="dense",
                            norm_type="layer"),
    "GAT-pallas-unfused-epilogue": dict(layer_type="GAT", backend="pallas",
                                        fuse_epilogue=False),
}
# the conv bias that feeds a BatchNorm: zero gradient in exact arithmetic,
# rounding noise on both sides; Adam's first step turns it into ±lr
CONV_BIAS = {"GCN": "['bias']", "GIN": "['mlp_1']['bias']",
             "GAT": "['bias']", "Transformer": "['lin_skip']['bias']"}


@pytest.fixture(scope="module", autouse=True)
def warm_exp():
    """torch's first multi-threaded f32 exp in a process has been seen to
    return values up to 1e-4 off in one thread's chunk; one call first."""
    torch.exp(torch.randn(1 << 19))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_train_dense") / "case"
    generate_box_case(path, 24, 14, 1, time_dirs=TIMES,
                      time_field_fn=drifting_box_fields)
    return path, JaxFoamCase(path).load_mesh()


def _variables(cfg, graph, seed=0):
    """Seeded flax init with non-trivial normalization parameters (and
    BatchNorm statistics)."""
    variables = JaxFlowGNN(cfg).init(jax.random.PRNGKey(seed), graph,
                                     train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))
    rng = np.random.default_rng(seed)
    h = cfg.hidden_dim
    for i in range(cfg.num_layers):
        params[f"bn_{i}"]["scale"] = (1 + 0.1 * rng.normal(size=h)).astype(np.float32)
        params[f"bn_{i}"]["bias"] = (0.1 * rng.normal(size=h)).astype(np.float32)
        if cfg.norm_type == "batch":
            stats[f"bn_{i}"]["mean"] = (0.5 * rng.normal(size=h)).astype(np.float32)
            stats[f"bn_{i}"]["var"] = rng.uniform(0.5, 2.0, size=h).astype(np.float32)
    return params, stats


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_close(got, want, tol, what, skip=(), floor=1e-30):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k in skip:
            continue
        err = np.abs(got[k] - w).max() / max(np.abs(w).max(), floor)
        assert err <= tol, f"{what} {k}: {err}"


@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_step_matches_jax(case, name):
    path, mesh = case
    jcfg = JaxModelConfig(hidden_dim=32, num_layers=2, heads=4, dropout=0.0,
                          **STEPS[name])
    pallas = jcfg.backend == "pallas"
    jgraph = jax_build_graph(mesh, with_band=pallas,
                             band_components=LAYER_COMPONENTS[jcfg.layer_type])
    jtcfg = JaxTrainConfig(lr=LR, weight_decay=1e-4)
    params, stats = _variables(jcfg, jgraph)
    targets = np.random.default_rng(3).normal(
        size=(2, jgraph.n_pad, 7)).astype(np.float32)
    jmodel = JaxFlowGNN(jcfg)

    def loss_fn(p):
        out, _ = jmodel.apply(
            {"params": p, "batch_stats": stats}, jgraph, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jnp.mean(jax.vmap(lambda t: jax_loss(
            out, t, jgraph.node_mask,
            pressure_ref_weight=jtcfg.pressure_ref_weight))(
                jnp.asarray(targets)))
    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats,
                       opt_state=make_optimizer(jtcfg).init(params))
    new, _ = make_train_step(jmodel, jtcfg, jit=False)(
        state, jgraph, jnp.asarray(targets), jnp.float32(LR),
        jax.random.PRNGKey(0))

    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tcfg = TrainConfig.from_dict(jtcfg.to_dict())
    graph = build_graph(FoamCase(path).load_mesh(), with_band=pallas,
                        band_components=LAYER_COMPONENTS[cfg.layer_type])
    assert (graph.band is not None) == pallas
    tt = torch.from_numpy(targets)
    probe = FlowGNN(cfg)
    probe.load_state_dict(state_dict_from_flax(params, stats, cfg))
    loss = batch_loss(probe(graph, train=True), tt, graph, tcfg)
    loss.backward()
    got_grads, _ = flax_tree_from_state_dict(
        {**probe.state_dict(),
         **{k: p.grad for k, p in probe.named_parameters()}}, cfg)
    port = FlowGNN(cfg)
    port.load_state_dict(state_dict_from_flax(params, stats, cfg))
    got_loss = train_step(port, port_optimizer(port, tcfg), graph, tt, LR,
                          tcfg)
    got_params, got_stats = flax_tree_from_state_dict(port.state_dict(), cfg)

    assert got_loss.item() == pytest.approx(loss.item(), rel=1e-6)
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    g_max = max(np.abs(v).max() for v in _leaves(want_grads).values())
    zero = []
    if cfg.norm_type == "batch":
        zero = [f"['conv_{i}']{CONV_BIAS[cfg.layer_type]}" for i in range(2)]
    for k in zero:
        # f32 rounding noise: ~1e-8 of the largest gradient
        assert np.abs(_leaves(got_grads)[k]).max() <= 1e-6 * g_max, k
    # gradients and batch statistics: f32 summation order through 2 layers
    # and back (input_proj's bias nearly cancels under BatchNorm: measured
    # against 1e-3 of the largest gradient)
    _assert_close(got_grads, want_grads, 1e-4, "grad", zero,
                  floor=1e-3 * g_max)
    _assert_close(got_stats, new.batch_stats, 1e-4, "batch_stats")
    # parameters after Adam's first step, where |g| is not rounding noise:
    # the step lr·g/(|g| + ε) is ±lr for |g| ≫ ε and moves by up to
    # lr·ε/|g| per unit of relative gradient error where |g| nears ε (an
    # input_proj bias entry under BatchNorm, whose gradient cancels to
    # ~1e-7 of the largest, reads 1.2e-4·lr in another summation order)
    g_want, start = _leaves(want_grads), _leaves(params)
    got_p = _leaves(got_params)
    for k, w in _leaves(new.params).items():
        firm = np.abs(g_want[k]) > 1e-6 * g_max
        err = np.abs(got_p[k] - w)[firm].max(initial=0.0)
        assert err <= max(1e-4 * np.abs(w).max(), 1e-3 * LR), \
            f"param {k}: {err}"
        assert np.abs(got_p[k] - start[k]).max() <= 1.01 * LR, k


@pytest.mark.parametrize("exact_bn", [False, True], ids=["eval", "exact_bn"])
def test_forward_on_a_mesh_without_a_band(tmp_path_factory, exact_bn):
    """A ``pallas`` GAT on a mesh with no band serves through the dense
    branches, in both packages; eval and the exact-statistics forward."""
    path = tmp_path_factory.mktemp("noband") / "case"
    generate_box_case(path, 400, 2, 1)
    jgraph = jax_build_graph(JaxFoamCase(path).load_mesh(), reorder="none",
                             with_band=True,
                             band_components=LAYER_COMPONENTS["GAT"])
    graph = build_graph(FoamCase(path).load_mesh(), reorder="none",
                        with_band=True,
                        band_components=LAYER_COMPONENTS["GAT"])
    assert jgraph.band is None and graph.band is None
    jcfg = JaxModelConfig(hidden_dim=16, num_layers=2, layer_type="GAT",
                          heads=4, backend="pallas", dropout=0.0)
    params, stats = _variables(jcfg, jgraph)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    port = FlowGNN(cfg)
    port.load_state_dict(state_dict_from_flax(params, stats, cfg))
    variables = {"params": params, "batch_stats": stats}
    if exact_bn:
        want, _ = JaxFlowGNN(jcfg).apply(variables, jgraph, train=True,
                                         mutable=["batch_stats"])
    else:
        want = JaxFlowGNN(jcfg).apply(variables, jgraph)
    with torch.no_grad():
        got = port.eval()(graph, exact_bn=exact_bn)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("norm_type", ["batch", "layer"])
def test_cli_trains_on_the_dense_backend_then_serves(case, tmp_path,
                                                     norm_type):
    path, _ = case
    out = tmp_path / "run"
    argv = ["train", "--case_path", str(path), "--time_dirs", *TIMES,
            "--output_dir", str(out), "--hidden_dim", "32", "--num_layers",
            "2", "--epochs", "2", "--save_every", "2", "--lr", "3e-3",
            "--backend", "dense", "--norm_type", norm_type, "--device",
            "cpu"]
    assert cli_main(argv) == 0
    hist = json.loads((out / "training_history.json").read_text())
    assert np.isfinite(hist["train_loss"]).all()
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    meta = json.loads((out / "epoch_2.meta.json").read_text())
    assert meta["model_config"]["backend"] == "dense"
    assert meta["model_config"]["norm_type"] == norm_type
    pred = tmp_path / "pred"
    assert cli_main(["infer", "--checkpoint", str(out), "--checkpoint_name",
                     "epoch_2", "--case_path", str(path), "--output_dir",
                     str(pred), "--device", "cpu"]) == 0
    fields = dict(np.load(pred / "predictions.npz"))
    assert fields["U"].shape == (336, 3)
    assert all(np.isfinite(v).all() for v in fields.values())
