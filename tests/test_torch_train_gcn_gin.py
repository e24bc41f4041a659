"""Port GCN, GIN and unfused GAT training vs the JAX package (CPU).

* one f32 train step (``make_train_step(..., jit=False)``, Pallas in
  interpret mode) from identical parameters, dropout 0 in the model (flax's
  dropout keys cannot be reproduced in torch): loss, gradients, updated
  parameters and batch statistics — GCN and GIN on ``banded_spmm``, and
  GAT with ``fuse_train=False`` on ``banded_gat_mean_packed``;
* ``python -m gnn_bfs_rans_tpu_torch train`` with the default layer type
  (GCN) on the CPU, then ``infer`` of its checkpoint.

Small sizes: a 336-cell generated case with three snapshots, hidden 32,
2 layers (GAT: 4 heads).
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
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
from gnn_bfs_rans_tpu_torch.infer import load_graph
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig, batch_loss
from gnn_bfs_rans_tpu_torch.train.loop import make_optimizer as port_optimizer
from gnn_bfs_rans_tpu_torch.train.loop import train_step

TIMES = ("100", "200", "282")
LR = 1e-3
MODELS = {
    "GCN": dict(layer_type="GCN"),
    "GIN": dict(layer_type="GIN"),
    "GAT-unfused": dict(layer_type="GAT", heads=4, fuse_train=False),
}
# the conv bias that feeds the BatchNorm right after the conv, which
# removes any per-channel shift: its gradient is zero in exact arithmetic
# and rounding noise on both sides, and Adam's first step turns that noise
# into ±lr.  Held to "zero up to rounding" and |Δ| ≤ lr instead.
CONV_BIAS = {"GCN": "['bias']", "GIN": "['mlp_1']['bias']",
             "GAT-unfused": "['bias']"}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_train_gcn_gin") / "case"
    generate_box_case(path, 24, 14, 1, time_dirs=TIMES,
                      time_field_fn=drifting_box_fields)
    return path, JaxFoamCase(path).load_mesh()


def _variables(cfg, graph, seed=0):
    """Seeded flax init with non-trivial BN parameters and statistics."""
    variables = JaxFlowGNN(cfg).init(jax.random.PRNGKey(seed), graph,
                                     train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    rng = np.random.default_rng(seed)
    h = cfg.hidden_dim
    for i in range(cfg.num_layers):
        params[f"bn_{i}"]["scale"] = (1 + 0.1 * rng.normal(size=h)).astype(np.float32)
        params[f"bn_{i}"]["bias"] = (0.1 * rng.normal(size=h)).astype(np.float32)
        stats[f"bn_{i}"]["mean"] = (0.5 * rng.normal(size=h)).astype(np.float32)
        stats[f"bn_{i}"]["var"] = rng.uniform(0.5, 2.0, size=h).astype(np.float32)
    return params, stats


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_close(got, want, tol, what, skip=(), floor=1e-30):
    """f32: the same arithmetic in other summation orders through 2 layers
    and their backward, per leaf against its largest element (or
    ``floor``, for leaves whose gradient nearly cancels)."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k in skip:
            continue
        err = np.abs(got[k] - w).max() / max(np.abs(w).max(), floor)
        assert err <= tol, f"{what} {k}: {err}"


@pytest.mark.parametrize("model", sorted(MODELS))
def test_train_step_matches_jax(case, model):
    path, mesh = case
    jcfg = JaxModelConfig(hidden_dim=32, num_layers=2, backend="pallas",
                          dropout=0.0, **MODELS[model])
    jgraph = jax_build_graph(mesh, with_band=True,
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
    graph = load_graph(path, cfg.layer_type)
    tt = torch.from_numpy(targets)
    # gradients before the clip, from a forward of its own
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

    # the loss of 2 layers in f32: ~1e-7 relative
    assert got_loss.item() == pytest.approx(loss.item(), rel=1e-6)
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    g_max = max(np.abs(v).max() for v in _leaves(want_grads).values())
    zero = [f"['conv_{i}']{CONV_BIAS[model]}" for i in range(2)]
    for k in zero:
        # f32 rounding noise: ~1e-8 of the largest gradient
        assert np.abs(_leaves(got_grads)[k]).max() <= 1e-6 * g_max, k
        moved = _leaves(got_params)[k] - _leaves(params)[k]
        assert np.abs(moved).max() <= 1.01 * LR, k
    # gradients and batch statistics: f32 summation order through 2 layers
    # and back (input_proj's bias nearly cancels: it is measured against
    # 1e-3 of the largest gradient)
    _assert_close(got_grads, want_grads, 1e-4, "grad", zero,
                  floor=1e-3 * g_max)
    _assert_close(got_stats, new.batch_stats, 1e-4, "batch_stats")
    # parameters after Adam's first step, lr·g/(|g| + ε): an entry whose
    # gradient is zero in exact arithmetic moves by a coin toss of up to ±lr
    # (a GIN mlp_0 bias channel whose ReLU is active on every row: the
    # BatchNorm removes its shift, and its gradient is 1e-9 of noise), so
    # the update is compared where |g| > 1e-6 of the largest gradient
    g_want, start = _leaves(want_grads), _leaves(params)
    got_p = _leaves(got_params)
    for k, w in _leaves(new.params).items():
        firm = np.abs(g_want[k]) > 1e-6 * g_max
        err = np.abs(got_p[k] - w)[firm].max(initial=0.0)
        assert err <= 1e-4 * np.abs(w).max(), f"param {k}: {err}"
        assert np.abs(got_p[k] - start[k]).max() <= 1.01 * LR, k


def test_cli_trains_the_default_gcn_then_serves(case, tmp_path):
    path, _ = case
    out = tmp_path / "run"
    argv = ["train", "--case_path", str(path), "--time_dirs", *TIMES,
            "--output_dir", str(out), "--hidden_dim", "32", "--num_layers",
            "2", "--epochs", "4", "--save_every", "4", "--lr", "3e-3",
            "--device", "cpu"]
    assert cli_main(argv) == 0
    hist = json.loads((out / "training_history.json").read_text())
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    meta = json.loads((out / "epoch_4.meta.json").read_text())
    # the JAX CLI's default model: GCN on the banded path
    assert meta["model_config"]["layer_type"] == "GCN"
    assert meta["model_config"]["backend"] == "pallas"

    pred = tmp_path / "pred"
    assert cli_main(["infer", "--checkpoint", str(out), "--checkpoint_name",
                     "epoch_4", "--case_path", str(path), "--output_dir",
                     str(pred), "--reference_time", "100", "--save_format",
                     "both", "--device", "cpu"]) == 0
    fields = dict(np.load(pred / "predictions.npz"))
    assert fields["U"].shape == (336, 3)
    assert all(np.isfinite(v).all() for v in fields.values())
    assert (pred / "predicted" / "U").is_file()
    assert set(json.loads((pred / "comparison.json").read_text())) >= {
        "U", "p"}
