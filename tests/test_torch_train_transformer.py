"""Port Transformer training path vs the JAX package, on the same weights
(CPU).

* one train step (``make_train_step(..., jit=False)``, Pallas in interpret
  mode) of FlowGNN with Transformer convs from the JAX init (the projection
  biases zero, where the JAX package's extracted weights ``lin(eye) −
  lin(0)`` equal W exactly), dropout 0 in the model (flax's dropout keys
  cannot be reproduced in torch): loss, gradients, updated parameters and
  batch statistics — edge-conditioned on the geo planes (the
  ``banded_transformer_geo_mean_projgrad`` path: rows 9, 10, 7 and 6) and
  without edge features (rows 9, 10 and 7), in f32, bf16 and mixed;
* ``python -m gnn_bfs_rans_tpu_torch train --layer_type Transformer`` for
  2 epochs on the CPU lowers the loss, and ``infer`` serves its checkpoint;
  the ``Trainer`` trains the Transformer without edge features.

Small sizes: a 336-cell generated case with three snapshots, hidden 32,
2 heads, 2 layers.
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
from gnn_bfs_rans_tpu_torch.train.data import load_dataset
from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig, batch_loss
from gnn_bfs_rans_tpu_torch.train.loop import make_optimizer as port_optimizer
from gnn_bfs_rans_tpu_torch.train.loop import train_step
from gnn_bfs_rans_tpu_torch.train.trainer import Trainer

TIMES = ("100", "200", "282")
LR = 1e-3
CFG = dict(hidden_dim=32, num_layers=2, layer_type="Transformer", heads=2,
           backend="pallas", dropout=0.0)
# bk shifts every logit of a row alike, and bv and lin_skip's bias shift
# every row of a channel alike before the BatchNorm (at dropout 0, where
# the probabilities sum to 1): their gradients are zero in exact arithmetic
# and rounding noise on both sides, which Adam's first step turns into ±lr
ZERO_GRAD = tuple(f"['conv_{i}']['{m}']['bias']" for i in range(2)
                  for m in ("lin_key", "lin_value", "lin_skip"))
OUT_BIAS = "['out_3']['bias']"


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_train_transformer") / "case"
    generate_box_case(path, 24, 14, 1, time_dirs=TIMES,
                      time_field_fn=drifting_box_fields)
    jgraph = jax_build_graph(JaxFoamCase(path).load_mesh(), with_band=True,
                             band_components=LAYER_COMPONENTS["Transformer"])
    return path, jgraph, load_graph(path, "Transformer")


def _variables(cfg, graph, seed=0):
    """Seeded flax init with non-trivial BN parameters and statistics (the
    projection biases stay zero)."""
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


def _targets(n_pad):
    return np.random.default_rng(3).normal(size=(2, n_pad, 7)).astype(
        np.float32)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


_JAX_STEPS: dict = {}


def _jax_step(edge, dtype, jgraph, update=False):
    """JAX (loss, grads, batch stats after the forward, the starting params
    and stats, configs, and with ``update`` the params after one
    ``make_train_step`` and its loss); computed once per variant."""
    key = (edge, dtype, update)
    if key in _JAX_STEPS:
        return _JAX_STEPS[key]
    targets = _targets(jgraph.n_pad)
    jcfg = JaxModelConfig(**CFG, compute_dtype=dtype, use_edge_attr=edge)
    jtcfg = JaxTrainConfig(lr=LR, weight_decay=1e-4)
    params, stats = _variables(jcfg, jgraph)
    model = JaxFlowGNN(jcfg)

    def loss_fn(p):
        out, mutated = model.apply(
            {"params": p, "batch_stats": stats}, jgraph, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jnp.mean(jax.vmap(lambda t: jax_loss(
            out, t, jgraph.node_mask,
            pressure_ref_weight=jtcfg.pressure_ref_weight))(
                jnp.asarray(targets))), mutated["batch_stats"]
    (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    new = None
    if update:
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats,
                           opt_state=make_optimizer(jtcfg).init(params))
        new = make_train_step(model, jtcfg, jit=False)(
            state, jgraph, jnp.asarray(targets), jnp.float32(LR),
            jax.random.PRNGKey(0))
    _JAX_STEPS[key] = (float(loss), grads, new_stats, params, stats, jcfg,
                       jtcfg, new)
    return _JAX_STEPS[key]


def _port_step(graph, jcfg, jtcfg, params, stats):
    """The port's (loss, gradients before the clip, params and batch stats
    after one train step) from the JAX variables."""
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tcfg = TrainConfig.from_dict(jtcfg.to_dict())
    tt = torch.from_numpy(_targets(graph.n_pad))
    probe = FlowGNN(cfg)
    probe.load_state_dict(state_dict_from_flax(params, stats, cfg))
    loss = batch_loss(probe(graph, train=True), tt, graph, tcfg)
    loss.backward()
    grads, _ = flax_tree_from_state_dict(
        {**probe.state_dict(),
         **{k: p.grad for k, p in probe.named_parameters()}}, cfg)
    port = FlowGNN(cfg)
    port.load_state_dict(state_dict_from_flax(params, stats, cfg))
    step_loss = train_step(port, port_optimizer(port, tcfg), graph, tt, LR,
                           tcfg)
    assert step_loss.item() == pytest.approx(loss.item(), rel=1e-6)
    new_params, new_stats = flax_tree_from_state_dict(port.state_dict(), cfg)
    return loss.item(), grads, new_params, new_stats


# the flagship path (geo) in every dtype; without edges f32 and bf16.  The
# f32 geo step also runs the JAX package's whole make_train_step (clip,
# Adam + L2) against the port's train_step
VARIANTS = [(True, "float32"), (True, "bfloat16"), (True, "mixed"),
            (False, "float32"), (False, "bfloat16")]


@pytest.mark.parametrize("edge,dtype", VARIANTS,
                         ids=[f"{'geo' if e else 'noedge'}-{d}"
                              for e, d in VARIANTS])
def test_train_step_matches_jax(case, edge, dtype):
    _, jgraph, graph = case
    update = edge and dtype == "float32"
    (want_loss, want_grads, want_stats, params, stats, jcfg, jtcfg,
     new) = _jax_step(edge, dtype, jgraph, update)
    loss, grads, new_params, new_stats = _port_step(graph, jcfg, jtcfg,
                                                    params, stats)
    got_g, want_g = _leaves(grads), _leaves(want_grads)
    assert got_g.keys() == want_g.keys()
    g_max = max(np.abs(v).max() for v in want_g.values())
    zero_tol = 1e-6 if dtype == "float32" else 2e-3
    for k in ZERO_GRAD:
        # rounding noise: ≤ 1e-6 (f32) or 2e-3 (bf16) of the largest gradient
        assert np.abs(got_g[k]).max() <= zero_tol * g_max, k
        moved = _leaves(new_params)[k] - _leaves(params)[k]
        assert np.abs(moved).max() <= 1.01 * LR, k
    if dtype == "float32":
        # f32 in other summation orders through 2 layers and back: each
        # leaf within 1e-4 of its largest entry, or of 1e-3 of the largest
        # gradient for leaves that nearly cancel (input_proj's bias; without
        # edges the first layer's q and k kernels, 2.5e-6 of the largest
        # gradient, whose softmax VJP sums to 0 over each row's senders);
        # batch statistics 1e-4
        assert loss == pytest.approx(want_loss, rel=1e-5)
        for k, w in want_g.items():
            if k in ZERO_GRAD:
                continue
            err = np.abs(got_g[k] - w).max() / max(np.abs(w).max(),
                                                   1e-3 * g_max)
            assert err <= 1e-4, f"grad {k}: {err}"
        got_s = _leaves(new_stats)
        for k, w in _leaves(want_stats).items():
            assert np.abs(got_s[k] - w).max() <= 1e-4 * np.abs(w).max(), k
        if new is None:
            return
        # make_train_step: its loss, and the parameters after Adam's first
        # step, lr·g/(|g| + ε) ≈ ±lr per entry, compared where |g| ≥ 1% of
        # the leaf's largest entry (elsewhere the gradients' 1e-4 rounding
        # moves an entry's step by up to a few % of lr; where g is within
        # rounding of 0 its sign is a coin toss)
        state, step_loss = new
        assert float(step_loss) == pytest.approx(loss, rel=1e-5)
        got_p, start = _leaves(new_params), _leaves(params)
        for k, w in _leaves(state.params).items():
            if k in ZERO_GRAD:
                continue
            firm = np.abs(want_g[k]) >= 1e-2 * np.abs(want_g[k]).max()
            err = np.abs(got_p[k] - w)[firm].max(initial=0.0)
            assert err <= 1e-4 * np.abs(w).max(), f"param {k}: {err}"
            assert np.abs(got_p[k] - start[k]).max() <= 1.01 * LR, k
        return
    # bf16 and mixed: per leaf (norms) the port lies no further from the
    # JAX f32 step than 1.5 × JAX's own bf16 (mixed) step (measured ≤ 1.26×
    # on every other leaf); the zero-gradient leaves are noise on both
    # sides.  out_3's bias is the f32 sum of the loss cotangent over every
    # output row: without edges JAX's bf16 step lands 0.36 of a half bf16
    # ulp (2^-9) of its norm from f32 there and the port 0.60 (1.65×), so
    # that leaf alone may also take 2^-9 of its norm (``pytest -s`` prints
    # each leaf's readings)
    ref = _jax_step(edge, "float32", jgraph, edge)
    assert loss == pytest.approx(want_loss, rel=1e-3)
    for got, want, want32 in ((grads, want_grads, ref[1]),
                              (new_stats, want_stats, ref[2])):
        got, want, want32 = _leaves(got), _leaves(want), _leaves(want32)
        for k, w in want.items():
            if k in ZERO_GRAD:
                continue
            own = np.linalg.norm(w - want32[k])
            dist = np.linalg.norm(got[k] - want32[k])
            slack = 2.0 ** -9 * np.linalg.norm(w) if k == OUT_BIAS else 0.0
            print(f"{dtype} {'geo' if edge else 'noedge'} {k}: dist/own "
                  f"{dist / own:.3f}, dist/2^-9|w| "
                  f"{dist / (2.0 ** -9 * np.linalg.norm(w)):.3f}")
            assert dist <= 1.5 * own + slack, \
                f"{k}: {dist} from f32 > 1.5 × {own}"


def test_cli_trains_the_transformer_then_serves(case, tmp_path):
    path = case[0]
    out = tmp_path / "run"
    argv = ["train", "--case_path", str(path), "--time_dirs", *TIMES,
            "--output_dir", str(out), "--layer_type", "Transformer",
            "--hidden_dim", "32", "--num_layers", "2", "--epochs", "2",
            "--save_every", "2", "--lr", "3e-3", "--dropout", "0.1",
            "--compute_dtype", "bfloat16", "--device", "cpu"]
    assert cli_main(argv) == 0
    hist = json.loads((out / "training_history.json").read_text())
    assert np.isfinite(hist["train_loss"]).all()
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    meta = json.loads((out / "epoch_2.meta.json").read_text())
    assert meta["model_config"]["layer_type"] == "Transformer"
    assert meta["model_config"]["use_edge_attr"] is True
    assert meta.get("bn_recalibrated")        # bf16: saved recalibrated
    pred = tmp_path / "pred"
    assert cli_main(["infer", "--checkpoint", str(out), "--checkpoint_name",
                     "epoch_2", "--case_path", str(path), "--output_dir",
                     str(pred), "--reference_time", "100", "--device",
                     "cpu"]) == 0
    fields = dict(np.load(pred / "predictions.npz"))
    assert fields["U"].shape == (336, 3)
    assert all(np.isfinite(v).all() for v in fields.values())


def test_trainer_trains_the_transformer_without_edges(case, tmp_path):
    # the no-edge path (rows 9, 10 and 7) through the Trainer, as the CLI
    # conditions the Transformer on the edge features
    dataset = load_dataset(case[0], list(TIMES), with_band=True,
                           band_components=LAYER_COMPONENTS["Transformer"])
    mcfg = ModelConfig(**{**CFG, "dropout": 0.1}, use_edge_attr=False)
    out = tmp_path / "noedge"
    trainer = Trainer(dataset, mcfg,
                      TrainConfig(lr=3e-3, epochs=2, save_every=2),
                      output_dir=out, log_fn=lambda *a: None, device="cpu")
    trainer.initialize()
    hist = trainer.train()
    assert np.isfinite(hist["train_loss"]).all()
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    meta = json.loads((out / "epoch_2.meta.json").read_text())
    assert meta["model_config"]["use_edge_attr"] is False
