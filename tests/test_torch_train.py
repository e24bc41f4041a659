"""Port GAT training path vs the JAX package, on the same weights (CPU).

* one train step (``make_train_step(..., jit=False)``, Pallas in interpret
  mode) from identical parameters, dropout 0 in the model (flax's dropout
  keys cannot be reproduced in torch): loss, gradients, updated parameters
  and batch statistics, in f32 and bf16, and with the pressure freeze;
* the plateau and cosine schedules over a fixed loss sequence;
* the BN recalibration statistics against ``make_exact_stats_fn``;
* the ``Trainer`` for 2 epochs through ``python -m gnn_bfs_rans_tpu_torch
  train``: its checkpoint serves through the port's ``infer`` and
  ``--resume`` continues from it; what is not ported raises.  The unfused
  GAT step (``fuse_train=False``) is held in ``test_torch_train_gcn_gin.py``.

Small sizes: a 336-cell generated case with three snapshots, hidden 32,
4 heads (H·C 128), 2 layers.
"""

import dataclasses
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
from gnn_bfs_rans_tpu.train.loop import (
    ReduceLROnPlateau as JaxPlateau,
)
from gnn_bfs_rans_tpu.train.loop import make_train_step
from gnn_bfs_rans_tpu.train.normalization import weighted_fieldwise_mse as jax_loss
from gnn_bfs_rans_tpu.train.recal import make_exact_stats_fn
from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
from gnn_bfs_rans_tpu_torch.compat.from_jax import (
    flax_tree_from_state_dict,
    state_dict_from_flax,
)
from gnn_bfs_rans_tpu_torch.foam import drifting_box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.infer import load_graph, predict_case
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.train.loop import (
    ReduceLROnPlateau,
    TrainConfig,
    batch_loss,
    cosine_lr,
    make_optimizer as port_optimizer,
    train_step,
)
from gnn_bfs_rans_tpu_torch.train.recal import exact_stats

CFG = dict(hidden_dim=32, num_layers=2, layer_type="GAT", heads=4,
           backend="pallas", dropout=0.0)
TIMES = ("100", "200", "282")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_train") / "case"
    generate_box_case(path, 24, 14, 1, time_dirs=TIMES,
                      time_field_fn=drifting_box_fields)
    jgraph = jax_build_graph(JaxFoamCase(path).load_mesh(), with_band=True,
                             band_components=("bias_self",))
    return path, jgraph, load_graph(path)


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


def _targets(n_pad, batch=2, seed=3):
    return np.random.default_rng(seed).normal(size=(batch, n_pad, 7)).astype(
        np.float32)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# The conv biases feed the BatchNorm right after the conv, which removes
# any per-channel shift: their gradient is zero in exact arithmetic and
# rounding noise on both sides, and Adam's first step turns that noise into
# ±lr.  They are held to "zero up to rounding" and |Δ| ≤ lr instead.
ZERO_GRAD = ("['conv_0']['bias']", "['conv_1']['bias']")


def _assert_f32_close(got, want, tol, what, skip=(), floor=1e-30):
    """f32: the same arithmetic in other summation orders through 2 layers
    and their backward (measured ≤ 2e-5 of each leaf's largest element).
    ``floor``: the least scale an error is measured against, for leaves
    whose gradient nearly cancels (``input_proj``'s bias: 1e-3 of the
    largest gradient)."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k in skip:
            continue
        err = np.abs(got[k] - w).max() / max(np.abs(w).max(), floor)
        assert err <= tol, f"{what} {k}: {err}"


# leaves whose gradient nearly cancels (a per-channel shift of the input
# projection is removed by the BatchNorms and the softmax): bf16 gives
# rounding noise there on both sides
NEAR_ZERO = ZERO_GRAD + ("['input_proj']['bias']",)


def _assert_bf16_close(got, want, want_f32, what, max_gap=None):
    """bf16, norms per leaf.  The port's result lies no further from the
    JAX f32 result than 1.5× the JAX bf16 result's own distance from it
    (measured ≤ 1.27×), plus 1e-4 of the leaf's norm where bf16 and f32
    agree to rounding: the port is as accurate in bf16 as the JAX package.
    Both round at bf16 points that differ in detail — the port's dz rounds
    once where the JAX kernel rounds each window partial, and
    interpret-mode Pallas drops the epilogue's intermediate bf16 roundings
    — so they are not closer to each other than each is to f32.  With
    ``max_gap``, the port lies within that share of the JAX bf16 result's
    norm as well, except on the ``NEAR_ZERO`` leaves."""
    got, want, ref = _leaves(got), _leaves(want), _leaves(want_f32)
    for k, w in want.items():
        own = np.linalg.norm(w - ref[k])
        err = np.linalg.norm(got[k] - ref[k])
        assert err <= 1.5 * own + 1e-4 * np.linalg.norm(w), \
            f"{what} {k}: {err} from f32 > 1.5 × {own}"
        if max_gap is not None and k not in NEAR_ZERO:
            gap = np.linalg.norm(got[k] - w)
            assert gap <= max_gap * np.linalg.norm(w), \
                f"{what} {k}: {gap} from JAX bf16 > {max_gap} × |{k}|"


_JAX_STEPS: dict = {}


def _jax_step(dtype, freeze, jgraph):
    """JAX (loss, grads, params after one step, batch stats after it, and
    the starting params, stats and configs), on ``_targets``; computed once
    per case."""
    key = (dtype, freeze, id(jgraph))
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = _jax_step_uncached(dtype, freeze, jgraph)
    return _JAX_STEPS[key]


def _jax_step_uncached(dtype, freeze, jgraph):
    targets = _targets(jgraph.n_pad)
    jcfg = JaxModelConfig(**CFG, compute_dtype=dtype)
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
                jnp.asarray(targets))), mutated
    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats,
                       opt_state=make_optimizer(jtcfg).init(params))
    new, _ = make_train_step(model, jtcfg, jit=False)(
        state, jgraph, jnp.asarray(targets), jnp.float32(LR),
        jax.random.PRNGKey(0), freeze_pressure=freeze)
    return float(loss), grads, new.params, new.batch_stats, params, stats, \
        jcfg, jtcfg


LR = 1e-3


@pytest.mark.parametrize("dtype,freeze", [("float32", False),
                                          ("bfloat16", False),
                                          ("float32", True)],
                         ids=["f32", "bf16", "f32-freeze"])
def test_train_step_matches_jax(case, dtype, freeze):
    _, jgraph, graph = case
    targets = _targets(jgraph.n_pad)
    (want_loss, want_grads, want_params, want_stats, params, stats, jcfg,
     jtcfg) = _jax_step(dtype, freeze, jgraph)

    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tcfg = TrainConfig.from_dict(jtcfg.to_dict())
    port = FlowGNN(cfg)
    port.load_state_dict(state_dict_from_flax(params, stats, cfg))
    tt = torch.from_numpy(targets)
    # gradients before the clip, from a forward of its own
    probe = FlowGNN(cfg)
    probe.load_state_dict(port.state_dict())
    loss = batch_loss(probe(graph, train=True), tt, graph, tcfg)
    loss.backward()
    grads = {k: p.grad for k, p in probe.named_parameters()}
    got_grads, _ = flax_tree_from_state_dict(
        {**probe.state_dict(), **grads}, cfg)
    opt = port_optimizer(port, tcfg)
    got_loss = train_step(port, opt, graph, tt, LR, tcfg,
                          freeze_pressure=freeze)
    got_params, got_stats = flax_tree_from_state_dict(port.state_dict(), cfg)
    assert got_loss.item() == pytest.approx(loss.item(), rel=1e-6)

    g_max = max(np.abs(v).max() for v in _leaves(want_grads).values())
    for k in ZERO_GRAD:
        # rounding noise: f32 ~1e-8, bf16 ~4e-4 of the largest gradient
        zero_tol = 1e-6 if dtype == "float32" else 2e-3
        assert np.abs(_leaves(got_grads)[k]).max() <= zero_tol * g_max, k
        moved = _leaves(got_params)[k] - _leaves(params)[k]
        assert np.abs(moved).max() <= 1.01 * LR, k
    if dtype == "float32":
        # the loss of 2 layers in f32: ~1e-7 relative
        assert loss.item() == pytest.approx(want_loss, rel=1e-5)
        _assert_f32_close(got_grads, want_grads, 1e-4, "grad", ZERO_GRAD,
                          floor=1e-3 * g_max)
        _assert_f32_close(got_params, want_params, 1e-4, "param", ZERO_GRAD)
        _assert_f32_close(got_stats, want_stats, 1e-4, "batch_stats")
    else:
        f32 = _jax_step("float32", freeze, jgraph)
        # bf16 losses: measured 6e-6 apart, 3e-6 from f32
        assert loss.item() == pytest.approx(want_loss, rel=1e-4)
        # port vs JAX in bf16, measured: gradients ≤ 0.17 of the leaf's
        # norm, batch statistics ≤ 9.3e-5; the update is Adam's first step,
        # ±lr per entry, whose sign is a coin toss where g is within bf16
        # rounding of 0 (JAX's own bf16 update sits up to 0.79 from f32's),
        # so it is held only by the distance from f32
        _assert_bf16_close(got_grads, want_grads, f32[1], "grad", 0.25)
        delta = lambda tree: jax.tree.map(  # noqa: E731
            lambda a, b: np.asarray(a, np.float64) - b, tree, params)
        _assert_bf16_close(delta(got_params), delta(want_params),
                           delta(f32[2]), "update")
        _assert_bf16_close(got_stats, want_stats, f32[3], "batch_stats",
                           1e-3)
    if freeze:
        # weight row 3 and bias 3 of out_3 did not move (decay included)
        np.testing.assert_array_equal(got_params["out_3"]["kernel"][:, 3],
                                      params["out_3"]["kernel"][:, 3])
        assert got_params["out_3"]["bias"][3] == params["out_3"]["bias"][3]


def test_schedules_match_jax():
    losses = [1.0, 0.9, 0.95, 0.95, 0.95, 0.8, 0.85, 0.85, 0.85, 0.85, 0.7]
    want, got = JaxPlateau(1e-3, patience=2), ReduceLROnPlateau(1e-3, patience=2)
    for m in losses:
        assert got.step(m) == want.step(m)
    assert got.lr == want.lr < 1e-3 and got.best == want.best
    tcfg = TrainConfig(lr=1e-3, epochs=5, plateau_min_lr=1e-5)
    lrs = [cosine_lr(tcfg, e) for e in range(1, 6)]
    # the JAX trainer's cosine: min + ½(lr − min)(1 + cos(π(e − 1)/(E − 1)))
    want_lrs = [1e-5 + 0.5 * (1e-3 - 1e-5) * (1 + np.cos(np.pi * (e - 1) / 4))
                for e in range(1, 6)]
    np.testing.assert_allclose(lrs, want_lrs, rtol=1e-12)
    assert lrs[0] == 1e-3 and abs(lrs[-1] - 1e-5) < 1e-15


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_stats_match_jax_recal(case, dtype):
    _, jgraph, graph = case
    jcfg = JaxModelConfig(**CFG, compute_dtype=dtype)
    params, stats = _variables(jcfg, jgraph, seed=4)
    want = make_exact_stats_fn(jcfg)(params, stats, jgraph)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    port = FlowGNN(cfg)
    port.load_state_dict(state_dict_from_flax(params, stats, cfg))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = exact_stats(port, graph)
    # the model's own running statistics are untouched
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    _, got_tree = flax_tree_from_state_dict({**before, **got}, cfg)
    # f32: summation order, amplified ~10× by the JAX side's momentum
    # inversion;
    # bf16: the statistics of a bf16 activation (one bf16 ulp is 2^-8)
    _assert_f32_close(got_tree, want, 1e-4 if dtype == "float32" else 1e-2,
                      "exact stats")


def _train_argv(case_path, out, epochs, *extra):
    return ["train", "--case_path", str(case_path), "--time_dirs", *TIMES,
            "--output_dir", str(out), "--hidden_dim", "32", "--num_layers",
            "2", "--epochs", str(epochs), "--save_every", "1", "--lr", "3e-3",
            "--layer_type", "GAT", "--device", "cpu", *extra]


def test_trainer_checkpoint_serves_and_resumes(case, tmp_path):
    path, _, _ = case
    out = tmp_path / "run"
    assert cli_main(_train_argv(path, out, 2, "--compute_dtype", "bfloat16")) == 0
    hist = json.loads((out / "training_history.json").read_text())
    assert set(hist) == {"epoch", "train_loss", "val_loss", "field_errors",
                         "learning_rate"}
    assert hist["epoch"] == [1, 2] and np.isfinite(hist["train_loss"]).all()
    for name in ("best", "epoch_1", "epoch_2"):
        assert (out / f"{name}.pt").is_file()
        assert (out / f"{name}.train.pt").is_file()
    meta = json.loads((out / "epoch_2.meta.json").read_text())
    # bf16 batch norm: recalibrated on save (bn_recal auto)
    assert meta["bn_recalibrated"] is True and meta["epoch"] == 2
    assert meta["model_config"]["layer_type"] == "GAT"

    predictor, fields, graph = predict_case(out, path, name="epoch_2",
                                            device="cpu")
    assert predictor.exact_bn is True
    assert fields["U"].shape == (graph.n_nodes, 3)
    assert all(np.isfinite(v).all() for v in fields.values())
    # recalibrating a recalibrated checkpoint changes nothing but rounding
    _, again, _ = predict_case(out, path, name="epoch_2", device="cpu",
                               recalibrate_bn=True, exact_bn=False)
    assert all(np.isfinite(v).all() for v in again.values())

    assert cli_main(_train_argv(path, out, 3, "--compute_dtype", "bfloat16",
                                "--resume")) == 0
    hist = json.loads((out / "training_history.json").read_text())
    assert hist["epoch"] == [1, 2, 3]
    rows = [json.loads(ln) for ln in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2, 3]


def test_train_loss_falls_f32(case, tmp_path):
    path, _, _ = case
    out = tmp_path / "f32"
    assert cli_main(_train_argv(path, out, 4, "--dropout", "0.1",
                                "--curriculum_epochs", "1")) == 0
    hist = json.loads((out / "training_history.json").read_text())
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    # curriculum phase 2 halved the lr
    assert hist["learning_rate"][1] == pytest.approx(0.5 * 3e-3)
    assert not json.loads((out / "best.meta.json").read_text()).get(
        "bn_recalibrated")


def test_unported_paths_raise(case, tmp_path):
    """Paths that raised before they were ported now train: the dense
    backend and on-device epoch blocks (``--epoch_block 2``: one block of
    the one epoch, a row of history and a checkpoint); what stays
    unported raises."""
    path, _, _ = case
    assert cli_main(_train_argv(path, tmp_path / "a", 1, "--backend",
                                "dense")) == 0
    out = tmp_path / "b"
    assert cli_main(_train_argv(path, out, 1, "--epoch_block", "2")) == 0
    hist = json.loads((out / "training_history.json").read_text())
    assert hist["epoch"] == [1] and np.isfinite(hist["train_loss"]).all()
    assert (out / "epoch_1.pt").is_file()
    # the Transformer trains (rows 9, 10, 7 and 6), with dropout; its
    # fused-projection eval form (row 11) has no gradient
    cfg = ModelConfig(**{**CFG, "layer_type": "Transformer", "heads": 2,
                         "dropout": 0.1, "fuse_eval": True})
    port = FlowGNN(cfg)
    graph = load_graph(path, "Transformer")
    port(graph, train=True,
         generator=torch.Generator().manual_seed(0)).sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in port.parameters())
    with pytest.raises(NotImplementedError, match="eval form"):
        port.convs[0](port.input_proj(graph.node_feat), graph)
    if not torch.cuda.is_available():
        # the card is the default device: no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main(_train_argv(path, tmp_path / "c", 1)[:-2])


def test_dropout_masks_come_from_the_generator(case):
    _, _, graph = case
    cfg = ModelConfig(**{**CFG, "dropout": 0.1})
    port = FlowGNN(cfg)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        torch.manual_seed(123)   # the global RNG must not matter
        with torch.no_grad():
            outs.append(port(graph, train=True, generator=gen))
        torch.manual_seed(321)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with torch.no_grad():
        other = port(graph, train=True,
                     generator=torch.Generator().manual_seed(8))
        det = port(graph, train=True)
    assert not torch.equal(other, outs[0])
    assert not torch.equal(det, outs[0])
    assert dataclasses.replace(cfg, dropout=0.0).dropout == 0.0
