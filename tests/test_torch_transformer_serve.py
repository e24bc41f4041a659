"""Port Transformer serving path vs the JAX package, on the same weights.

* a JAX ``FlowGNN`` (Transformer, ``backend='pallas'``, Pallas in interpret
  mode) initialized from a seed, nonzero projection biases set from numpy,
  its params carried by ``state_dict_from_flax``, gives the port's forward
  the same output — eval and ``exact_bn``; edge-conditioned (geo planes)
  with ``fuse_eval`` off and on, and without edge features; f32, bf16 and
  mixed;
* ``state_dict_from_flax`` and ``flax_tree_from_state_dict`` are inverse;
* ``predict_case`` end to end: a JAX-saved checkpoint (Orbax) and the port
  checkpoint carried from it give the same denormalized fields, and
  ``--recalibrate_bn`` runs;
* the Transformer's training forward differentiates; what is not ported
  (the dense backend, epoch blocks, row 11 under a gradient) raises.

Small sizes: a 336-cell generated case, hidden 32, 2 heads, 2 layers.
"""

import functools
import json
import types

import jax
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.foam import FoamCase as JaxFoamCase
from gnn_bfs_rans_tpu.graph.build import build_graph as jax_build_graph
from gnn_bfs_rans_tpu.infer import predict_case as jax_predict_case
from gnn_bfs_rans_tpu.models.flow_gnn import FlowGNN as JaxFlowGNN
from gnn_bfs_rans_tpu.models.flow_gnn import ModelConfig as JaxModelConfig
from gnn_bfs_rans_tpu.train.checkpoint import load_checkpoint as jax_load
from gnn_bfs_rans_tpu.train.checkpoint import save_checkpoint as jax_save
from gnn_bfs_rans_tpu.train.loop import make_forward
from gnn_bfs_rans_tpu.train.normalization import FieldNormalizer as JaxNorm
from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
from gnn_bfs_rans_tpu_torch.compat.from_jax import (
    flax_tree_from_state_dict,
    state_dict_from_flax,
)
from gnn_bfs_rans_tpu_torch.foam import box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
from gnn_bfs_rans_tpu_torch.infer import load_graph, predict_case
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.train.checkpoint import save_checkpoint
from gnn_bfs_rans_tpu_torch.train.normalization import FieldNormalizer

CFG = dict(hidden_dim=32, num_layers=2, layer_type="Transformer", heads=2,
           backend="pallas", dropout=0.1)
# variant → (use_edge_attr, fuse_eval)
VARIANTS = {"geo": (True, False), "geo-fused": (True, True),
            "noedge": (False, False)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_transformer") / "case"
    info = generate_box_case(path, 24, 14, 1)
    jgraph = jax_build_graph(JaxFoamCase(path).load_mesh(), with_band=True,
                             band_components=LAYER_COMPONENTS["Transformer"])
    return path, info, jgraph


def _jax_variables(cfg, graph, seed=0):
    """Seeded flax init with BN parameters, running statistics and the
    projection biases made non-trivial from numpy."""
    model = JaxFlowGNN(cfg)
    variables = model.init(jax.random.PRNGKey(seed), graph, train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    rng = np.random.default_rng(seed)
    h = cfg.hidden_dim
    for i in range(cfg.num_layers):
        params[f"bn_{i}"]["scale"] = (1 + 0.1 * rng.normal(size=h)).astype(np.float32)
        params[f"bn_{i}"]["bias"] = (0.1 * rng.normal(size=h)).astype(np.float32)
        stats[f"bn_{i}"]["mean"] = (0.5 * rng.normal(size=h)).astype(np.float32)
        stats[f"bn_{i}"]["var"] = rng.uniform(0.5, 2.0, size=h).astype(np.float32)
        for name in ("lin_query", "lin_key", "lin_value", "lin_skip"):
            b = params[f"conv_{i}"][name]["bias"]
            params[f"conv_{i}"][name]["bias"] = (
                0.1 * rng.normal(size=b.shape)).astype(np.float32)
    return model, params, stats


@functools.lru_cache(maxsize=None)
def _jax_forward(path, variant, dtype, exact_bn):
    """The JAX package's output (real rows) and the variables it ran."""
    edge, fuse = VARIANTS[variant]
    jcfg = JaxModelConfig(**CFG, compute_dtype=dtype, use_edge_attr=edge,
                          fuse_eval=fuse)
    jgraph = jax_build_graph(JaxFoamCase(path).load_mesh(), with_band=True,
                             band_components=LAYER_COMPONENTS["Transformer"])
    model, params, stats = _jax_variables(jcfg, jgraph)
    if exact_bn:
        ref = make_forward(model, exact_bn=True)(params, stats, jgraph)
    else:
        ref = model.apply({"params": params, "batch_stats": stats}, jgraph,
                          train=False)
    return np.asarray(ref)[: jgraph.n_nodes], jcfg, params, stats


def _port_forward(path, jcfg, params, stats, exact_bn):
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    port = FlowGNN(cfg)
    port.load_state_dict(state_dict_from_flax(params, stats, cfg))
    graph = load_graph(path, "Transformer")
    with torch.inference_mode():
        got = port(graph, exact_bn=exact_bn)
    assert got.dtype == torch.float32
    return got.numpy()[: graph.n_nodes]


# f32: the same f32 arithmetic in other summation orders through 2 layers,
# the BN and the MLP: 1e-5 of the largest output (measured 2.2e-6 geo,
# 5.6e-7 without edges).  Under exact_bn the batch statistics divide each
# channel by its batch std, which magnifies the geo logits' cancellation:
# qself − qd·pos_j cancels terms of size |pos|·(1/dist), up to 24 here
# (f32 loses ~24 ulp), against O(1) results; 5e-5 there (measured 2.15e-5
# geo, 3.9e-6 without edges).  bf16 and mixed: the port rounds at the
# kernel's points, the JAX package's eval (geo, head mean) projects on
# weights extracted as lin(eye) − lin(0), one bf16 ulp off W once a bias is
# nonzero; so the port is held no further from JAX f32 (L2 over the output)
# than 1.5 × JAX bf16's own distance (measured ratios 0.96–1.12).
F32_TOL = {False: 1e-5, True: 5e-5}
RATIO = 1.5


@pytest.mark.parametrize("exact_bn", [False, True], ids=["eval", "exact_bn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(case, variant, dtype, exact_bn):
    path = case[0]
    ref, jcfg, params, stats = _jax_forward(path, variant, dtype, exact_bn)
    got = _port_forward(path, jcfg, params, stats, exact_bn)
    assert np.isfinite(got).all()
    if dtype == "float32":
        tol = F32_TOL[exact_bn]
        np.testing.assert_allclose(got, ref, rtol=tol,
                                   atol=tol * np.abs(ref).max())
        return
    ref32 = _jax_forward(path, variant, "float32", exact_bn)[0]
    own = np.linalg.norm(ref - ref32)
    dist = np.linalg.norm(got - ref32)
    assert dist <= RATIO * own, (dist, own)


def test_from_jax_round_trip(case):
    jgraph = case[2]
    jcfg = JaxModelConfig(**CFG)
    _, params, stats = _jax_variables(jcfg, jgraph, seed=2)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    sd = state_dict_from_flax(params, stats, cfg)
    # every parameter and buffer of the port is carried, and nothing else
    assert sorted(sd) == sorted(FlowGNN(cfg).state_dict())
    got_params, got_stats = flax_tree_from_state_dict(sd, cfg)
    assert (jax.tree_util.tree_structure(got_params)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree.leaves(got_params), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(got_stats), jax.tree.leaves(stats)):
        np.testing.assert_array_equal(a, b)


def test_jax_saved_checkpoint_serves(case, tmp_path):
    path, info, jgraph = case
    jcfg = JaxModelConfig(**CFG)
    _, params, stats = _jax_variables(jcfg, jgraph, seed=1)
    norm = JaxNorm().fit(box_fields(info["cell_centers"]))
    state = types.SimpleNamespace(step=np.int32(0), params=params,
                                  batch_stats=stats,
                                  opt_state={"count": np.zeros(1, np.int32)})
    jax_save(tmp_path / "jax", "best", state, epoch=3, val_loss=0.5,
             model_config=jcfg, train_config={"lr": 1e-3}, normalizer=norm)
    _, want, _ = jax_predict_case(tmp_path / "jax", path, backend=None,
                                  exact_bn=False)

    restored, meta = jax_load(tmp_path / "jax", "best")
    cfg = ModelConfig.from_dict(meta["model_config"])
    assert cfg.layer_type == "Transformer"
    save_checkpoint(
        tmp_path / "port", "best",
        state_dict_from_flax(restored["params"], restored["batch_stats"], cfg),
        model_config=cfg,
        normalizer=FieldNormalizer.from_dict(meta["normalizer"]),
        epoch=meta["epoch"], val_loss=meta["val_loss"],
        train_config=meta["train_config"])
    _, got, graph = predict_case(tmp_path / "port", path, exact_bn=False,
                                 device="cpu")
    assert graph.n_nodes == info["n_cells"]
    assert graph.band.geo is not None and graph.band.edge is None
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        assert got[name].shape == w.shape
        # f32 forward (see F32_TOL), denormalized by the same std/mean
        np.testing.assert_allclose(got[name], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    # the recalibration runs the Transformer's train-mode forward (no
    # gradient, no dropout); the served fields stay finite
    _, again, _ = predict_case(tmp_path / "port", path, recalibrate_bn=True,
                               exact_bn=False, device="cpu")
    assert all(np.isfinite(v).all() for v in again.values())


def test_training_raises(case, tmp_path):
    """What is still not ported raises for the Transformer too (row 11
    under a gradient); its training forward runs and differentiates, and
    the dense backend and on-device epoch blocks (``--epoch_block 2``),
    which raised before they were ported, train it."""
    path = case[0]
    argv = ["train", "--case_path", str(path), "--time_dirs", "100",
            "--layer_type", "Transformer", "--device", "cpu",
            "--hidden_dim", "16", "--num_layers", "2"]
    assert cli_main([*argv, "--output_dir", str(tmp_path / "a"), "--backend",
                     "dense", "--epochs", "1"]) == 0
    out = tmp_path / "b"
    assert cli_main([*argv, "--output_dir", str(out), "--epochs", "2",
                     "--epoch_block", "2"]) == 0
    hist = json.loads((out / "training_history.json").read_text())
    assert hist["epoch"] == [1, 2] and np.isfinite(hist["train_loss"]).all()
    port = FlowGNN(ModelConfig(**{**CFG, "fuse_eval": True}))
    graph = load_graph(path, "Transformer")
    out = port(graph, train=True, generator=torch.Generator().manual_seed(0))
    out.sum().backward()
    grad = port.convs[0].lin_query.weight.grad
    assert grad is not None and torch.isfinite(grad).all()
    x = port.input_proj(graph.node_feat)
    with pytest.raises(NotImplementedError, match="eval form"):
        port.convs[0](x, graph)         # fuse_eval in eval, under a gradient
