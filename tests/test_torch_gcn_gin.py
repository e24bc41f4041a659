"""Port GCN and GIN serving path vs the JAX package, on the same weights.

* a JAX ``FlowGNN`` (GCN or GIN, ``backend='pallas'``, Pallas in interpret
  mode) initialized from a seed, its params carried by
  ``state_dict_from_flax``, gives the port's forward the same output — eval
  and ``exact_bn``; f32, bf16 and mixed;
* ``state_dict_from_flax`` and ``flax_tree_from_state_dict`` are inverse;
* ``predict_case`` end to end: a JAX-saved checkpoint (Orbax) and the port
  checkpoint carried from it give the same denormalized fields.

Small sizes: a 336-cell generated case, hidden 32, 2 layers.
"""

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

CFG = dict(hidden_dim=32, num_layers=2, backend="pallas", dropout=0.1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_gcn_gin") / "case"
    info = generate_box_case(path, 24, 14, 1)
    mesh = JaxFoamCase(path).load_mesh()
    jgraphs = {lt: jax_build_graph(mesh, with_band=True,
                                   band_components=LAYER_COMPONENTS[lt])
               for lt in ("GCN", "GIN")}
    return path, info, jgraphs


def _jax_variables(cfg, graph, seed=0):
    """Seeded flax init, with BN params and running stats made non-trivial
    from numpy so the affine is exercised."""
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
    return model, params, stats


# Tolerances, relative to the output's largest magnitude (as for GAT in
# test_torch_serve.py):
# - f32: the same f32 arithmetic in other summation orders (~1e-7 per op)
#   through 2 layers, the BN affine and the MLP;
# - mixed: one bf16 rounding (2^-8 relative) flipped by a different f32
#   summation order in a conv, damped by the f32 stream;
# - bf16: as mixed, and interpret-mode Pallas runs the bf16 epilogue without
#   its intermediate bf16 roundings (the JAX package's own test_epilogue.py
#   allows 5e-2 for that).
TOL = {"float32": 1e-5, "bfloat16": 5e-2, "mixed": 1e-2}


@pytest.mark.parametrize("exact_bn", [False, True], ids=["eval", "exact_bn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("layer", ["GCN", "GIN"])
def test_forward_matches_jax(case, layer, dtype, exact_bn):
    path, _, jgraphs = case
    jgraph = jgraphs[layer]
    jcfg = JaxModelConfig(**CFG, layer_type=layer, compute_dtype=dtype)
    model, params, stats = _jax_variables(jcfg, jgraph)
    if exact_bn:
        ref = make_forward(model, exact_bn=True)(params, stats, jgraph)
    else:
        ref = model.apply({"params": params, "batch_stats": stats}, jgraph,
                          train=False)
    ref = np.asarray(ref)[: jgraph.n_nodes]

    cfg = ModelConfig.from_dict(jcfg.to_dict())
    port = FlowGNN(cfg)
    port.load_state_dict(state_dict_from_flax(params, stats, cfg))
    with torch.inference_mode():
        got = port(load_graph(path, layer), exact_bn=exact_bn)
    assert got.dtype == torch.float32
    got = got.numpy()[: jgraph.n_nodes]
    assert np.isfinite(got).all()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale)


@pytest.mark.parametrize("layer", ["GCN", "GIN"])
def test_from_jax_round_trip(case, layer):
    _, _, jgraphs = case
    jcfg = JaxModelConfig(**CFG, layer_type=layer)
    _, params, stats = _jax_variables(jcfg, jgraphs[layer], seed=2)
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


@pytest.mark.parametrize("layer", ["GCN", "GIN"])
def test_jax_saved_checkpoint_serves(case, tmp_path, layer):
    path, info, jgraphs = case
    jcfg = JaxModelConfig(**CFG, layer_type=layer)
    _, params, stats = _jax_variables(jcfg, jgraphs[layer], seed=1)
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
    assert cfg.layer_type == layer
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
    assert graph.band.gcn is not None if layer == "GCN" \
        else graph.band.adj is not None
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        assert got[name].shape == w.shape
        # f32 forward (see TOL), denormalized by the same std/mean
        np.testing.assert_allclose(got[name], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_graph_without_the_plane_raises(case):
    """A ``pallas`` GCN on a band without its ``gcn`` plane no longer
    raises: it takes the dense branch, as the JAX module routes it, and
    gives the banded path's output (f32, summation order)."""
    path, _, _ = case
    port = FlowGNN(ModelConfig(**CFG, layer_type="GCN"))
    graph = load_graph(path, "GIN")
    assert graph.band.gcn is None and graph.band.adj is not None
    with torch.no_grad():
        got = port(graph)
        want = port(load_graph(path, "GCN"))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
