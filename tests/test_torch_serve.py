"""Port GAT serving path vs the JAX package, on the same weights.

(d) a JAX ``FlowGNN`` (GAT, ``backend='pallas'``, Pallas in interpret mode)
    initialized from a seed, its params carried by ``state_dict_from_flax``,
    gives the port's forward the same output — eval and ``exact_bn``; f32,
    bf16 and mixed;
(e) ``predict_case`` end to end: a JAX checkpoint (Orbax) and the port
    checkpoint carried from it give the same denormalized fields.

Small sizes: a 336-cell generated case, hidden 32, 2 heads, 2 layers.
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
from gnn_bfs_rans_tpu.train.normalization import pack_targets as jax_pack
from gnn_bfs_rans_tpu_torch.compat.from_jax import state_dict_from_flax
from gnn_bfs_rans_tpu_torch.foam import box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.infer import load_graph, predict_case
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.train.checkpoint import save_checkpoint
from gnn_bfs_rans_tpu_torch.train.normalization import (
    FieldNormalizer,
    pack_targets,
)

CFG = dict(hidden_dim=32, num_layers=2, layer_type="GAT", heads=2,
           backend="pallas", dropout=0.1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_serve") / "case"
    info = generate_box_case(path, 24, 14, 1)
    return path, info


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


# Tolerances, relative to the output's largest magnitude:
# - f32: the same f32 arithmetic in other summation orders (~1e-7 per op)
#   through 2 layers, the BN affine and the MLP (measured ~1e-6);
# - mixed: one bf16 rounding (2^-8 relative) flipped by a different f32
#   summation order in a conv, damped by the f32 stream (measured ~1e-7);
# - bf16: as mixed, and interpret-mode Pallas runs the bf16 epilogue without
#   its intermediate bf16 roundings (the JAX package's own test_epilogue.py
#   allows 5e-2 for that); measured ~1e-2 under exact_bn.
TOL = {"float32": 1e-5, "bfloat16": 5e-2, "mixed": 1e-2}


@pytest.mark.parametrize("exact_bn", [False, True], ids=["eval", "exact_bn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
def test_forward_matches_jax(case, dtype, exact_bn):
    path, _ = case
    jcfg = JaxModelConfig(**CFG, compute_dtype=dtype)
    jgraph = jax_build_graph(JaxFoamCase(path).load_mesh(), with_band=True,
                             band_components=("bias_self",))
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
        got = port(load_graph(path), exact_bn=exact_bn)
    assert got.dtype == torch.float32
    got = got.numpy()[: jgraph.n_nodes]
    assert np.isfinite(got).all()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale)


@pytest.mark.parametrize("exact_bn", [False, "auto"])
def test_predict_case_matches_jax(case, tmp_path, exact_bn):
    path, info = case
    jcfg = JaxModelConfig(**CFG)
    jgraph = jax_build_graph(JaxFoamCase(path).load_mesh(), with_band=True,
                             band_components=("bias_self",))
    _, params, stats = _jax_variables(jcfg, jgraph, seed=1)
    norm = JaxNorm().fit(box_fields(info["cell_centers"]))
    state = types.SimpleNamespace(step=np.int32(0), params=params,
                                  batch_stats=stats,
                                  opt_state={"count": np.zeros(1, np.int32)})
    jax_save(tmp_path / "jax", "best", state, epoch=3, val_loss=0.5,
             model_config=jcfg, train_config={"lr": 1e-3}, normalizer=norm,
             extra={"bn_recalibrated": True})
    _, want, _ = jax_predict_case(tmp_path / "jax", path, backend=None,
                                  exact_bn=exact_bn)

    restored, meta = jax_load(tmp_path / "jax", "best")
    cfg = ModelConfig.from_dict(meta["model_config"])
    save_checkpoint(
        tmp_path / "port", "best",
        state_dict_from_flax(restored["params"], restored["batch_stats"], cfg),
        model_config=cfg,
        normalizer=FieldNormalizer.from_dict(meta["normalizer"]),
        epoch=meta["epoch"], val_loss=meta["val_loss"],
        train_config=meta["train_config"],
        extra={"bn_recalibrated": meta["bn_recalibrated"]})
    predictor, got, graph = predict_case(tmp_path / "port", path,
                                         exact_bn=exact_bn, device="cpu")
    assert predictor.exact_bn is (exact_bn == "auto")
    assert graph.n_nodes == info["n_cells"]
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        assert got[name].shape == w.shape
        # f32 forward (see TOL), denormalized by the same std/mean
        np.testing.assert_allclose(got[name], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_normalizer_matches_jax(case):
    _, info = case
    fields = box_fields(info["cell_centers"])
    fields["p"] = np.full_like(fields["p"], 2.0)   # std 0 → floored to 1
    ref = JaxNorm().fit(fields)
    norm = FieldNormalizer.from_dict(FieldNormalizer().fit(fields).to_dict())
    assert norm.to_dict() == ref.to_dict()
    z = norm.transform(fields)
    want = ref.transform(fields)
    for k in fields:
        np.testing.assert_array_equal(z[k], want[k])
        np.testing.assert_allclose(norm.inverse_transform(z)[k], fields[k],
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(pack_targets(z), jax_pack(want))


def test_predictor_keeps_the_forwards_of_its_latest_graphs(case, tmp_path):
    """``predict_packed`` keeps one forward (on the card, one CUDA graph)
    per graph object for the ``FORWARDS_KEPT`` graphs used last, the
    least recently used dropped first, and each call's fields are the
    model's whichever forward serves it."""
    from gnn_bfs_rans_tpu_torch.infer import FORWARDS_KEPT, Predictor

    path = case[0]
    cfg = ModelConfig(**CFG)
    save_checkpoint(tmp_path / "ckpt", "best", FlowGNN(cfg).state_dict(),
                    model_config=cfg, normalizer=None)
    pred = Predictor.from_checkpoint(tmp_path / "ckpt", device="cpu")
    graphs = [load_graph(path, "GAT") for _ in range(FORWARDS_KEPT + 2)]
    want = pred.predict_packed(graphs[0])
    for g in [*graphs, graphs[-1], graphs[0]]:
        np.testing.assert_array_equal(pred.predict_packed(g), want)
    kept = [entry[0] for entry in pred._forwards.values()]
    assert len(kept) == FORWARDS_KEPT
    # the latest use last: graph 0, dropped by graph 8, came back and
    # dropped graph 2
    assert kept[-1] is graphs[0] and kept[-2] is graphs[-1]
    assert not any(g is graphs[1] or g is graphs[2] for g in kept)
