"""The reference's ``.pt`` checkpoints in the port, against the JAX package.

On a generated 24×14 box (336 cells), hidden 32, 2 layers, 4 heads:

* the port's copy of ``RefFlowGNN`` gives the JAX package's copy's outputs
  bit for bit, eval and train mode, for every conv form;
* a reference-format ``.pt`` of GCN, GAT, GIN, Transformer and Transformer
  with ``lin_edge``, written as the reference's ``train.py`` writes it,
  loads through the port's ``load_torch_checkpoint`` into the same
  parameters and config as the JAX package's, and the port's forward on
  ``pallas`` (JAX in interpret mode) and ``dense`` agrees with JAX
  ``FlowGNN.apply`` within f32 1e-5;
* the served, denormalized fields agree with ``RefFlowGNN``'s eval forward
  within the JAX package's parity bound (``tests/test_parity_torch.py``);
* ``export-torch`` writes CPU tensors that ``RefFlowGNN`` loads with
  ``strict=True`` and that the JAX package reads into the parameters its
  own export of the same weights gives;
* the ``backend`` argument of ``Predictor.from_checkpoint`` and
  ``predict_case``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.compat import torch_ref as jax_ref
from gnn_bfs_rans_tpu.compat.torch_port import (
    load_torch_checkpoint as jax_load_torch,
    save_torch_checkpoint as jax_save_torch,
)
from gnn_bfs_rans_tpu.foam import FoamCase as JaxFoamCase
from gnn_bfs_rans_tpu.graph.band import LAYER_COMPONENTS as JAX_COMPONENTS
from gnn_bfs_rans_tpu.graph.build import build_graph as jax_build_graph
from gnn_bfs_rans_tpu.models.flow_gnn import FlowGNN as JaxFlowGNN
from gnn_bfs_rans_tpu.models.flow_gnn import ModelConfig as JaxModelConfig
from gnn_bfs_rans_tpu_torch.cli.main import main
from gnn_bfs_rans_tpu_torch.compat.from_jax import flax_tree_from_state_dict
from gnn_bfs_rans_tpu_torch.compat.torch_port import (
    export_state_dict,
    load_torch_checkpoint,
)
from gnn_bfs_rans_tpu_torch.compat.torch_ref import RefFlowGNN
from gnn_bfs_rans_tpu_torch.foam import FoamCase, box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.graph.build import build_graph
from gnn_bfs_rans_tpu_torch.infer import (
    Predictor,
    load_graph,
    predict_case,
    resolve_backend,
)
from gnn_bfs_rans_tpu_torch.models.flow_gnn import (
    FlowGNN,
    ModelConfig,
    split_fields,
)
from gnn_bfs_rans_tpu_torch.train.checkpoint import save_checkpoint
from gnn_bfs_rans_tpu_torch.train.normalization import FieldNormalizer

FIELDS = ("U", "p", "k", "epsilon", "nut")
HIDDEN, LAYERS = 32, 2
# (id, layer type, edge_dim): the reference builds TransformerConv without
# edge_dim; the last form carries lin_edge
MODELS = (("GCN", "GCN", None), ("GAT", "GAT", None), ("GIN", "GIN", None),
          ("Transformer", "Transformer", None),
          ("Transformer-lin_edge", "Transformer", 4))
MODEL_IDS = [m[0] for m in MODELS]
# f32, port vs JAX and vs the reference model: the same arithmetic in other
# summation orders through 2 layers, BatchNorm and the MLP
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """The case, the unpermuted edge list the reference model reads, and a
    normalizer fitted on the case's fields."""
    path = tmp_path_factory.mktemp("torch_compat") / "case"
    info = generate_box_case(path, 24, 14, 1)
    g = build_graph(FoamCase(path).load_mesh(), reorder="none")
    n, ne = g.n_nodes, g.n_edges
    ref_in = (g.node_feat[:n],
              torch.stack([g.senders[:ne].long(), g.receivers[:ne].long()]),
              g.edge_feat[:ne])
    norm = FieldNormalizer().fit(box_fields(info["cell_centers"]))
    return path, info, ref_in, norm


def _ref_model(layer_type, edge_dim, seed=0, module=RefFlowGNN):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return module(input_dim=3, hidden_dim=HIDDEN, output_dim=7,
                      num_layers=LAYERS, layer_type=layer_type, dropout=0.1,
                      edge_dim=edge_dim)


def _reference_pt(path, model, layer_type, norm):
    """The dict the reference's training loop saves (``train.py:453-461``)."""
    torch.save({
        "epoch": 100,
        "model_state_dict": model.state_dict(),
        "optimizer_state_dict": {},
        "val_loss": 0.123,
        "config": {"hidden_dim": HIDDEN, "num_layers": LAYERS,
                   "layer_type": layer_type, "dropout": 0.1, "lr": 3e-4},
        "normalizer": {"field_stats": norm.field_stats,
                       "scalers": norm.scalers},
    }, path)


@pytest.fixture(scope="module")
def checkpoints(box, tmp_path_factory):
    """Per model: the .pt path and RefFlowGNN's eval output, its BatchNorm
    statistics warmed by three train-mode forwards."""
    _, _, (x, ei, ea), norm = box
    out = {}
    root = tmp_path_factory.mktemp("reference_pt")
    for mid, layer_type, edge_dim in MODELS:
        model = _ref_model(layer_type, edge_dim)
        with torch.random.fork_rng(), torch.no_grad():
            torch.manual_seed(1)
            model.train()
            for _ in range(3):
                model(x, ei, ea)
        model.eval()
        with torch.no_grad():
            ref_out = model(x, ei, ea).numpy()
        path = root / f"{mid}.pt"
        _reference_pt(path, model, layer_type, norm)
        out[mid] = (path, ref_out)
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mid,layer_type,edge_dim", MODELS, ids=MODEL_IDS)
def test_ref_flow_gnn_copy_is_bit_identical(box, mid, layer_type, edge_dim,
                                            train):
    _, _, (x, ei, ea), _ = box
    ours = _ref_model(layer_type, edge_dim)
    theirs = _ref_model(layer_type, edge_dim, module=jax_ref.RefFlowGNN)
    assert list(ours.state_dict()) == list(theirs.state_dict())
    for k, v in theirs.state_dict().items():
        assert torch.equal(ours.state_dict()[k], v), k
    outs = []
    for model in (ours, theirs):
        model.train(train)
        with torch.random.fork_rng(), torch.no_grad():
            torch.manual_seed(2)
            outs.append(model(x, ei, ea))
    assert torch.equal(outs[0], outs[1])


def _jax_graph(path, layer_type, backend):
    mesh = JaxFoamCase(path).load_mesh()
    if backend == "pallas":
        return jax_build_graph(mesh, with_band=True,
                               band_components=JAX_COMPONENTS[layer_type])
    return jax_build_graph(mesh)


@pytest.mark.parametrize("backend", ["pallas", "dense"])
@pytest.mark.parametrize("mid", MODEL_IDS)
def test_load_matches_jax(box, checkpoints, mid, backend):
    """Same config, same parameter tree, same forward as the JAX package."""
    path, _, _, _ = box
    pt, _ = checkpoints[mid]
    params, stats, jcfg, jnorm = jax_load_torch(str(pt))
    state, cfg, norm = load_torch_checkpoint(pt)
    assert cfg == ModelConfig.from_dict(jcfg.to_dict())
    assert cfg.use_edge_attr is (mid == "Transformer-lin_edge")
    ours, our_stats = flax_tree_from_state_dict(state, cfg)
    flat = dict(zip(*_flatten(params))), dict(zip(*_flatten(ours)))
    assert flat[0].keys() == flat[1].keys()
    for k in flat[0]:
        assert np.array_equal(flat[0][k], flat[1][k]), k
    for k in stats:
        for s in ("mean", "var"):
            assert np.array_equal(stats[k][s], our_stats[k][s])
    assert norm.scalers.keys() == jnorm.scalers.keys()

    jgraph = _jax_graph(path, cfg.layer_type, backend)
    want = np.asarray(JaxFlowGNN(dataclasses.replace(jcfg, backend=backend))
                      .apply({"params": params, "batch_stats": stats},
                             jgraph, train=False))[: jgraph.n_nodes]
    model = FlowGNN(dataclasses.replace(cfg, backend=backend))
    model.load_state_dict(state)
    with torch.inference_mode():
        got = model.eval()(load_graph(path, cfg.layer_type, backend=backend))
    got = got.numpy()[: jgraph.n_nodes]
    np.testing.assert_allclose(got, want, rtol=F32_TOL,
                               atol=F32_TOL * np.abs(want).max())


def _flatten(tree, prefix=""):
    keys, vals = [], []
    for k, v in tree.items():
        if isinstance(v, dict):
            kk, vv = _flatten(v, f"{prefix}{k}/")
            keys += kk
            vals += vv
        else:
            keys.append(prefix + k)
            vals.append(np.asarray(v))
    return keys, vals


def _assert_parity_bound(got_packed, ref_packed, norm):
    """The JAX package's bound (``tests/test_parity_torch.py:116-139``):
    normalized outputs within rtol 1e-3, atol 5e-4; denormalized fields
    within rtol 1e-3, atol 1e-3·max|field| + 1e-3·std of the field."""
    np.testing.assert_allclose(got_packed, ref_packed, rtol=1e-3, atol=5e-4)
    ours = norm.inverse_transform(split_fields(got_packed))
    theirs = norm.inverse_transform(split_fields(ref_packed))
    for f in FIELDS:
        std_f = float(np.max(np.asarray(norm.scalers[f]["std"])))
        scale = float(np.abs(theirs[f]).max()) + 1e-12
        np.testing.assert_allclose(ours[f], theirs[f], rtol=1e-3,
                                   atol=1e-3 * scale + 1e-3 * std_f,
                                   err_msg=f)


@pytest.mark.parametrize("mid", MODEL_IDS)
def test_served_fields_match_ref_flow_gnn(box, checkpoints, mid):
    """A reference .pt served through the port's Predictor (backend 'auto':
    pallas, the kernels' plain versions here) on the RCM-ordered graph,
    fields back in cell order, against RefFlowGNN on the unpermuted one."""
    path, info, _, norm = box
    pt, ref_out = checkpoints[mid]
    pred = Predictor.from_torch_checkpoint(pt, device="cpu")
    assert pred.model_config.backend == "pallas" and not pred.exact_bn
    graph = load_graph(path, pred.model_config.layer_type)
    assert graph.band is not None and graph.perm is not None
    fields = pred.predict_fields(graph)
    assert fields["U"].shape == (info["n_cells"], 3)
    got = np.concatenate([fields[f].reshape(len(fields[f]), -1)
                          for f in FIELDS], axis=1)
    mean, std = norm.packed_mean_std()
    _assert_parity_bound((got - mean) / std, ref_out, norm)


def _port_checkpoint(tmp_path, layer_type, seed=3, **cfg):
    cfg = ModelConfig(hidden_dim=HIDDEN, num_layers=LAYERS,
                      layer_type=layer_type, backend="pallas", **cfg)
    model = FlowGNN(cfg, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    state = model.state_dict()
    for k, v in state.items():  # every bias away from its zero init
        if k.endswith("bias"):
            state[k] = torch.from_numpy(
                rng.uniform(-0.1, 0.1, v.shape).astype(np.float32))
    for i in range(LAYERS):     # BatchNorm away from the identity
        for name, lo, hi in (("weight", 0.8, 1.2), ("bias", -0.1, 0.1),
                             ("running_mean", -0.3, 0.3),
                             ("running_var", 0.5, 2.0)):
            key = f"norms.{i}.{name}"
            if key in state:
                state[key] = torch.from_numpy(
                    rng.uniform(lo, hi, HIDDEN).astype(np.float32))
    model.load_state_dict(state)
    return model, cfg


# (layer type, use_edge_attr): the Transformer at the ModelConfig default
# (with lin_edge) and without edge attributes, as the reference builds it
@pytest.mark.parametrize("layer_type,edges", [
    ("GCN", True), ("GAT", True), ("GIN", True), ("Transformer", True),
    ("Transformer", False)], ids=["GCN", "GAT", "GIN", "Transformer",
                                  "Transformer-no_edges"])
def test_export_torch_round_trip(box, tmp_path, capsys, layer_type, edges):
    path, info, (x, ei, ea), norm = box
    model, cfg = _port_checkpoint(tmp_path, layer_type, use_edge_attr=edges)
    save_checkpoint(tmp_path / "ckpt", "best", model.state_dict(),
                    model_config=cfg, normalizer=norm, epoch=3, val_loss=0.9,
                    train_config={"lr": 1e-3, "epochs": 7})
    out = tmp_path / "exported.pt"
    assert main(["export-torch", "--checkpoint", str(tmp_path / "ckpt"),
                 "--output", str(out)]) == 0
    assert "reference torch format" in capsys.readouterr().out
    raw = torch.load(out, map_location="cpu", weights_only=False)
    assert raw["epoch"] == 3 and raw["optimizer_state_dict"] == {}
    # a Transformer with lin_edge names the edge width its TransformerConv
    # must be built with
    with_lin_edge = layer_type == "Transformer" and edges
    assert raw["config"] == {"hidden_dim": HIDDEN, "num_layers": LAYERS,
                             "layer_type": layer_type, "dropout": 0.1,
                             "lr": 1e-3, "epochs": 7,
                             **({"edge_dim": 4} if with_lin_edge else {})}
    assert with_lin_edge == any("lin_edge" in k
                                for k in raw["model_state_dict"])
    assert all(v.device.type == "cpu"
               for v in raw["model_state_dict"].values())

    # the reference model, built from the exported config, loads it
    # strictly; its forward is the port's
    ref = RefFlowGNN(hidden_dim=HIDDEN, num_layers=LAYERS,
                     layer_type=layer_type,
                     edge_dim=raw["config"].get("edge_dim"))
    ref.load_state_dict(raw["model_state_dict"], strict=True)
    with torch.no_grad():
        want = ref.eval()(x, ei, ea).numpy()
    pred = Predictor.from_checkpoint(tmp_path / "ckpt", device="cpu")
    got = pred.predict_packed(load_graph(path, layer_type))
    np.testing.assert_allclose(got, want, rtol=F32_TOL,
                               atol=F32_TOL * np.abs(want).max())

    # the JAX package reads it into the parameters its own export gives
    params, stats = flax_tree_from_state_dict(model.state_dict(), cfg)
    jax_out = tmp_path / "jax_exported.pt"
    jax_save_torch(str(jax_out), params, stats,
                   JaxModelConfig.from_dict(cfg.to_dict()))
    ours, theirs = jax_load_torch(str(out)), jax_load_torch(str(jax_out))
    for tree in (0, 1):
        a, b = dict(zip(*_flatten(ours[tree]))), dict(zip(*_flatten(
            theirs[tree])))
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert ours[2] == theirs[2]
    assert ours[3].scalers.keys() == norm.scalers.keys()


@pytest.mark.parametrize("case", ["layer_norm", "gin_eps"])
def test_what_the_reference_format_cannot_express_raises(box, tmp_path, case):
    if case == "layer_norm":
        model, cfg = _port_checkpoint(tmp_path, "GCN", norm_type="layer")
        with pytest.raises(ValueError, match="LayerNorm"):
            export_state_dict(model.state_dict(), cfg)
        return
    model = _ref_model("GIN", None)
    model.gnn_layers[1].eps.fill_(0.5)
    _reference_pt(tmp_path / "gin.pt", model, "GIN", box[3])
    with pytest.raises(ValueError, match="eps"):
        load_torch_checkpoint(tmp_path / "gin.pt")


@pytest.mark.parametrize("recalibrated", [False, True],
                         ids=["plain", "recalibrated"])
@pytest.mark.parametrize("backend", ["pallas", "dense", "segment", None,
                                     "auto"])
def test_backend_override(box, tmp_path, backend, recalibrated):
    """A name overrides the checkpoint's backend, None keeps it, 'auto'
    serves on pallas unless the checkpoint was saved BN-recalibrated; the
    graph gets a band only for pallas, and every backend serves the same
    fields."""
    path, _, _, norm = box
    model, cfg = _port_checkpoint(tmp_path, "GAT")
    cfg = dataclasses.replace(cfg, backend="segment")
    save_checkpoint(tmp_path / "ckpt", "best", model.state_dict(),
                    model_config=cfg, normalizer=norm,
                    extra={"bn_recalibrated": True} if recalibrated else None)
    want = {"pallas": "pallas", "dense": "dense", "segment": "segment",
            None: "segment", "auto": "segment" if recalibrated else "pallas"}
    assert resolve_backend(backend, "segment", recalibrated) == want[backend]
    pred, fields, graph = predict_case(tmp_path / "ckpt", path,
                                       backend=backend, exact_bn=False,
                                       device="cpu")
    assert pred.model_config.backend == want[backend]
    assert (graph.band is not None) == (want[backend] == "pallas")
    ref = Predictor.from_checkpoint(tmp_path / "ckpt", backend="segment",
                                    exact_bn=False, device="cpu")
    ref_fields = ref.predict_fields(load_graph(path, "GAT",
                                               backend="segment"))
    for f in FIELDS:
        np.testing.assert_allclose(
            fields[f], ref_fields[f], rtol=F32_TOL,
            atol=F32_TOL * np.abs(ref_fields[f]).max())
    meta = json.loads((tmp_path / "ckpt" / "best.meta.json").read_text())
    assert meta["model_config"]["backend"] == "segment"
