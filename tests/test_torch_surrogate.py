"""The port's ``FlowGNNSurrogate`` (encoder-decoder, additive boundary
embedding) against the JAX package's, on the same weights.

The configurations of ``tests/test_surrogate.py`` (GCN 4 layers hidden 16
on ``segment``; GCN 2 layers with a 0.5 boundary embedding; GIN on
``dense`` without normalization), and a GAT and a GCN on ``pallas`` over a
small banded box (the kernels' plain versions here, JAX in interpret
mode), the GCN's gradient in train mode.  Weights: a seeded flax init with
non-trivial BatchNorm parameters and statistics, carried across with
``compat/from_jax.py``.

* the forward agrees with JAX's within 1e-5 of its largest output (f32);
* the gradient of an MSE over the real rows agrees with ``jax.grad``
  within 1e-4 of the tree's largest entry, leaf by leaf (in train mode
  the conv biases before a BatchNorm have a gradient that is zero in
  exact arithmetic, whose rounding noise is all either side computes);
* the parameter trees round-trip exactly, and carry every parameter and
  buffer of the port's module.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.foam import FoamCase as JaxFoamCase
from gnn_bfs_rans_tpu.graph.build import build_graph as jax_build_graph
from gnn_bfs_rans_tpu.models.flow_gnn import (
    FlowGNNSurrogate as JaxSurrogate,
)
from gnn_bfs_rans_tpu.models.flow_gnn import ModelConfig as JaxModelConfig
from gnn_bfs_rans_tpu_torch.compat.from_jax import (
    surrogate_flax_from_state_dict,
    surrogate_state_dict_from_flax,
)
from gnn_bfs_rans_tpu_torch.foam import generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
from gnn_bfs_rans_tpu_torch.infer import load_graph
from gnn_bfs_rans_tpu_torch.models import FlowGNNSurrogate
from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# label: (config, boundary embedding, train-mode gradient)
CONFIGS = {
    "gcn4-segment": (dict(num_layers=4, layer_type="GCN",
                          backend="segment"), None, False),
    "gcn2-bc": (dict(num_layers=2, layer_type="GCN", backend="segment"),
                0.5, False),
    "gin-dense-nonorm": (dict(num_layers=2, layer_type="GIN",
                              backend="dense", use_batch_norm=False),
                         None, False),
    # eval mode: at hidden 16 this GAT's train-mode gradient moves by up
    # to 7e-3 of its largest entry when the input moves by one ulp (ReLU
    # flips in the output MLPs, the port alone), a floor no 1e-4 limit can
    # hold; its training kernels are held against JAX by
    # test_torch_train.py
    "gat-pallas": (dict(num_layers=2, layer_type="GAT", heads=2,
                        backend="pallas"), 0.5, False),
    "gcn-pallas": (dict(num_layers=2, layer_type="GCN", backend="pallas"),
                   None, True),
}


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_surrogate") / "box"
    generate_box_case(path, 24, 14, 1)
    return path, JaxFoamCase(path).load_mesh()


@pytest.fixture(scope="module")
def setups(box):
    """``setups(label)``: :func:`_setup` of ``label``, made once."""
    made = {}

    def get(label):
        if label not in made:
            made[label] = _setup(box, label)
        return made[label]

    return get


def _setup(box, label, seed=0):
    """(JAX model, params, stats, JAX graph, port model, port graph,
    boundary embedding or None, targets, train flag, port config)."""
    path, mesh = box
    kw, bc_value, train = CONFIGS[label]
    jcfg = JaxModelConfig(hidden_dim=16, dropout=0.0, **kw)
    jgraph = jax_build_graph(mesh, with_band=True,
                             band_components=LAYER_COMPONENTS[jcfg.layer_type])
    model = JaxSurrogate(jcfg)
    variables = model.init(jax.random.PRNGKey(seed), jgraph, train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))
    rng = np.random.default_rng(seed)
    for stage in stats:
        for bn in stats[stage]:
            h = stats[stage][bn]["mean"].shape[0]
            params[stage][bn]["scale"] = (
                1 + 0.1 * rng.normal(size=h)).astype(np.float32)
            params[stage][bn]["bias"] = (0.1 * rng.normal(size=h)).astype(
                np.float32)
            stats[stage][bn]["mean"] = (0.5 * rng.normal(size=h)).astype(
                np.float32)
            stats[stage][bn]["var"] = rng.uniform(0.5, 2.0, size=h).astype(
                np.float32)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    port = FlowGNNSurrogate(cfg)
    port.load_state_dict(surrogate_state_dict_from_flax(params, stats, cfg))
    graph = load_graph(path, cfg.layer_type)
    n_pad = jgraph.n_pad
    bc = (None if bc_value is None
          else np.full((n_pad, 16), bc_value, np.float32))
    targets = (0.1 * rng.normal(size=(n_pad, 7))).astype(np.float32)
    return (model, params, stats, jgraph, port, graph, bc, targets, train,
            cfg)


def _jax_out(model, params, stats, jgraph, bc, train):
    variables = {"params": params, "batch_stats": stats}
    bc = None if bc is None else jnp.asarray(bc)
    if train:
        out, _ = model.apply(variables, jgraph, boundary_conditions=bc,
                             train=True, mutable=["batch_stats"])
        return out
    return model.apply(variables, jgraph, boundary_conditions=bc,
                       train=False)


@pytest.mark.parametrize("label", list(CONFIGS))
def test_forward_matches_jax(setups, label):
    model, params, stats, jgraph, port, graph, bc, _, _, _ = setups(label)
    ref = np.asarray(_jax_out(model, params, stats, jgraph, bc, False))
    with torch.no_grad():
        got = port(graph, None if bc is None else torch.from_numpy(bc))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    n = jgraph.n_nodes
    got = got.numpy()[:n]
    ref = ref[:n]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=FWD_TOL * np.abs(ref).max())
    if bc is not None:
        # the embedding moves the output
        with torch.no_grad():
            plain = port(graph).numpy()[:n]
        assert np.abs(plain - got).max() > 1e-6


@pytest.mark.parametrize("label", list(CONFIGS))
def test_mse_gradient_matches_jax_grad(setups, label):
    (model, params, stats, jgraph, port, graph, bc, targets, train,
     cfg) = setups(label)
    n = jgraph.n_nodes       # the real rows: padding rows are no output
    tg = jnp.asarray(targets[:n])

    def jax_loss(p):
        out = _jax_out(model, p, stats, jgraph, bc, train)
        return jnp.mean((out[:n] - tg) ** 2)

    want = jax.grad(jax_loss)(jax.tree.map(jnp.asarray, params))
    port = copy.deepcopy(port)      # the shared module stays as made
    port.train(train)
    out = port(graph, None if bc is None else torch.from_numpy(bc),
               train=train)
    ((out[:n] - torch.from_numpy(targets[:n])) ** 2).mean().backward()
    got, _ = surrogate_flax_from_state_dict(
        {k: p.grad for k, p in port.named_parameters()}, cfg)
    flat_w = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(flat_g) == sorted(flat_w)
    g_max = max(np.abs(v).max() for v in flat_w.values())
    for k, w in flat_w.items():
        err = np.abs(flat_g[k] - w).max()
        assert err <= GRAD_TOL * g_max, (label, k, err, g_max)


@pytest.mark.parametrize("label", list(CONFIGS))
def test_parameter_trees_round_trip(setups, label):
    _, params, stats, _, port, _, _, _, _, cfg = setups(label)
    sd = surrogate_state_dict_from_flax(params, stats, cfg)
    assert sorted(sd) == sorted(port.state_dict())
    p2, s2 = surrogate_flax_from_state_dict(sd, cfg)
    for a, b in ((params, p2), (stats, s2)):
        fa = jax.tree_util.tree_flatten_with_path(a)
        fb = jax.tree_util.tree_flatten_with_path(b)
        assert fa[1] == fb[1]
        for (ka, va), (kb, vb) in zip(fa[0], fb[0]):
            assert ka == kb and np.array_equal(np.asarray(va), vb)
