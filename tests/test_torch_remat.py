"""``ModelConfig.remat`` in the port's training (``models/flow_gnn.py``:
each conv under ``torch.utils.checkpoint``) on the CPU.

* a remat step equals the step without remat bit for bit (loss, every
  parameter and statistic after the step) from the same weights and
  generator, with dropout 0.1, and leaves the generator in the same state:
  GAT ``pallas`` unfused and fused, Transformer ``pallas``, GCN ``dense``,
  and the GAT and Transformer on ``dense`` (their attention masks drawn
  inside the conv, replayed by ``kernels/dropout.py::MaskTape``); each
  conv's forward runs twice a step under remat (the recompute);
* at dropout 0 the remat step equals the JAX package's remat step
  (``make_train_step`` of a ``remat=True`` model; Pallas in interpret
  mode) within ``PERF.md`` §2's f32 limits: GCN ``dense``, GAT
  ``pallas`` unfused, Transformer ``pallas`` (geo planes).

A 16 × 16 grid (256 cells, two 128-row tiles), hidden 16, 2 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.models.flow_gnn import FlowGNN as JaxFlowGNN
from gnn_bfs_rans_tpu.models.flow_gnn import ModelConfig as JaxModelConfig
from gnn_bfs_rans_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_bfs_rans_tpu.train.loop import TrainState, make_optimizer
from gnn_bfs_rans_tpu.train.loop import make_train_step
from gnn_bfs_rans_tpu.utils.synthetic import (
    build_grid_graph as jax_build_grid_graph,
)
from gnn_bfs_rans_tpu_torch.compat.from_jax import (
    flax_tree_from_state_dict,
    state_dict_from_flax,
)
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig, train_step
from gnn_bfs_rans_tpu_torch.train.loop import make_optimizer as port_optimizer
from gnn_bfs_rans_tpu_torch.utils.synthetic import build_grid_graph

NX = NY = 16
LR = 1e-3
MODELS = {
    "gat-pallas-unfused": dict(layer_type="GAT", backend="pallas",
                               fuse_train=False),
    "gat-pallas": dict(layer_type="GAT", backend="pallas"),
    "transformer-pallas": dict(layer_type="Transformer", backend="pallas"),
    "gcn-dense": dict(layer_type="GCN", backend="dense"),
    "gat-dense": dict(layer_type="GAT", backend="dense"),
    "transformer-dense": dict(layer_type="Transformer", backend="dense"),
}
JAX_MODELS = ("gcn-dense", "gat-pallas-unfused", "transformer-pallas")




@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes run fastest on one thread, and leave the cores to the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(layer_type, jax_side=False):
    build = jax_build_grid_graph if jax_side else build_grid_graph
    return build(NX, NY, with_band=True,
                 band_components=LAYER_COMPONENTS[layer_type])


def _targets(n_pad):
    return np.random.default_rng(3).normal(size=(1, n_pad, 7)).astype(
        np.float32)


def _step(cfg, graph, targets, gen, count=None):
    model = FlowGNN(cfg, torch.Generator().manual_seed(1))
    if count is not None:
        # (module hooks do not fire in checkpoint's recompute)
        for conv in model.convs:
            def counted(*a, _fwd=conv.forward, **kw):
                count.append(1)
                return _fwd(*a, **kw)

            conv.forward = counted
    loss = train_step(model, port_optimizer(model, TrainConfig()), graph,
                      torch.from_numpy(targets), LR, TrainConfig(), gen)
    return loss, model


@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_step_equals_plain_step(name):
    graph = _grid(MODELS[name]["layer_type"])
    targets = _targets(graph.n_pad)
    runs = {}
    for remat in (False, True):
        cfg = ModelConfig(hidden_dim=16, num_layers=2, heads=2, dropout=0.1,
                          remat=remat, **MODELS[name])
        gen = torch.Generator().manual_seed(7)
        calls = []
        loss, model = _step(cfg, graph, targets, gen, calls)
        runs[remat] = (loss, model.state_dict(), gen.get_state(), len(calls))
    (l0, s0, g0, n0), (l1, s1, g1, n1) = runs[False], runs[True]
    assert l0.item() == l1.item()
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    # the generator advanced exactly as without remat
    assert torch.equal(g0, g1)
    # each conv ran again in the backward
    assert (n0, n1) == (2, 4)


@pytest.mark.parametrize("name", JAX_MODELS)
def test_remat_step_matches_jax(name):
    kw = MODELS[name]
    jcfg = JaxModelConfig(hidden_dim=16, num_layers=2, heads=2, dropout=0.0,
                          remat=True, **kw)
    jtcfg = JaxTrainConfig(lr=LR)
    jgraph = _grid(kw["layer_type"], jax_side=True)
    targets = _targets(jgraph.n_pad)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    start = FlowGNN(cfg, torch.Generator().manual_seed(1))
    params, stats = flax_tree_from_state_dict(start.state_dict(), cfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats,
                       opt_state=make_optimizer(jtcfg).init(params))
    new, want_loss = make_train_step(JaxFlowGNN(jcfg), jtcfg)(
        state, jgraph, jnp.asarray(targets), jnp.float32(LR),
        jax.random.PRNGKey(0))

    model = FlowGNN(cfg)
    model.load_state_dict(state_dict_from_flax(params, stats, cfg))
    loss = train_step(model, port_optimizer(model, TrainConfig()),
                      _grid(kw["layer_type"]), torch.from_numpy(targets), LR,
                      TrainConfig())
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got, _ = flax_tree_from_state_dict(model.state_dict(), cfg)
    grads, _ = flax_tree_from_state_dict(
        {**model.state_dict(),
         **{k: p.grad for k, p in model.named_parameters()}}, cfg)
    g, mine = _leaves(grads), _leaves(got)
    g_max = max(np.abs(v).max() for v in g.values())
    for k, w in _leaves(new.params).items():
        # Adam's first step: compared where the gradient is firm (a zero
        # gradient in exact arithmetic moves an entry by a coin toss of lr)
        firm = np.abs(g[k]) > 1e-6 * g_max
        err = np.abs(mine[k] - w)[firm].max(initial=0.0)
        assert err <= 1e-4 * np.abs(w).max(), f"{name} {k}: {err}"


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
