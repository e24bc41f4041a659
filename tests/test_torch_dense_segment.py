"""The port's ``dense`` and ``segment`` backends vs the JAX package (CPU).

* every conv (GCN, GIN, GAT head mean and concat, Transformer with edge
  features in head mean and concat, and without) on the ``dense`` and
  ``segment`` branches, f32 and bf16, against the JAX conv of the same
  backend on the same weights (carried by ``conv_state_dict_from_flax``)
  and the same graph: f32 within 1e-5 of the output's max; bf16 no further
  from the JAX f32 conv than 1.5 × the JAX bf16 conv's own distance (the
  ratio rule of ``PERF.md`` §2); the output dtype equal to JAX's (f32 for
  GCN, GAT and the Transformer in bf16, where the f32 softmax or
  coefficients meet bf16 values; bf16 for GIN);
* FlowGNN forwards on ``dense`` and ``segment`` with BatchNorm and
  LayerNorm in f32, bf16 and mixed (eval and ``exact_bn``): f32 within
  1e-5, bf16 and mixed by the 1.5× ratio rule to JAX's own distance;
* the ``ops/segment.py`` primitives on empty segments (−inf max, 0 sum,
  the −1e30 and 1e-16 clamps of ``edge_softmax``);
* attention dropout on these branches, which JAX draws from
  ``jax.random.bernoulli`` and torch cannot reproduce: the masks have the
  JAX shapes, keep within a binomial bound of 1 − rate, the same generator
  state replays the same mask and another state gives another.

Small sizes: a 336-cell generated box, hidden 16, 4 heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.foam import FoamCase as JaxFoamCase
from gnn_bfs_rans_tpu.graph.build import build_graph as jax_build_graph
from gnn_bfs_rans_tpu.models import convs as jconvs
from gnn_bfs_rans_tpu.models.flow_gnn import FlowGNN as JaxFlowGNN
from gnn_bfs_rans_tpu.models.flow_gnn import ModelConfig as JaxModelConfig
from gnn_bfs_rans_tpu.ops import segment as jsops
from gnn_bfs_rans_tpu_torch.compat.from_jax import (
    conv_state_dict_from_flax,
    state_dict_from_flax,
)
from gnn_bfs_rans_tpu_torch.foam import generate_box_case
from gnn_bfs_rans_tpu_torch.foam.reader import FoamCase
from gnn_bfs_rans_tpu_torch.graph.build import build_graph
from gnn_bfs_rans_tpu_torch.models import convs
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.ops import segment as sops

F, H = 16, 4
# name → (JAX class, port class, layer type, extra kwargs)
CONVS = {
    "GCN": (jconvs.GCNConv, convs.GCNConv, "GCN", {}),
    "GIN": (jconvs.GINConv, convs.GINConv, "GIN", {}),
    "GAT": (jconvs.GATConv, convs.GATConv, "GAT", dict(heads=H)),
    "GAT-concat": (jconvs.GATConv, convs.GATConv, "GAT",
                   dict(heads=H, concat=True)),
    "Transformer": (jconvs.TransformerConv, convs.TransformerConv,
                    "Transformer", dict(heads=H, edge_dim=4)),
    "Transformer-concat": (jconvs.TransformerConv, convs.TransformerConv,
                           "Transformer", dict(heads=H, edge_dim=4,
                                               concat=True)),
    "Transformer-noedge": (jconvs.TransformerConv, convs.TransformerConv,
                           "Transformer", dict(heads=H)),
}
RATIO = 1.5


@pytest.fixture(scope="module", autouse=True)
def warm_exp():
    """torch's first multi-threaded f32 exp in a process has been seen to
    return values up to 1e-4 off in one thread's chunk; one call first."""
    torch.exp(torch.randn(1 << 19))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("dense_segment") / "case"
    generate_box_case(path, 24, 14, 1)
    return path


@pytest.fixture(scope="module")
def graphs(case):
    return (jax_build_graph(JaxFoamCase(case).load_mesh()),
            build_graph(FoamCase(case).load_mesh()))


def _variables(cfg, graph, seed=0):
    """Seeded flax FlowGNN init with non-trivial normalization parameters
    (and BatchNorm statistics)."""
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


def _conv_pair(name, backend, dtype, rate=0.0):
    jcls, pcls, _, kw = CONVS[name]
    jdt = None if dtype == "float32" else jnp.bfloat16
    pdt = None if dtype == "float32" else torch.bfloat16
    jkw = dict(kw, dropout=rate) if "heads" in kw else kw
    return (jcls(features=F, backend=backend, dtype=jdt, **jkw),
            pcls(F, backend=backend, dtype=pdt, **jkw))


def _params(jconv, x, jgraph):
    """Seeded flax init with nonzero biases."""
    params = jax.tree.map(np.asarray, jconv.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(x), jgraph))
    rng = np.random.default_rng(12)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out = {}
    for path, leaf in flat:
        if jax.tree_util.keystr(path).endswith("['bias']"):
            leaf = (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        out[path] = leaf
    return jax.tree_util.tree_unflatten(jax.tree.structure(params),
                                        list(out.values()))


def _run(name, backend, dtype, graphs, x32):
    """(JAX output, port output) of the conv on x32 rounded to dtype."""
    jgraph, graph = graphs
    jconv, conv = _conv_pair(name, backend, dtype)
    jx = jnp.asarray(x32, dtype)
    params = _params(jconv, x32, jgraph)
    want = jconv.apply(params, jx, jgraph)
    conv.load_state_dict(conv_state_dict_from_flax(
        CONVS[name][2], params["params"], "",
        edge=CONVS[name][3].get("edge_dim") is not None))
    with torch.no_grad():
        got = conv(torch.from_numpy(np.array(jx.astype(jnp.float32)))
                   .to(getattr(torch, dtype)), graph)
    return want, got, (jconv, params, jgraph)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "segment"])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_matches_jax(graphs, name, backend, dtype):
    x32 = np.random.default_rng(3).normal(
        size=(graphs[1].n_pad, F)).astype(np.float32)
    want, got, (jconv, params, jgraph) = _run(name, backend, dtype, graphs,
                                              x32)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (
        got.dtype, want.dtype)
    want = np.asarray(want.astype(jnp.float32))
    gotf = got.float().numpy()
    heads = CONVS[name][3].get("heads", 1)
    concat = CONVS[name][3].get("concat", False)
    assert gotf.shape == (graphs[1].n_pad, F * heads if concat else F)
    if dtype == "float32":
        # the same f32 arithmetic in other summation orders
        np.testing.assert_allclose(gotf, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        return
    # bf16: both sides round at the same points; JAX's reference is its f32
    # conv on the same (bf16-valued) input
    ref = np.asarray(jconv.clone(dtype=None).apply(
        params, jnp.asarray(x32, jnp.bfloat16).astype(jnp.float32), jgraph))
    own = np.abs(want - ref).max()
    dist = np.abs(gotf - ref).max()
    print(f"{name} {backend} bf16: distance {dist:.3e}, JAX {own:.3e}")
    assert dist <= RATIO * own + 1e-6 * np.abs(ref).max(), (dist, own)


@pytest.mark.parametrize("layer,backend,norm_type", [
    ("GAT", "dense", "batch"), ("GIN", "segment", "batch"),
    ("Transformer", "segment", "layer"), ("GCN", "dense", "layer")])
def test_flowgnn_dtypes_match_jax(case, layer, backend, norm_type):
    """FlowGNN forwards (eval and the exact-statistics train-mode forward)
    in f32, bf16 and mixed on the same f32 weights: f32 within 1e-5 of the
    output's max; bf16 and mixed no further from the JAX f32 forward than
    1.5 × JAX's own bf16 (mixed) forward, which holds the residual stream's
    dtype changes (a dense conv's f32 output in a bf16 model) and the
    LayerNorm's f32 statistics."""
    path = case
    jgraph = jax_build_graph(JaxFoamCase(path).load_mesh())
    graph = build_graph(FoamCase(path).load_mesh())
    base = dict(hidden_dim=16, num_layers=2, layer_type=layer, heads=4,
                dropout=0.0, backend=backend, norm_type=norm_type)
    params, stats = _variables(JaxModelConfig(**base), jgraph)
    variables = {"params": params, "batch_stats": stats}
    outs = {}
    for dt in ("float32", "bfloat16", "mixed"):
        jcfg = JaxModelConfig(**base, compute_dtype=dt)
        cfg = ModelConfig.from_dict(jcfg.to_dict())
        port = FlowGNN(cfg)
        port.load_state_dict(state_dict_from_flax(params, stats, cfg))
        for exact in (False, True):
            if exact:
                want, _ = JaxFlowGNN(jcfg).apply(variables, jgraph, train=True,
                                                 mutable=["batch_stats"])
            else:
                want = JaxFlowGNN(jcfg).apply(variables, jgraph)
            with torch.no_grad():
                got = port.eval()(graph, exact_bn=exact)
            assert got.dtype == torch.float32
            outs[dt, exact] = np.asarray(want), got.numpy()
    for (dt, exact), (want, got) in outs.items():
        if dt == "float32":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            continue
        ref = outs["float32", exact][0]
        own = np.abs(want - ref).max()
        dist = np.abs(got - ref).max()
        assert dist <= 1.5 * own, (dt, exact, dist, own)


def test_segment_ops_on_empty_segments():
    """Receivers 1 and 3 have no edge (3 only masked ones): max −inf, sum
    0, and edge_softmax's clamps, as the JAX functions give."""
    recv = np.array([0, 0, 2, 3], np.int32)
    mask = np.array([True, True, True, False])
    vals = np.array([[1.0, -2.0], [3.0, 0.5], [-1.0, 4.0], [7.0, 7.0]],
                    np.float32)
    t = torch.from_numpy
    for fn, args in (
            ("segment_max_to_nodes", (vals, recv, 4, mask)),
            ("segment_sum_to_nodes", (vals, recv, 4, mask)),
            ("edge_softmax", (vals, recv, 4, mask))):
        want = np.asarray(getattr(jsops, fn)(*(jnp.asarray(a) if
                                               isinstance(a, np.ndarray)
                                               else a for a in args)))
        got = getattr(sops, fn)(*(t(a) if isinstance(a, np.ndarray) else a
                                  for a in args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=fn)
    got = sops.segment_max_to_nodes(t(vals), t(recv), 4, t(mask)).numpy()
    assert np.isneginf(got[1]).all() and (got[3] == -1e30).all()
    got = sops.aggregate_sum(t(vals), t(np.array([1, 2, 0, 3], np.int32)),
                             t(recv), 4, t(mask),
                             t(np.array([2.0, 1.0, 1.0, 1.0], np.float32)))
    want = jsops.aggregate_sum(jnp.asarray(vals),
                               jnp.array([1, 2, 0, 3], jnp.int32),
                               jnp.asarray(recv), 4, jnp.asarray(mask),
                               jnp.array([2.0, 1.0, 1.0, 1.0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# conv, backend → the JAX mask shape, from the graph's (n_pad, e_pad, D)
MASK_SHAPES = {
    ("GAT", "segment"): lambda n, e, d: (e + n, H),
    ("GAT", "dense"): lambda n, e, d: (n, d + 1, H),
    ("Transformer", "segment"): lambda n, e, d: (e, H),
    ("Transformer", "dense"): lambda n, e, d: (n, d, H),
}


@pytest.mark.parametrize("conv_backend", sorted(MASK_SHAPES),
                         ids=lambda cb: "-".join(cb))
def test_attention_dropout_statistics(graphs, monkeypatch, conv_backend):
    name, backend = conv_backend
    rate = 0.3
    graph = graphs[1]
    masks = []
    keep_fn = convs.bernoulli_keep

    def record(*a, **k):
        m = keep_fn(*a, **k)
        masks.append(m)
        return m

    monkeypatch.setattr(convs, "bernoulli_keep", record)
    _, conv = _conv_pair(name, backend, "float32", rate)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(graph.n_pad, F, generator=torch.Generator().manual_seed(1))

    def run(seed):
        with torch.no_grad():
            return conv(x, graph, train=True,
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = run(7), run(7), run(8)
    shape = MASK_SHAPES[conv_backend](graph.n_pad, graph.e_pad,
                                      graph.max_degree)
    assert [tuple(m.shape) for m in masks] == [shape] * 3
    keep = masks[0].double().mean().item()
    sigma = (rate * (1 - rate) / masks[0].numel()) ** 0.5
    assert abs(keep - (1 - rate)) <= 5 * sigma, keep
    assert torch.equal(masks[0], masks[1]) and torch.equal(a, b)
    assert not torch.equal(masks[0], masks[2]) and not torch.equal(a, c)
    # without a generator: no dropout, the eval output
    with torch.no_grad():
        plain = conv(x, graph, train=True)
    assert len(masks) == 3 and not torch.equal(plain, a)
