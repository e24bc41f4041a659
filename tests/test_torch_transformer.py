"""Port banded Transformer kernels (rows 9 and 11) and band planes vs JAX.

* the port's ``build_band`` gives the JAX ``build_band``'s ``bias_noself``,
  ``geo`` and ``pos`` planes bit for bit on a generated box case and on the
  JAX kernel tests' geometric grid, and the generic ``edge`` plane for
  random (non-geometric) features, which refuse the geo form;
* row 9's plain version matches ``banded_transformer_fwd`` (Pallas in
  interpret mode) in all six forms (no conditioning, edge, geo; head mean
  and concat), row 11's matches ``banded_transformer_geo_mean_fused``;
* rows without senders (padding) give exactly 0;
* ``TransformerConv`` matches the JAX module in f32 on the geo and the
  generic edge planes, head mean and concat;
* a CPU tensor takes the plain version; row 9 takes a gradient and
  dropout, row 11 (an eval form) raises under a gradient.

The CUDA kernels are held against the plain versions on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.foam import FoamCase as JaxFoamCase
from gnn_bfs_rans_tpu.graph.band import build_band as jax_build_band
from gnn_bfs_rans_tpu.graph.build import build_graph as jax_build_graph
from gnn_bfs_rans_tpu.kernels import banded as jk
from gnn_bfs_rans_tpu.models.convs import TransformerConv as JaxConv
from gnn_bfs_rans_tpu.utils.synthetic import build_grid_graph
from gnn_bfs_rans_tpu_torch.foam import generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS, build_band
from gnn_bfs_rans_tpu_torch.infer import load_graph
from gnn_bfs_rans_tpu_torch.kernels import _build
from gnn_bfs_rans_tpu_torch.kernels import banded as tk
from gnn_bfs_rans_tpu_torch.models.convs import TransformerConv

H, C, F = 2, 16, 32
COMPONENTS = LAYER_COMPONENTS["Transformer"]


@pytest.fixture(scope="module")
def bands(tmp_path_factory):
    """(JAX band, port band) for the geo form (a 336-cell box case: 48
    padding rows) and for the edge form (the same edges, random
    features), plus the number of real rows."""
    path = tmp_path_factory.mktemp("torch_transformer_kernels") / "case"
    generate_box_case(path, 24, 14, 1)
    jgraph = jax_build_graph(JaxFoamCase(path).load_mesh(), with_band=True,
                             band_components=COMPONENTS)
    graph = load_graph(path, "Transformer")
    s = graph.senders.numpy()[: graph.n_edges]
    r = graph.receivers.numpy()[: graph.n_edges]
    feat = np.random.default_rng(3).normal(size=(s.size, 4)).astype(np.float32)
    args = (s, r, graph.n_pad, graph.node_mask.numpy(),
            graph.in_degree.numpy())
    kw = dict(tile=128, components=COMPONENTS, edge_feat=feat,
              node_pos=graph.node_feat.numpy())
    return {"geo": (jgraph.band, graph.band),
            "edge": (jax_build_band(*args, **kw), build_band(*args, **kw)),
            "n_nodes": graph.n_nodes, "graphs": (jgraph, graph)}


def _same(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_box_case_planes_match_jax(bands):
    jb, tb = bands["geo"]
    assert tb.bias_noself.dtype == torch.int8 and tb.edge is None
    assert tb.geo.shape == (3, 2, 128, 256) and tb.pos.shape == (384, 4)
    for name in ("bias_noself", "geo", "pos"):
        _same(getattr(tb, name), getattr(jb, name))
    jb, tb = bands["edge"]
    assert tb.geo is None and tb.pos is None and jb.geo is None
    assert tb.edge.shape == (3, 4, 128, 256)
    _same(tb.edge, jb.edge)


def test_grid_planes_match_jax():
    """The JAX kernel tests' geometric grid (``_geo_bands``): the geo form
    when geo is requested, the generic edge plane otherwise."""
    g = build_grid_graph(32, 16, with_band=False, tile=32)
    args = (np.asarray(g.senders)[: g.n_edges],
            np.asarray(g.receivers)[: g.n_edges], g.n_pad,
            np.asarray(g.node_mask), np.asarray(g.in_degree))
    ef = np.asarray(g.edge_feat)[: g.n_edges]
    for comps in (("bias_noself", "geo"), ("bias_noself", "edge")):
        kw = dict(tile=32, components=comps, edge_feat=ef,
                  node_pos=np.asarray(g.node_feat))
        jb, tb = jax_build_band(*args, **kw), build_band(*args, **kw)
        assert tb.width_cols == jb.width_cols
        for name in ("bias_noself", "geo", "pos", "edge"):
            want = getattr(jb, name)
            got = getattr(tb, name)
            assert (got is None) == (want is None), name
            if want is not None:
                _same(got, want)


def _inputs(n, heads, d_e, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(n, heads * C)).astype(np.float32)
               for _ in range(3))
    qw = rng.normal(size=(n, heads * d_e)).astype(np.float32)
    return q, k, v, qw


def _jax_row9(jb, form, q, k, v, qw, mean, dtype):
    j = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    extra = {}
    if form == "edge":
        extra = dict(edge_band=jnp.asarray(jb.edge), qw=j(qw))
    elif form == "geo":
        extra = dict(geo_band=jnp.asarray(jb.geo), pos=jnp.asarray(jb.pos),
                     qw=j(qw))
    res = jk.banded_transformer_fwd(jnp.asarray(jb.bias_noself), j(q), j(k),
                                    j(v), H, mean_heads=mean, **extra)
    res = res if isinstance(res, tuple) else (res,)
    return [np.asarray(a, np.float32) for a in res]


def _port_row9(tb, form, q, k, v, qw, mean, dtype):
    t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    extra = {}
    if form == "edge":
        extra = dict(edge=tb.edge, qw=t(qw))
    elif form == "geo":
        extra = dict(geo=tb.geo, pos=tb.pos, qw=t(qw))
    res = tk.banded_transformer_fwd(tb.bias_noself, t(q), t(k), t(v), H,
                                    mean_heads=mean, **extra)
    res = res if isinstance(res, tuple) else (res,)
    assert res[0].dtype == getattr(torch, dtype)
    return [a.float().numpy() for a in res]


def _cancel_scale(tb):
    """max|pos|·max(1/dist): the size of the terms the geo form's direction
    columns cancel (s = pos_i·Σp·invd − Σp·invd·pos_j, Σp·invd ≤ max invd
    as p sums to 1; up to 24·|pos| on this case) into values ≤ 1."""
    return float(tb.pos.abs().max()) * float(tb.geo[:, 1].max())


def _parts(form, a):
    """An output split for its checks: out whole; the geo s's direction
    columns (0-2 of each head), which cancel, apart from its dist column
    (3), which does not; the edge s whole."""
    if form != "geo":
        return [a]
    a4 = a.reshape(a.shape[0], -1, 4)
    return [a4[..., :3], a4[..., 3]]


def _check(tb, form, got, ref, ref32=None):
    """f32 (``ref32`` None): the same arithmetic in other summation orders,
    1e-5 of each part's max (measured ≤ 1.6e-7 for out), the geo direction
    columns plus 1e-6 of ``_cancel_scale`` (measured ≤ 1.7e-7 of it).
    bf16: rounding points as the TPU kernel's (q/k/v, qw in bf16, the
    probability before the value product); each part no further from JAX
    f32 than 1.5 × JAX bf16's own distance (L2; measured ratios 1.0000)."""
    for i, (a, b) in enumerate(zip(got, ref)):
        form_i = "plain" if i == 0 else form
        pa, pb = _parts(form_i, a), _parts(form_i, b)
        if ref32 is None:
            for j, (x, y) in enumerate(zip(pa, pb)):
                atol = 1e-5 * np.abs(y).max()
                if form_i == "geo" and j == 0:
                    atol += 1e-6 * _cancel_scale(tb)
                np.testing.assert_allclose(x, y, rtol=0, atol=atol)
            continue
        for x, y, y32 in zip(pa, pb, _parts(form_i, ref32[i])):
            own = np.linalg.norm(y - y32)
            dist = np.linalg.norm(x - y32)
            assert dist <= 1.5 * own + 1e-6 * np.linalg.norm(y32), (dist, own)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mean", [False, True], ids=["concat", "mean"])
@pytest.mark.parametrize("form", ["plain", "edge", "geo"])
def test_row9_plain_matches_jax(bands, form, mean, dtype):
    jb, tb = bands["edge" if form == "edge" else "geo"]
    n = tb.bias_noself.shape[0] * 128
    q, k, v, qw = _inputs(n, H, 4, seed=5)
    got = _port_row9(tb, form, q, k, v, qw, mean, dtype)
    ref = _jax_row9(jb, form, q, k, v, qw, mean, dtype)
    assert len(got) == (1 if form == "plain" else 2)
    assert got[0].shape == (n, C if mean else H * C)
    ref32 = (None if dtype == "float32"
             else _jax_row9(jb, form, q, k, v, qw, mean, "float32"))
    _check(tb, form, got, ref, ref32)


def _fused_inputs(n, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    ws = [(rng.normal(size=(F, H * C)) * F ** -0.5).astype(np.float32)
          for _ in range(3)]
    bs = [(0.1 * rng.normal(size=H * C)).astype(np.float32) for _ in range(3)]
    w_e = (rng.normal(size=(4, H, C)) * 0.5).astype(np.float32)
    wblk = (np.eye(H, dtype=np.float32)[:, None, :, None]
            * np.transpose(w_e, (1, 2, 0))[:, :, None, :]).reshape(H * C, H * 4)
    return x, ws, bs, wblk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row11_plain_matches_jax(bands, dtype):
    jb, tb = bands["geo"]
    n = tb.bias_noself.shape[0] * 128
    x, ws, bs, wblk = _fused_inputs(n)

    def jax_run(dt):
        j = lambda a: jnp.asarray(a, dt)  # noqa: E731
        return [np.asarray(a, np.float32) for a in
                jk.banded_transformer_geo_mean_fused(
                    jnp.asarray(jb.bias_noself), jnp.asarray(jb.geo),
                    jnp.asarray(jb.pos), j(x), *map(j, ws), *map(j, bs),
                    j(wblk), H)]

    t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    got = tk.banded_transformer_geo_mean_fused(
        tb.bias_noself, tb.geo, tb.pos, t(x), *map(t, ws), *map(t, bs),
        t(wblk), H)
    assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == torch.float32
    got = [a.float().numpy() for a in got]
    ref = jax_run(dtype)
    _check(tb, "geo", got, ref,
           None if dtype == "float32" else jax_run("float32"))


@pytest.mark.parametrize("form", ["plain", "edge", "geo", "fused"])
def test_rows_without_senders_give_zero(bands, form):
    """bias_noself has no self-loops: padding rows have no sender at all;
    the kernel's guards give out = s = 0 there (never NaN)."""
    jb, tb = bands["edge" if form == "edge" else "geo"]
    n_real = bands["n_nodes"]
    n = tb.bias_noself.shape[0] * 128
    empty = tb.bias_noself.reshape(n, -1).sum(1) == 0
    assert empty[n_real:].all() and empty.sum() == n - n_real
    if form == "fused":
        x, ws, bs, wblk = _fused_inputs(n)
        t = torch.from_numpy
        res = tk.banded_transformer_geo_mean_fused(
            tb.bias_noself, tb.geo, tb.pos, t(x), *map(t, ws), *map(t, bs),
            t(wblk), H)
    else:
        q, k, v, qw = _inputs(n, H, 4, seed=6)
        res = [torch.from_numpy(a) for a in
               _port_row9(tb, form, q, k, v, qw, True, "float32")]
    for a in res:
        assert torch.isfinite(a).all()
        assert (a[empty] == 0).all()


def test_cpu_takes_plain_version_and_grad_or_dropout_raise(bands):
    """A CPU tensor takes the plain versions, forward and backward (no
    launch); row 9 takes a gradient and dropout (rows 10 and 7 behind it);
    row 11, an eval form, raises under a gradient."""
    _, tb = bands["geo"]
    n = tb.bias_noself.shape[0] * 128
    q, k, v, qw = (torch.from_numpy(a) for a in _inputs(n, H, 4, seed=8))
    _build.reset_launches()
    out, s = tk.banded_transformer_fwd(tb.bias_noself, q, k, v, H, qw=qw,
                                       geo=tb.geo, pos=tb.pos,
                                       mean_heads=True)
    assert out.shape == (n, C) and s.shape == (n, H * 4)
    ql = q.clone().requires_grad_()
    seed = torch.tensor([3], dtype=torch.int32)
    dropped = tk.banded_transformer_fwd(tb.bias_noself, ql, k, v, H,
                                        mean_heads=True, dropout_rate=0.1,
                                        seed=seed)
    dropped.sum().backward()
    assert ql.grad.shape == q.shape and torch.isfinite(ql.grad).all()
    assert not torch.equal(dropped.detach(), tk.banded_transformer_fwd(
        tb.bias_noself, q, k, v, H, mean_heads=True))
    assert not any(_build.LAUNCHES.values())
    x, ws, bs, wblk = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                       else [torch.from_numpy(b) for b in a]
                       for a in _fused_inputs(n))
    with pytest.raises(NotImplementedError, match="eval form"):
        tk.banded_transformer_geo_mean_fused(
            tb.bias_noself, tb.geo, tb.pos, x.requires_grad_(), *ws, *bs,
            wblk, H)


@pytest.mark.parametrize("concat", [False, True], ids=["mean", "concat"])
@pytest.mark.parametrize("form", ["geo", "edge"])
def test_conv_matches_jax(bands, form, concat):
    """The conv in f32 on the same weights (nonzero biases): the geo form
    (FlowGNN's), the generic edge form and the concat epilogue, which
    FlowGNN does not reach."""
    jgraph, graph = bands["graphs"]
    jb, tb = bands[form]
    jgraph = dataclasses.replace(jgraph, band=jb)
    graph = dataclasses.replace(graph, band=tb)
    x = np.random.default_rng(11).normal(size=(graph.n_pad, F)).astype(
        np.float32)
    jconv = JaxConv(features=F, heads=H, concat=concat, edge_dim=4,
                    backend="pallas")
    params = jax.tree.map(np.asarray, jconv.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(x), jgraph))
    rng = np.random.default_rng(12)
    for name in ("lin_query", "lin_key", "lin_value", "lin_skip"):
        b = params["params"][name]["bias"]
        params["params"][name]["bias"] = (
            0.1 * rng.normal(size=b.shape)).astype(np.float32)
    ref = np.asarray(jconv.apply(params, jnp.asarray(x), jgraph))
    conv = TransformerConv(F, heads=H, concat=concat, edge_dim=4)
    sd = {}
    for name, leaf in params["params"].items():
        sd[f"{name}.weight"] = torch.from_numpy(leaf["kernel"].T.copy())
        if "bias" in leaf:
            sd[f"{name}.bias"] = torch.from_numpy(leaf["bias"])
    conv.load_state_dict(sd)
    with torch.no_grad():
        got = conv(torch.from_numpy(x), graph).numpy()
    assert got.shape == ref.shape == (graph.n_pad, H * F if concat else F)
    # f32 in other summation orders; the JAX module's geo head-mean eval
    # projects on lin(eye) − lin(0) (one f32 ulp off W + b)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
