"""Row 4's concat form and row 5's per-head cotangent vs the JAX package.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do, on the same numpy inputs and bands; the CUDA kernels are held against
these plain versions on the card (``test_torch_cuda.py``,
``chip_smoke.py``).

* ``banded_gat`` / ``banded_gat_packed`` (row 4 with ``mean_heads=False``)
  and its backward (row 5 with ``mean_expand=False``) against the JAX
  ``banded_gat_fwd`` and ``jax.vjp`` of ``banded_gat_packed``, on the
  Wcols 256 and 384 bands, dropout 0 and 0.3: f32 within 1e-5 of each
  output's max; bf16 no further from the JAX f32 result than 1.5 × the
  JAX bf16 result's own distance (``PERF.md`` §2);
* the attention-dropout masks of the concat form bit for bit against the
  JAX interpret stream (``_dropout_bits`` over each tile's [H·T, Wcols]
  plane, seed + t);
* ``GATConv(concat=True, backend='pallas')`` forward and its gradients
  against the JAX conv on the same weights, f32 and bf16;
* CPU tensors take the plain versions and count no launch.
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
from gnn_bfs_rans_tpu.models.convs import GATConv as JaxGATConv
from gnn_bfs_rans_tpu_torch.compat.from_jax import (
    conv_flax_from_state_dict,
    conv_state_dict_from_flax,
)
from gnn_bfs_rans_tpu_torch.foam import generate_box_case
from gnn_bfs_rans_tpu_torch.foam.reader import FoamCase
from gnn_bfs_rans_tpu_torch.graph.band import build_band
from gnn_bfs_rans_tpu_torch.graph.build import build_graph
from gnn_bfs_rans_tpu_torch.kernels import _build
from gnn_bfs_rans_tpu_torch.kernels.banded import (
    attention_keep,
    banded_gat,
    banded_gat_packed,
)
from gnn_bfs_rans_tpu_torch.models.convs import GATConv

N, H, C = 384, 4, 32
SEED = 1234
RATIO = 1.5


@pytest.fixture(scope="module", autouse=True)
def warm_exp():
    """torch's first multi-threaded f32 exp in a process has been seen to
    return values up to 1e-4 off in one thread's chunk; one call first."""
    torch.exp(torch.randn(1 << 19))


def _bands(width, seed=0, p=0.1):
    """(JAX bias_self, port bias_self) of random symmetric edges narrower
    than ``width`` plus a chain, tile 128."""
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(N, 1)
    keep = (((j - i) < width) & (rng.random(i.size) < p)) | ((j - i) == 1)
    s = np.concatenate([i[keep], j[keep]]).astype(np.int32)
    r = np.concatenate([j[keep], i[keep]]).astype(np.int32)
    order = np.lexsort((s, r))
    args = (s[order], r[order], N, np.ones(N, bool),
            np.bincount(r, minlength=N).astype(np.float32))
    kw = dict(tile=128, components=("bias_self",))
    return (jax_build_band(*args, **kw).bias_self,
            build_band(*args, **kw).bias_self)


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _jax_vjp(jmask, z, alphas, g, dtype, rate):
    seed = jnp.array([SEED], jnp.int32) if rate else None
    y, vjp = jax.vjp(
        lambda z_, a_: jk.banded_gat_packed(jnp.asarray(jmask), z_, a_, H,
                                            0.2, rate, seed),
        jnp.asarray(z, dtype), jnp.asarray(alphas))
    return (y, *vjp(jnp.asarray(g, dtype)))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [60, 100])
def test_concat_and_per_head_backward_match_jax(width, dtype, rate):
    jmask, mask = _bands(width)
    assert mask.shape[-1] == {60: 256, 100: 384}[width]
    rng = np.random.default_rng(5)
    z = (0.5 * rng.normal(size=(N, H * C))).astype(np.float32)
    alphas = rng.normal(size=(N, 2 * H)).astype(np.float32)
    g = rng.normal(size=(N, H * C)).astype(np.float32)
    dt = getattr(torch, dtype)
    seed = torch.tensor([SEED], dtype=torch.int32) if rate else None
    zt = torch.from_numpy(z).to(dt).requires_grad_()
    at = torch.from_numpy(alphas).requires_grad_()
    out = banded_gat_packed(mask, zt, at, H, 0.2, rate, seed)
    out.backward(torch.from_numpy(g).to(dt))
    assert out.shape == (N, H * C) and out.dtype == dt
    assert zt.grad.dtype == dt and at.grad.dtype == torch.float32
    got = [out, zt.grad, at.grad]
    want = _jax_vjp(jmask, z, alphas, g, dtype, rate)
    # the forward alone: the JAX kernel with mean_heads=False, and the port's
    # wrapper
    fwd = jk.banded_gat_fwd(jnp.asarray(jmask), jnp.asarray(z, dtype),
                            jnp.asarray(alphas), H, 0.2, rate,
                            jnp.array([SEED], jnp.int32) if rate else None,
                            mean_heads=False)
    np.testing.assert_array_equal(_np(fwd), _np(want[0]))
    with torch.no_grad():
        np.testing.assert_array_equal(
            _np(banded_gat(mask, zt, at, H, 0.2, rate, seed)), _np(out))
    names = ("out", "dz", "dalpha")
    if dtype == "float32":
        # f32 in other summation orders (dz: one f32 sum per sender where
        # the JAX kernel folds window partials)
        for name, a, b in zip(names, got, want):
            b = _np(b)
            err = np.abs(_np(a) - b).max() / np.abs(b).max()
            assert err <= 1e-5, (name, err)
        return
    ref = _jax_vjp(jmask, np.asarray(jnp.asarray(z, jnp.bfloat16)
                                     .astype(jnp.float32)),
                   alphas, np.asarray(jnp.asarray(g, jnp.bfloat16)
                                      .astype(jnp.float32)), "float32", rate)
    for name, a, b, r in zip(names, got, want, ref):
        r = _np(r)
        own = np.abs(_np(b) - r).max()
        dist = np.abs(_np(a) - r).max()
        print(f"{name} bf16 rate {rate} W {width}: {dist:.3e} vs JAX {own:.3e}")
        assert dist <= RATIO * own + 1e-6 * np.abs(r).max(), (name, dist,
                                                                own)


def test_concat_dropout_masks_are_the_jax_stream():
    """The kept entries of each tile's [H·T, Wcols] plane: the port's
    ``attention_keep`` (which the concat form's plain version and kernel
    read) against ``_dropout_bits(…, seed + t) >= threshold``."""
    rate, n_tiles, tile, width = 0.3, 3, 128, 256
    got = attention_keep(SEED, n_tiles, tile, width, H, rate, "cpu")
    for t in range(n_tiles):
        bits = np.asarray(jk._dropout_bits((H * tile, width),
                                           jnp.int32(SEED + t)))
        want = bits >= np.asarray(jk._dropout_thresh(rate))
        plane = got[t].permute(2, 0, 1).reshape(H * tile, width).numpy()
        np.testing.assert_array_equal(plane, want)
    assert abs(got.float().mean().item() - (1 - rate)) < 0.01


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    path = tmp_path_factory.mktemp("gat_concat") / "case"
    generate_box_case(path, 24, 14, 1)
    kw = dict(with_band=True, band_components=("bias_self",))
    return (jax_build_graph(JaxFoamCase(path).load_mesh(), **kw),
            build_graph(FoamCase(path).load_mesh(), **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_concat_conv_matches_jax(graphs, dtype):
    """``GATConv(concat=True)`` on the kernels' path: the forward and the
    gradients of a weighted sum of its output, in x, W, the attention
    vectors and the [H·C] bias."""
    jgraph, graph = graphs
    assert graph.band is not None
    f = 16
    jdt = None if dtype == "float32" else jnp.bfloat16
    jconv = JaxGATConv(features=f, heads=H, concat=True, backend="pallas",
                       dtype=jdt)
    x32 = np.random.default_rng(3).normal(size=(graph.n_pad, f)).astype(
        np.float32)
    xj = jnp.asarray(x32, dtype)
    params = jax.tree.map(np.asarray, jconv.init(jax.random.PRNGKey(0), xj,
                                                 jgraph))["params"]
    params["bias"] = (0.1 * np.random.default_rng(4).normal(
        size=H * f)).astype(np.float32)
    wts = np.random.default_rng(6).normal(size=(graph.n_pad, H * f)).astype(
        np.float32)

    def jax_loss(p, x):
        y = jconv.apply({"params": p}, x, jgraph)
        return jnp.sum(y.astype(jnp.float32) * wts), y

    def run(p, x):
        (_, y), grads = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                           has_aux=True)(p, x)
        return y, grads

    y, (gp, gx) = run(params, xj)
    conv = GATConv(f, heads=H, concat=True, backend="pallas",
                   dtype=None if dtype == "float32" else torch.bfloat16)
    conv.load_state_dict(conv_state_dict_from_flax("GAT", params))
    assert conv.bias.shape == (H * f,)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    out = conv(xt, graph)
    (out.float() * torch.from_numpy(wts)).sum().backward()
    assert out.dtype == getattr(torch, dtype) and str(y.dtype) == dtype
    got_g = conv_flax_from_state_dict(
        "GAT", {k: p.grad for k, p in conv.named_parameters()})
    got = {"out": out, "x": xt.grad, **{k: got_g[k] for k in
                                        ("bias", "att_src", "att_dst")},
           "lin": got_g["lin"]["kernel"]}
    want = {"out": y, "x": gx, "bias": gp["bias"], "att_src": gp["att_src"],
            "att_dst": gp["att_dst"], "lin": gp["lin"]["kernel"]}
    if dtype == "float32":
        for k in want:
            b = _np(want[k])
            err = np.abs(_np(got[k]) - b).max() / np.abs(b).max()
            assert err <= 1e-5, (k, err)
        return
    ref_conv = dataclasses.replace(jconv, dtype=None)
    ref_y = ref_conv.apply({"params": params}, xj.astype(jnp.float32), jgraph)
    _, (rp, rx) = jax.value_and_grad(
        lambda p, x: (jnp.sum(ref_conv.apply({"params": p}, x, jgraph) * wts),
                      None), argnums=(0, 1), has_aux=True)(
                          params, xj.astype(jnp.float32))
    ref = {"out": ref_y, "x": rx, "bias": rp["bias"],
           "att_src": rp["att_src"], "att_dst": rp["att_dst"],
           "lin": rp["lin"]["kernel"]}
    for k in want:
        r = _np(ref[k])
        own = np.abs(_np(want[k]) - r).max()
        dist = np.abs(_np(got[k]) - r).max()
        print(f"conv {k} bf16: {dist:.3e} vs JAX {own:.3e}")
        assert dist <= RATIO * own + 1e-6 * np.abs(r).max(), (k, dist, own)


def test_cpu_tensors_count_no_launch():
    _, mask = _bands(60)
    _build.reset_launches()
    z = torch.randn(N, H * C, requires_grad=True)
    banded_gat_packed(mask, z, torch.randn(N, 2 * H), H, 0.2, 0.1,
                      torch.tensor([SEED], dtype=torch.int32)
                      ).sum().backward()
    assert z.grad.shape == z.shape
    assert sum(_build.LAUNCHES.values()) == 0
