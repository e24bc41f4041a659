"""The port's row-8 SpMM and row-4 GAT attention vs the JAX package (CPU).

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do, on the same numpy inputs and the same bands.  The CUDA kernels are held
against these plain versions on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.

* ``banded_spmm`` forward and its gradient against the JAX ``banded_spmm``
  (``jax.vjp``) at window widths W 3 and W 5 (small tiles reach W 5
  cheaply), on the ``gcn`` f32 and ``adj`` bf16 planes, x in f32 and bf16;
* ``transpose_band`` against ``_transpose_band`` on random non-symmetric
  planes (the GCN and GIN planes are symmetric and cannot catch a transpose
  fault), and the gradient through it against ``jax.vjp``;
* ``banded_gat_mean_packed`` (row 4 and its backward, row 5) against the
  JAX op of the same name, dropout 0 and 0.1, f32 and bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.graph.band import build_band as jax_build_band
from gnn_bfs_rans_tpu.kernels.banded import _transpose_band
from gnn_bfs_rans_tpu.kernels.banded import banded_gat_mean_packed as jax_gatm
from gnn_bfs_rans_tpu.kernels.banded import banded_spmm as jax_spmm
from gnn_bfs_rans_tpu_torch.graph.band import build_band
from gnn_bfs_rans_tpu_torch.kernels import _build
from gnn_bfs_rans_tpu_torch.kernels.banded import (
    banded_gat_mean_packed,
    banded_spmm,
    transpose_band,
)

SEED = 1234


def _edges(n, width, seed=0, p=0.1):
    """Random symmetric edges with |s − r| < width, plus a chain."""
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(n, 1)
    keep = (((j - i) < width) & (rng.random(i.size) < p)) | ((j - i) == 1)
    s = np.concatenate([i[keep], j[keep]]).astype(np.int32)
    r = np.concatenate([j[keep], i[keep]]).astype(np.int32)
    order = np.lexsort((s, r))
    return s[order], r[order]


def _bands(n, tile, width, components):
    """(JAX Band, port Band) built from the same edges."""
    s, r = _edges(n, width)
    args = (s, r, n, np.ones(n, bool),
            np.bincount(r, minlength=n).astype(np.float32))
    return (jax_build_band(*args, tile=tile, components=components),
            build_band(*args, tile=tile, components=components))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# tile 16, n 96: edges narrower than a tile give W 3; up to 30 apart, W 5
WIDTHS = {3: 16, 5: 30}
# f32: the same exact f32 products summed in other orders (~1e-7);
# bf16 x: the f32 sum rounds once to bf16 on both sides, and another
# summation order can flip that rounding: one bf16 ulp (2^-8 relative)
SPMM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plane", ["gcn", "adj"])
@pytest.mark.parametrize("window", [3, 5])
def test_spmm_forward_and_grad_match_jax(window, plane, dtype):
    jb, tb = _bands(96, 16, WIDTHS[window], ("adj", "gcn"))
    a = getattr(tb, plane)
    assert a.shape == (6, window, 16, 16)
    assert a.dtype == (torch.float32 if plane == "gcn" else torch.bfloat16)
    np.testing.assert_array_equal(a.float().numpy(),
                                  np.asarray(getattr(jb, plane), np.float32))
    rng = np.random.default_rng(window)
    x = rng.normal(size=(96, 24)).astype(np.float32)
    g = rng.normal(size=(96, 24)).astype(np.float32)
    y, vjp = jax.vjp(lambda v: jax_spmm(jnp.asarray(getattr(jb, plane)), v),
                     jnp.asarray(x, dtype))
    (dx,) = vjp(jnp.asarray(g, dtype))

    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    yt = banded_spmm(a, xt)
    yt.backward(torch.from_numpy(g).to(yt.dtype))
    assert yt.dtype == xt.dtype and xt.grad.dtype == xt.dtype
    assert _rel(yt, y) <= SPMM_TOL[dtype]
    assert _rel(xt.grad, dx) <= SPMM_TOL[dtype]


@pytest.mark.parametrize("window", [3, 5])
def test_transpose_band_matches_jax_on_a_nonsymmetric_plane(window):
    rng = np.random.default_rng(window)
    a = rng.normal(size=(5, window, 16, 16)).astype(np.float32)
    want = np.asarray(_transpose_band(jnp.asarray(a)))
    # pure data movement: equal bit for bit
    np.testing.assert_array_equal(transpose_band(torch.from_numpy(a)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        transpose_band(torch.from_numpy(a).bfloat16()).float().numpy(),
        np.asarray(_transpose_band(jnp.asarray(a, jnp.bfloat16)), np.float32))

    # the gradient through the transposed band: blocks whose sender tile
    # lies outside the band are zero, as build_band leaves them (the TPU
    # kernel's clamped window relies on that)
    k0 = window // 2
    for t in range(5):
        for k in range(window):
            if not 0 <= t - k0 + k < 5:
                a[t, k] = 0.0
    x = rng.normal(size=(80, 8)).astype(np.float32)
    g = rng.normal(size=(80, 8)).astype(np.float32)
    y, vjp = jax.vjp(lambda v: jax_spmm(jnp.asarray(a), v), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = banded_spmm(torch.from_numpy(a), xt)
    yt.backward(torch.from_numpy(g))
    assert _rel(yt, y) <= 1e-5
    assert _rel(xt.grad, dx) <= 1e-5
    # a non-symmetric plane: Aᵀ·g differs from A·g
    assert _rel(banded_spmm(torch.from_numpy(a), torch.from_numpy(g)), dx) > 0.1


def test_band_keeps_its_transposed_planes():
    _, tb = _bands(96, 16, WIDTHS[5], ("adj", "gcn"))
    for name in ("gcn", "adj"):
        at = tb.transposed(name)
        assert at is tb.transposed(name)           # computed once, kept
        want = transpose_band(getattr(tb, name))
        np.testing.assert_array_equal(at.float().numpy(),
                                      want.float().numpy())
    # a moved Band computes its own
    assert "_transposed" not in vars(tb.to("cpu"))
    # the op's backward through the kept plane equals the per-call one
    x = torch.randn(96, 8, requires_grad=True)
    x2 = x.detach().clone().requires_grad_()
    g = torch.randn(96, 8)
    banded_spmm(tb.gcn, x, lambda: tb.transposed("gcn")).backward(g)
    banded_spmm(tb.gcn, x2).backward(g)
    torch.testing.assert_close(x.grad, x2.grad, rtol=0, atol=0)


N, H, C = 384, 4, 32
# forward: f32 summation order (~1e-7); bf16 one output rounding may flip
# (2^-8 relative).  Backward: the JAX kernel rounds each window partial of
# dz to bf16 and folds them in f32, the port sums dz in f32 and rounds once:
# a few bf16 ulps of dz; dα is f32 on both sides, from bf16 products
GATM_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 2e-2)}


@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_mean_packed_matches_jax_vjp(dtype, rate, width):
    jb, tb = _bands(N, 128, width, ("bias_self",))
    assert tb.bias_self.shape[-1] == {60: 256, 100: 384}[width]
    rng = np.random.default_rng(5)
    z = (0.5 * rng.normal(size=(N, H * C))).astype(np.float32)
    alphas = rng.normal(size=(N, 2 * H)).astype(np.float32)
    g = rng.normal(size=(N, C)).astype(np.float32)
    seed_j = jnp.array([SEED], jnp.int32) if rate else None
    y, vjp = jax.vjp(
        lambda z_, a_: jax_gatm(jnp.asarray(jb.bias_self), z_, a_, H, 0.2,
                                rate, seed_j),
        jnp.asarray(z, dtype), jnp.asarray(alphas))
    dz, da = vjp(jnp.asarray(g, dtype))

    zt = torch.from_numpy(z).to(getattr(torch, dtype)).requires_grad_()
    at = torch.from_numpy(alphas).requires_grad_()
    seed_t = torch.tensor([SEED], dtype=torch.int32) if rate else None
    yt = banded_gat_mean_packed(tb.bias_self, zt, at, H, 0.2, rate, seed_t)
    yt.backward(torch.from_numpy(g).to(yt.dtype))
    assert yt.dtype == zt.dtype and zt.grad.dtype == zt.dtype
    fwd_tol, bwd_tol = GATM_TOL[dtype]
    assert _rel(yt, y) <= fwd_tol
    assert _rel(zt.grad, dz) <= bwd_tol
    assert _rel(at.grad, da) <= bwd_tol
    if rate:
        # the same elements were dropped: without dropout the output differs
        plain = banded_gat_mean_packed(tb.bias_self, zt, at, H, 0.2)
        assert _rel(plain, y) > 1e-3


def test_cpu_tensors_count_no_launch():
    _build.reset_launches()
    _, tb = _bands(96, 16, 16, ("adj", "gcn"))
    x = torch.randn(96, 8, requires_grad=True)
    banded_spmm(tb.gcn, x).sum().backward()
    _, tb = _bands(N, 128, 60, ("bias_self",))
    z = torch.randn(N, H * C, requires_grad=True)
    banded_gat_mean_packed(tb.bias_self, z, torch.randn(N, 2 * H), H, 0.2,
                           0.1, torch.tensor([SEED], dtype=torch.int32)
                           ).sum().backward()
    assert sum(_build.LAUNCHES.values()) == 0
