"""The port's training kernels' plain versions vs the JAX package (CPU).

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do, on the same numpy inputs.  The CUDA kernels are held
against these plain versions on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.

* the dropout hash against ``_hash_bits``, bit for bit;
* kernel 1 in its training form (attention dropout, z emitted) against
  ``banded_gat_mean_fused_fwd(..., emit_z=True)``;
* the GAT op's backward (rows 5 and 6 and the α products) against
  ``jax.vjp`` of ``banded_gat_mean_fused_wa``;
* the fused epilogue op, forward and backward (row 3), against ``jax.vjp``
  of ``fused_epilogue``, pad rows included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.graph.band import build_band as jax_build_band
from gnn_bfs_rans_tpu.kernels.banded import _hash_bits
from gnn_bfs_rans_tpu.kernels.banded import (
    banded_gat_mean_fused_fwd as jax_gat_fwd,
)
from gnn_bfs_rans_tpu.kernels.banded import (
    banded_gat_mean_fused_wa as jax_gat_wa,
)
from gnn_bfs_rans_tpu.kernels.epilogue import fused_epilogue as jax_epilogue
from gnn_bfs_rans_tpu_torch.graph.band import build_band
from gnn_bfs_rans_tpu_torch.kernels import _build
from gnn_bfs_rans_tpu_torch.kernels.banded import (
    banded_gat_mean_fused,
    banded_gat_mean_fused_wa,
)
from gnn_bfs_rans_tpu_torch.kernels.dropout import hash_bits
from gnn_bfs_rans_tpu_torch.kernels.epilogue import fused_epilogue

# H·C = 128: the JAX backward takes its fold_project_bwd path, as at the
# flagship width
N, H, C, F = 384, 4, 32, 32
SEED = 1234


def _band(width):
    """(JAX Band, port Band) from the same random symmetric edges
    (|s − r| < width, plus a chain); tile 128, n 384."""
    rng = np.random.default_rng(0)
    i, j = np.triu_indices(N, 1)
    keep = (((j - i) < width) & (rng.random(i.size) < 0.05)) | ((j - i) == 1)
    s = np.concatenate([i[keep], j[keep]]).astype(np.int32)
    r = np.concatenate([j[keep], i[keep]]).astype(np.int32)
    order = np.lexsort((s, r))
    s, r = s[order], r[order]
    args = (s, r, N, np.ones(N, bool),
            np.bincount(r, minlength=N).astype(np.float32))
    return (jax_build_band(*args, tile=128, components=("bias_self",)),
            build_band(*args, tile=128, components=("bias_self",)))


def _gat_inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F)).astype(np.float32)
    w = (0.3 * rng.normal(size=(F, H * C))).astype(np.float32)
    wa = (0.5 * rng.normal(size=(F, 2 * H))).astype(np.float32)
    g = rng.normal(size=(N, C)).astype(np.float32)
    return x, w, wa, g


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("shape,seed", [((4, 256), 0), ((512, 64), 2 ** 31 - 5),
                                        ((2, 3, 5, 7), 987654321)])
def test_hash_matches_jax_bit_for_bit(shape, seed):
    want = np.asarray(_hash_bits(shape, jnp.int32(seed), 0)).astype(np.int64)
    flat = torch.arange(int(np.prod(shape))).reshape(shape)
    np.testing.assert_array_equal(hash_bits(seed, flat).numpy(), want)


def test_hash_seed_wraps_like_int32():
    # seed + tile index past 2³¹ − 1 wraps in the kernels' int32 arithmetic
    s = jnp.int32(2 ** 31 - 2) + jnp.int32(5)
    want = np.asarray(_hash_bits((64,), s, 0)).astype(np.int64)
    np.testing.assert_array_equal(
        hash_bits(2 ** 31 - 2 + 5, torch.arange(64)).numpy(), want)


# bandwidth < 64 → Wcols 256 (the BFS-mesh class); (64, 128] → Wcols 384
@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_forward_training_form_matches_jax(width, dtype):
    jb, tb = _band(width)
    x, w, wa, _ = _gat_inputs()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    alphas = np.array(jnp.dot(xj, jnp.asarray(wa, jdt),
                              preferred_element_type=jnp.float32))
    out, z = jax_gat_fwd(jnp.asarray(jb.bias_self), wj, jnp.asarray(alphas),
                         xj, H, 0.2, 0.1, jnp.array([SEED], jnp.int32),
                         emit_z=True)
    got, got_z = banded_gat_mean_fused(
        tb.bias_self, torch.from_numpy(w).to(tdt), torch.from_numpy(alphas),
        torch.from_numpy(x).to(tdt), H, 0.2, 0.1,
        torch.tensor([SEED], dtype=torch.int32), emit_z=True)
    assert got.dtype == tdt and got_z.shape == (N, H * C)
    # z: the same rounded projection
    assert _rel(got_z, z) <= (1e-6 if dtype == "float32" else 1e-2)
    # the masks are bit-identical, so f32 differs by summation order only;
    # bf16: one output rounding may flip (one bf16 ulp, 2^-8 relative)
    assert _rel(got, out) <= (1e-5 if dtype == "float32" else 1e-2)
    # dropout really dropped: without it the output differs
    plain = banded_gat_mean_fused(
        tb.bias_self, torch.from_numpy(w).to(tdt), torch.from_numpy(alphas),
        torch.from_numpy(x).to(tdt), H, 0.2)
    assert _rel(plain, out) > 1e-3


# bf16 tolerance of the backward, relative to each cotangent's largest
# element: the JAX kernel rounds each window partial of dz to bf16 and folds
# them in f32, the port sums dz in f32 and rounds once; dx and dW then carry
# that difference through one bf16 product (measured ≤ 5e-3)
GAT_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_backward_matches_jax_vjp(rate, dtype):
    jb, tb = _band(60)
    x, w, wa, g = _gat_inputs(2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    seed_j = jnp.array([SEED], jnp.int32) if rate else None
    y, vjp = jax.vjp(
        lambda w_, wa_, x_: jax_gat_wa(jnp.asarray(jb.bias_self), w_, wa_, x_,
                                       H, 0.2, rate, seed_j),
        jnp.asarray(w, jdt), jnp.asarray(wa, jdt), jnp.asarray(x, jdt))
    dw, dwa, dx = vjp(jnp.asarray(g, jdt))

    wt, wat, xt = (torch.from_numpy(a).to(tdt).requires_grad_()
                   for a in (w, wa, x))
    seed_t = torch.tensor([SEED], dtype=torch.int32) if rate else None
    yt = banded_gat_mean_fused_wa(tb.bias_self, wt, wat, xt, H, 0.2, rate,
                                  seed_t)
    yt.backward(torch.from_numpy(g).to(tdt))
    assert wt.grad.dtype == tdt and xt.grad.dtype == tdt
    tol = GAT_BWD_TOL[dtype]
    assert _rel(yt, y) <= (1e-5 if dtype == "float32" else 1e-2)
    for name, got, want in (("dW", wt.grad, dw), ("dWa", wat.grad, dwa),
                            ("dx", xt.grad, dx)):
        assert _rel(got, want) <= tol, name


def test_cpu_tensors_count_no_launch():
    _build.reset_launches()
    _, tb = _band(60)
    x, w, wa, g = _gat_inputs()
    xt = torch.from_numpy(x).requires_grad_()
    y = banded_gat_mean_fused_wa(tb.bias_self, torch.from_numpy(w),
                                 torch.from_numpy(wa), xt, H, 0.2, 0.1,
                                 torch.tensor([SEED], dtype=torch.int32))
    y.backward(torch.from_numpy(g))
    assert sum(_build.LAUNCHES.values()) == 0


N_VALID, N_PAD, CE = 300, 384, 64
EPI_MODES = {"float32": ("float32", "float32"),
             "bfloat16": ("bfloat16", "bfloat16"),
             "mixed": ("float32", "bfloat16")}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode", sorted(EPI_MODES))
def test_epilogue_forward_backward_match_jax_vjp(mode, rate):
    dx_, dxn_ = EPI_MODES[mode]
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(N_PAD, CE)) + rng.normal(size=CE)).astype(np.float32)
    xn = rng.normal(size=(N_PAD, CE)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=CE)).astype(np.float32)
    bias = (0.1 * rng.normal(size=CE)).astype(np.float32)
    g = rng.normal(size=(N_PAD, CE)).astype(np.float32)
    seed_j = jnp.array([SEED], jnp.int32) if rate else None
    (y, mean, var), vjp = jax.vjp(
        lambda a, b, s, t: jax_epilogue(a, b, s, t, seed_j, N_VALID, rate,
                                        1e-5),
        jnp.asarray(x, dx_), jnp.asarray(xn, dxn_), jnp.asarray(scale),
        jnp.asarray(bias))
    cts = vjp((jnp.asarray(g, y.dtype), jnp.zeros_like(mean),
               jnp.zeros_like(var)))

    xt = torch.from_numpy(x).to(getattr(torch, dx_)).requires_grad_()
    xnt = torch.from_numpy(xn).to(getattr(torch, dxn_)).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    yt, mt, vt = fused_epilogue(
        xt, xnt, st, bt,
        torch.tensor([SEED], dtype=torch.int32) if rate else None,
        N_VALID, rate, 1e-5)
    yt.backward(torch.from_numpy(g).to(yt.dtype))
    # dropout masks are bit-identical: the same elements are zero
    np.testing.assert_array_equal(yt.detach().float().numpy() == 0,
                                  np.asarray(y, np.float32) == 0)
    assert xt.grad.dtype == xt.dtype and xnt.grad.dtype == xnt.dtype
    # f32 (and the f32 stream of mixed): summation order only.  bf16
    # values: interpret-mode Pallas drops intermediate bf16 roundings the
    # port keeps (see test_torch_epilogue.py), a few bf16 ulps (2^-8
    # relative); a mixed dx_new is a bf16 cast of an f32 value
    f32_tol = 1e-4
    bf_tol = 2e-2
    assert _rel(yt, y) <= (bf_tol if mode == "bfloat16" else f32_tol)
    assert _rel(mt, mean) <= (bf_tol if mode == "bfloat16" else f32_tol)
    for name, got, want, dt in (("dx", xt.grad, cts[0], dx_),
                                ("dx_new", xnt.grad, cts[1], dxn_),
                                ("dscale", st.grad, cts[2], "float32"),
                                ("dbias", bt.grad, cts[3], "float32")):
        tol = bf_tol if "bfloat16" in (dt, dx_) else f32_tol
        assert _rel(got, want) <= tol, name
