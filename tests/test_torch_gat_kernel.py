"""Port banded GAT forward (gnn_bfs_rans_tpu_torch.kernels.banded) vs JAX.

The port's plain version runs on the CPU against the JAX package's
``banded_gat_mean_fused``, which runs its Pallas kernel in interpret mode
here, on the same numpy inputs and the same int8 band.  The CUDA kernel is
held against the plain version on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.graph.band import build_band as jax_build_band
from gnn_bfs_rans_tpu.kernels.banded import banded_gat_mean_fused as jax_gat
from gnn_bfs_rans_tpu_torch.graph.band import build_band
from gnn_bfs_rans_tpu_torch.kernels import _build
from gnn_bfs_rans_tpu_torch.kernels.banded import banded_gat_mean_fused

N, H, C, F = 384, 2, 32, 32


def _band_edges(n, width, seed):
    """Random symmetric edges with |s − r| < width, plus a chain."""
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(n, 1)
    keep = ((j - i) < width) & (rng.random(i.size) < 0.05)
    keep |= (j - i) == 1
    s = np.concatenate([i[keep], j[keep]])
    r = np.concatenate([j[keep], i[keep]])
    order = np.lexsort((s, r))
    return s[order].astype(np.int32), r[order].astype(np.int32)


def _band(width):
    """(JAX Band, port Band) built from the same edges; tile 128, n 384."""
    s, r = _band_edges(N, width, seed=0)
    mask = np.ones(N, bool)
    deg = np.bincount(r, minlength=N).astype(np.float32)
    args = (s, r, N, mask, deg)
    return (jax_build_band(*args, tile=128, components=("bias_self",)),
            build_band(*args, tile=128, components=("bias_self",)))


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F)).astype(np.float32)
    w = (0.3 * rng.normal(size=(F, H * C))).astype(np.float32)
    wa = (0.5 * rng.normal(size=(F, 2 * H))).astype(np.float32)
    return x, w, wa


# bandwidth < 64 → half-tile window Wcols 256 (the BFS-mesh class);
# bandwidth in (64, 128] → Wcols 384
@pytest.mark.parametrize("width,wcols", [(60, 256), (100, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax(width, wcols, dtype):
    jb, tb = _band(width)
    assert tb.bias_self.shape == (3, 128, wcols)
    np.testing.assert_array_equal(tb.bias_self.numpy(), jb.bias_self)
    x, w, wa = _inputs()
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    alphas = np.array(jnp.dot(xj, jnp.asarray(wa, jdt),
                              preferred_element_type=jnp.float32))
    ref = np.asarray(jax_gat(jnp.asarray(jb.bias_self), wj,
                             jnp.asarray(alphas), xj, H, 0.2), np.float32)
    got = banded_gat_mean_fused(
        tb.bias_self, torch.from_numpy(w).to(tdt), torch.from_numpy(alphas),
        torch.from_numpy(x).to(tdt), H, 0.2)
    assert got.dtype == tdt and got.shape == (N, C)
    got = got.float().numpy()
    scale = np.abs(ref).max()
    if dtype == "float32":
        # same f32 arithmetic, other summation orders: ~1e-7 relative
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)
    else:
        # z and the output round to bf16 (8 mantissa bits) in both; a
        # different f32 summation order can flip one rounding, i.e. one
        # bf16 ulp (2^-8 relative) of an element
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-2 * scale)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    _build.reset_launches()
    _, tb = _band(60)
    x, w, wa = _inputs()
    xt = torch.from_numpy(x)
    alphas = xt @ torch.from_numpy(wa)
    banded_gat_mean_fused(tb.bias_self, torch.from_numpy(w), alphas, xt, H)
    assert _build.LAUNCHES["banded_gat_mean_fused"] == 0

