"""Port fused epilogue forward (gnn_bfs_rans_tpu_torch.kernels.epilogue) vs JAX.

The port's plain version runs on the CPU against the JAX package's
``fused_epilogue`` at rate 0 (its Pallas passes in interpret mode), on the
same numpy inputs, in float32, bfloat16 and mixed (f32 stream + bf16 conv
output).  The CUDA kernel is held against the plain version on the card
by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.kernels.epilogue import fused_epilogue
from gnn_bfs_rans_tpu_torch.kernels.epilogue import fused_epilogue_fwd

N_VALID, N_PAD, C = 300, 384, 64
EPS = 1e-5
DTYPES = {"float32": ("float32", "float32"), "bfloat16": ("bfloat16", "bfloat16"),
          "mixed": ("float32", "bfloat16")}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    # channel means of the size of the spread, as after a conv
    x = (rng.normal(size=(N_PAD, C)) + rng.normal(size=C)).astype(np.float32)
    x_new = rng.normal(size=(N_PAD, C)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=C)).astype(np.float32)
    bias = (0.1 * rng.normal(size=C)).astype(np.float32)
    return x, x_new, scale, bias


@pytest.mark.parametrize("mode", sorted(DTYPES))
def test_plain_matches_jax(mode):
    dx, dxn = DTYPES[mode]
    x, x_new, scale, bias = _inputs()
    y_ref, m_ref, v_ref = fused_epilogue(
        jnp.asarray(x, dx), jnp.asarray(x_new, dxn), jnp.asarray(scale),
        jnp.asarray(bias), None, N_VALID, 0.0, EPS)
    y, m, v = fused_epilogue_fwd(
        torch.from_numpy(x).to(getattr(torch, dx)),
        torch.from_numpy(x_new).to(getattr(torch, dxn)),
        torch.from_numpy(scale), torch.from_numpy(bias), N_VALID, EPS)
    out_dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
    assert y.dtype == out_dt and y.shape == (N_PAD, C)
    y = y.float().numpy()
    y_ref = np.asarray(y_ref, np.float32)
    if mode == "bfloat16":
        # interpret-mode Pallas runs the bf16 residual add and affine in f32
        # without the intermediate bf16 roundings the port keeps (the JAX
        # package's own test_epilogue.py allows 5e-2 for the same reason):
        # a few bf16 ulps (2^-8 relative) of an element of size ~3
        np.testing.assert_allclose(y, y_ref, rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), atol=2e-3)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-2)
    else:
        # f32 throughout; block-sum orders differ: ~1e-7 relative
        np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(m.numpy(), np.asarray(m_ref),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5)


def test_stats_exclude_pad_rows():
    x, x_new, scale, bias = _inputs()
    x[N_VALID:] = 1e3  # garbage in pad rows must not reach the statistics
    xt, xnt = torch.from_numpy(x), torch.from_numpy(x_new)
    _, m, _ = fused_epilogue_fwd(xt, xnt, torch.from_numpy(scale),
                                 torch.from_numpy(bias), N_VALID, EPS)
    ref = (xt + xnt)[:N_VALID].mean(0)
    torch.testing.assert_close(m, ref, rtol=1e-5, atol=1e-5)

