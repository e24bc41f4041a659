"""The port's kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu_torch.foam import box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import build_band
from gnn_bfs_rans_tpu_torch.infer import predict_case
from gnn_bfs_rans_tpu_torch.kernels import _build
from gnn_bfs_rans_tpu_torch.kernels.banded import (
    banded_gat_mean_fused,
    banded_gat_mean_fused_plain,
)
from gnn_bfs_rans_tpu_torch.kernels.epilogue import (
    fused_epilogue_fwd,
    fused_epilogue_fwd_plain,
)
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.train.checkpoint import save_checkpoint
from gnn_bfs_rans_tpu_torch.train.normalization import FieldNormalizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The card, decided at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "pytest tests/test_torch_cuda.py -m cuda --noconftest)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _band(n, width, seed=0):
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(n, 1)
    keep = (((j - i) < width) & (rng.random(i.size) < 0.05)) | ((j - i) == 1)
    s = np.concatenate([i[keep], j[keep]]).astype(np.int32)
    r = np.concatenate([j[keep], i[keep]]).astype(np.int32)
    deg = np.bincount(r, minlength=n).astype(np.float32)
    return build_band(s, r, n, np.ones(n, bool), deg, tile=128,
                      components=("bias_self",)).bias_self


# width 60 → Wcols 256, width 100 → Wcols 384; C 96 leaves a partial
# 32-column group in the attention kernel
@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,c,f", [(2, 32, 32), (4, 96, 64)])
def test_gat_kernel_matches_plain(card, width, dtype, heads, c, f):
    n = 512
    gen = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    x = torch.randn(n, f, generator=gen).to(card, dt)
    w = (torch.randn(f, heads * c, generator=gen) * f ** -0.5).to(card, dt)
    wa = torch.randn(f, 2 * heads, generator=gen).to(card, dt)
    alphas = (x.float() @ wa.float()).contiguous()
    mask = _band(n, width).to(card)
    before = _build.LAUNCHES["banded_gat_mean_fused"]
    got = banded_gat_mean_fused(mask, w, alphas, x, heads)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_gat_mean_fused"] == before + 1
    ref = banded_gat_mean_fused_plain(mask, w, alphas, x, heads)
    scale = ref.float().abs().max().item()
    # f32: other summation orders only; bf16: one z or output rounding to
    # bf16 (2^-8 relative) may flip
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               rtol=tol, atol=tol * scale)


def test_gat_kernel_rejects_bad_input(card):
    mask = _band(256, 60).to(card)
    x = torch.zeros(256, 32, device=card)
    w = torch.zeros(32, 64, device=card)
    alphas = torch.zeros(256, 4, device=card)
    with pytest.raises(TypeError):
        banded_gat_mean_fused(mask, w.bfloat16(), alphas, x, 2)
    with pytest.raises(ValueError):
        banded_gat_mean_fused(mask, w, alphas[:, :2].contiguous(), x, 2)
    with pytest.raises(ValueError):
        banded_gat_mean_fused(mask.cpu(), w, alphas, x, 2)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "mixed"])
def test_epilogue_kernel_matches_plain(card, mode):
    dx, dxn = {"float32": ("float32", "float32"),
               "bfloat16": ("bfloat16", "bfloat16"),
               "mixed": ("float32", "bfloat16")}[mode]
    gen = torch.Generator().manual_seed(1)
    n, c, n_valid = 1000, 96, 937
    args = ((torch.randn(n, c, generator=gen) + 2).to(card, getattr(torch, dx)),
            torch.randn(n, c, generator=gen).to(card, getattr(torch, dxn)),
            (1 + 0.1 * torch.randn(c, generator=gen)).to(card),
            (0.1 * torch.randn(c, generator=gen)).to(card))
    before = _build.LAUNCHES["fused_epilogue_fwd"]
    y, mean, var = fused_epilogue_fwd(*args, n_valid, 1e-5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_epilogue_fwd"] == before + 2
    y_ref, m_ref, v_ref = fused_epilogue_fwd_plain(*args, n_valid, 1e-5)
    assert y.dtype == y_ref.dtype
    # statistics: f32 sums in other orders
    torch.testing.assert_close(mean, m_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(var, v_ref, rtol=1e-4, atol=1e-5)
    # values: f32 exact up to order; bf16 one rounding may flip (a bf16 ulp
    # of values up to ~8 is 2^-5)
    tol = 1e-5 if mode != "bfloat16" else 5e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "mixed"])
def test_predict_case_card_matches_cpu(card, tmp_path, dtype):
    info = generate_box_case(tmp_path / "case", 24, 14, 1)
    cfg = ModelConfig(hidden_dim=64, num_layers=2, layer_type="GAT",
                      heads=2, backend="pallas", compute_dtype=dtype)
    model = FlowGNN(cfg, generator=torch.Generator().manual_seed(2))
    save_checkpoint(tmp_path / "ckpt", "best", model.state_dict(),
                    model_config=cfg,
                    normalizer=FieldNormalizer().fit(
                        box_fields(info["cell_centers"])))
    for exact_bn in (False, True):
        _build.reset_launches()
        _, got, _ = predict_case(tmp_path / "ckpt", tmp_path / "case",
                                 exact_bn=exact_bn, device="cuda")
        want_launch = {"banded_gat_mean_fused": 2}
        if exact_bn:
            want_launch["fused_epilogue_fwd"] = 4
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == want_launch
        _, ref, _ = predict_case(tmp_path / "ckpt", tmp_path / "case",
                                 exact_bn=exact_bn, device="cpu")
        tol = 1e-4 if dtype == "float32" else 2e-2
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=tol,
                                       atol=tol * np.abs(ref[k]).max())
