"""The port's kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu_torch.foam import box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import build_band
from gnn_bfs_rans_tpu_torch.graph.build import compute_edge_features
from gnn_bfs_rans_tpu_torch.infer import predict_case
from gnn_bfs_rans_tpu_torch.kernels import _build
from gnn_bfs_rans_tpu_torch.kernels.banded import (
    banded_gat,
    banded_gat_mean,
    banded_gat_mean_fused,
    banded_gat_mean_fused_plain,
    banded_gat_mean_packed,
    banded_gat_mean_plain,
    banded_gat_packed,
    banded_gat_plain,
    banded_spmm,
    banded_spmm_fwd,
    banded_spmm_plain,
    banded_transformer_fwd,
    banded_transformer_fwd_plain,
    banded_transformer_geo_mean_fused,
    banded_transformer_geo_mean_fused_plain,
    _qw_plain,
    banded_transformer_geo_mean_projgrad,
    transformer_project,
    transformer_project_plain,
    transpose_band,
)
from gnn_bfs_rans_tpu_torch.kernels.banded_bwd import (
    banded_gat_bwd,
    banded_gat_bwd_plain,
    banded_transformer_bwd,
    banded_transformer_bwd_plain,
    fold_partials,
    fold_partials_plain,
    fold_project_bwd,
    fold_project_bwd_plain,
    transpose_mask,
)
from gnn_bfs_rans_tpu_torch.kernels.epilogue import (
    _forward,
    _forward_plain,
    fused_epilogue,
    fused_epilogue_bwd,
    fused_epilogue_bwd_plain,
    fused_epilogue_fwd,
    fused_epilogue_fwd_plain,
)
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.train.checkpoint import save_checkpoint
from gnn_bfs_rans_tpu_torch.train.loop import (
    TrainConfig,
    make_optimizer,
    train_step,
)
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


def _band(n, width, seed=0, tile=128):
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(n, 1)
    keep = (((j - i) < width) & (rng.random(i.size) < 0.05)) | ((j - i) == 1)
    s = np.concatenate([i[keep], j[keep]]).astype(np.int32)
    r = np.concatenate([j[keep], i[keep]]).astype(np.int32)
    deg = np.bincount(r, minlength=n).astype(np.float32)
    return build_band(s, r, n, np.ones(n, bool), deg, tile=tile,
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


def _close(got, want, tol, floor=1e-30):
    """max |got − want| ≤ tol × max(max |want|, floor)."""
    want = want.float().cpu()
    scale = max(want.abs().max().item(), floor)
    err = (got.float().cpu() - want).abs().max().item()
    assert err <= tol * scale, f"max err {err} > {tol} × {scale}"


def _seed(card):
    return torch.tensor([1234], dtype=torch.int32, device=card)


# f32: summation order only; bf16: one rounding of z, dz or an output may
# flip (one bf16 ulp, 2^-8 relative), and dx, dW sum such values
KTOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_kernel_training_form_matches_plain(card, width, dtype):
    n, heads, c, f = 512, 4, 64, 64
    gen = torch.Generator().manual_seed(3)
    dt = getattr(torch, dtype)
    x = torch.randn(n, f, generator=gen).to(card, dt)
    w = (torch.randn(f, heads * c, generator=gen) * f ** -0.5).to(card, dt)
    alphas = (x.float() @ torch.randn(f, 2 * heads, generator=gen).to(card)
              ).contiguous()
    mask = _band(n, width).to(card)
    args = (mask, w, alphas, x, heads, 0.2, 0.1, _seed(card))
    out, z = banded_gat_mean_fused(*args, emit_z=True)
    ref, ref_z = banded_gat_mean_fused_plain(*args, emit_z=True)
    torch.cuda.synchronize()
    _close(z, ref_z, 1e-6 if dtype == "float32" else 1e-2)
    _close(out, ref, KTOL[dtype])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_backward_kernels_match_plain(card, width, dtype, rate):
    n, heads, c, f = 512, 4, 64, 64
    gen = torch.Generator().manual_seed(4)
    dt = getattr(torch, dtype)
    x = torch.randn(n, f, generator=gen).to(card, dt)
    w = (torch.randn(f, heads * c, generator=gen) * f ** -0.5).to(card, dt)
    z = (x.float() @ w.float()).to(dt)
    alphas = (x.float() @ torch.randn(f, 2 * heads, generator=gen).to(card)
              ).contiguous()
    g = torch.randn(n, c, generator=gen).to(card, dt)
    mask = _band(n, width).to(card)
    seed = _seed(card) if rate else None
    _build.reset_launches()
    dz, da = banded_gat_bwd(mask, z, alphas, g, heads, 0.2, rate, seed,
                            mask_t=transpose_mask(mask))
    dx, dw = fold_project_bwd(dz, x, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_gat_bwd"] == 1
    assert _build.LAUNCHES["fold_project_bwd"] == 1
    ref_dz, ref_da = banded_gat_bwd_plain(mask, z, alphas, g, heads, 0.2, rate,
                                          seed)
    _close(dz, ref_dz, KTOL[dtype])
    _close(da, ref_da, 1e-4 if dtype == "float32" else 1e-2)
    ref_dx, ref_dw = fold_project_bwd_plain(dz, x, w)
    assert dx.dtype == dt and dw.dtype == torch.float32
    _close(dx, ref_dx, KTOL[dtype])
    _close(dw, ref_dw, 1e-4 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "mixed"])
def test_epilogue_backward_matches_plain(card, mode, rate):
    dx_, dxn_ = {"float32": ("float32", "float32"),
                 "bfloat16": ("bfloat16", "bfloat16"),
                 "mixed": ("float32", "bfloat16")}[mode]
    gen = torch.Generator().manual_seed(5)
    n, c, n_valid = 1000, 96, 937
    x = (torch.randn(n, c, generator=gen) + 2).to(card, getattr(torch, dx_))
    xn = torch.randn(n, c, generator=gen).to(card, getattr(torch, dxn_))
    scale = (1 + 0.1 * torch.randn(c, generator=gen)).to(card)
    bias = (0.1 * torch.randn(c, generator=gen)).to(card)
    seed = _seed(card) if rate else None
    xs = [t.clone().requires_grad_() for t in (x, xn, scale, bias)]
    _build.reset_launches()
    y, mean, var = fused_epilogue(*xs, seed, n_valid, rate, 1e-5)
    g = torch.randn(y.shape, generator=gen).to(card, y.dtype)
    y.backward(g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_epilogue_fwd"] == 2
    assert _build.LAUNCHES["fused_epilogue_bwd"] == 2
    y_ref = _forward_plain(x, xn, scale, bias, n_valid, 1e-5, rate, seed)[0]
    tol = 5e-2 if mode == "bfloat16" else 1e-5
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    # the dropout masks are identical: no element is dropped on one side
    # only (a bf16 rounding may move a value across the ReLU's 0, within tol)
    assert not ((y == 0) & (y_ref.float().abs() > tol)).any()
    assert not ((y_ref == 0) & (y.float().abs() > tol)).any()
    # the backward on the kernel forward's own residuals: the same ReLU
    # predicate on both sides, sums in other orders
    _, m_k, _, xr, vec = _forward(x, xn, scale, bias, n_valid, 1e-5, rate,
                                  seed)
    grads = fused_epilogue_bwd_plain(g, xr, vec, m_k, n_valid, rate, seed,
                                     x.dtype, xn.dtype)
    for t, ref in zip(xs, grads):
        assert t.grad.dtype == ref.dtype
        _close(t.grad, ref, 1e-4 if ref.dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("n,c", [
    (12032, 256),   # held in shared memory (f32: 92 rows, 204 KB a block)
    (40000, 256),   # too many rows a block: phase 3 reads g and xr again
    (3000, 50),     # C not a multiple of 4: one element a thread
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "mixed"])
def test_epilogue_backward_branches_match_plain(card, mode, rate, n, c):
    """Row 3's one launch at the sizes of its shared-memory and re-read
    branches against the plain version on the same residuals (f32
    summation order 1e-4; bf16 one rounding, 2^-7), deterministic from call
    to call.  g carries a per-column offset, so that the statistics terms
    G1/n and x̂·G2/n are of the order of g in dx."""
    dx_, dxn_ = {"float32": ("float32", "float32"),
                 "bfloat16": ("bfloat16", "bfloat16"),
                 "mixed": ("float32", "bfloat16")}[mode]
    gen = torch.Generator().manual_seed(6)
    n_valid = n - 37
    x = (torch.randn(n, c, generator=gen) + 1).to(card, getattr(torch, dx_))
    xn = torch.randn(n, c, generator=gen).to(card, getattr(torch, dxn_))
    scale = (1 + 0.1 * torch.randn(c, generator=gen)).to(card)
    bias = (0.1 * torch.randn(c, generator=gen)).to(card)
    seed = _seed(card) if rate else None
    _, mean, _, xr, vec = _forward(x, xn, scale, bias, n_valid, 1e-5, rate,
                                   seed)
    g = (torch.randn(n, c, generator=gen)
         + torch.randn(c, generator=gen)).to(card, xr.dtype)
    args = (g, xr, vec, mean, n_valid, rate, seed, x.dtype, xn.dtype)
    _build.reset_launches()
    got = fused_epilogue_bwd(*args)
    again = fused_epilogue_bwd(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_epilogue_bwd"] == 4
    ref = fused_epilogue_bwd_plain(*args)
    for a, b, r in zip(got, again, ref):
        assert a.dtype == r.dtype and torch.equal(a, b)
        _close(a, r, 1e-4 if r.dtype == torch.float32 else 2.0 ** -7)


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_epilogue_backward_replays_in_a_graph(card, mode):
    """Row 3's cooperative launch captured in a CUDA graph (three calls, the
    barrier's counter reused): two replays give identical bytes, equal to
    an eager call's."""
    gen = torch.Generator().manual_seed(7)
    n, c, n_valid = 12032, 256, 12000
    dt = getattr(torch, mode)
    x = (torch.randn(n, c, generator=gen) + 1).to(card, dt)
    xn = torch.randn(n, c, generator=gen).to(card, dt)
    scale = (1 + 0.1 * torch.randn(c, generator=gen)).to(card)
    bias = (0.1 * torch.randn(c, generator=gen)).to(card)
    seed = _seed(card)
    _, mean, _, xr, vec = _forward(x, xn, scale, bias, n_valid, 1e-5, 0.1,
                                   seed)
    g = torch.randn(n, c, generator=gen).to(card, dt)
    args = (g, xr, vec, mean, n_valid, 0.1, seed, dt, dt)
    eager = [t.clone() for t in fused_epilogue_bwd(*args)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_epilogue_bwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(3):
            outs = fused_epilogue_bwd(*args)
    graph.replay()
    torch.cuda.synchronize()
    first = [t.clone() for t in outs]
    graph.replay()
    torch.cuda.synchronize()
    for a, b, e in zip(outs, first, eager):
        assert torch.equal(a, b) and torch.equal(a, e)


def _epilogue_inputs(card, mode, n, c, gen):
    dx_, dxn_ = {"float32": ("float32", "float32"),
                 "bfloat16": ("bfloat16", "bfloat16"),
                 "mixed": ("float32", "bfloat16")}[mode]
    return ((torch.randn(n, c, generator=gen) + 1).to(card, getattr(torch, dx_)),
            torch.randn(n, c, generator=gen).to(card, getattr(torch, dxn_)),
            (1 + 0.1 * torch.randn(c, generator=gen)).to(card),
            (0.1 * torch.randn(c, generator=gen)).to(card))


@pytest.mark.parametrize("n,c", [
    (12032, 256),   # the flagship: xr held in shared memory
    (60000, 256),   # above the held-tile limit: phase 3 reads xr back
    (3000, 50),     # C not a multiple of 4: one element a thread
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "mixed"])
def test_epilogue_forward_branches_match_plain(card, mode, rate, n, c):
    """Row 2's one launch at the sizes of its shared-memory and read-back
    branches against the plain version (xr: one rounding, equal; y: f32
    summation order 1e-5, bf16 two ulps 2^-7; the statistics 1e-5), the
    dropout masks the same, and the same bits on a second call."""
    gen = torch.Generator().manual_seed(9)
    args = _epilogue_inputs(card, mode, n, c, gen)
    seed = _seed(card) if rate else None
    fwd = (*args, n - 37, 1e-5, rate, seed)
    _build.reset_launches()
    got = [t.clone() for t in _forward(*fwd)]
    again = _forward(*fwd)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_epilogue_fwd"] == 4
    ref = _forward_plain(*fwd)
    for a, b, r in zip(got, again, ref):
        assert a.dtype == r.dtype and torch.equal(a, b)
    y, mean, var, xr, vec = got
    assert torch.equal(xr, ref[3])
    _close(y, ref[0], 1e-5 if y.dtype == torch.float32 else 2.0 ** -7)
    for a, r in zip((mean, var, vec), ref[1:3] + (ref[4],)):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
    if rate:   # nothing dropped on one side only
        tol = 2.0 ** -7 * ref[0].float().abs().max()
        assert not ((y == 0) & (ref[0].float().abs() > tol)).any()
        assert not ((ref[0] == 0) & (y.float().abs() > tol)).any()


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "mixed"])
def test_epilogue_forward_on_two_streams(card, mode):
    """Row 2 and row 3 launched on two streams at once, each stream with its
    own barrier counter: both results equal the same calls made one after
    the other on the default stream."""
    gen = torch.Generator().manual_seed(10)
    n, c = 12032, 256
    runs = []
    for _ in range(2):
        args = _epilogue_inputs(card, mode, n, c, gen)
        g = torch.randn(n, c, generator=gen).to(card)
        runs.append((args, g))
    seed = _seed(card)

    def step(args, g):
        y, mean, _, xr, vec = _forward(*args, n - 32, 1e-5, 0.1, seed)
        return (y, xr, vec) + fused_epilogue_bwd(
            g.to(xr.dtype), xr, vec, mean, n - 32, 0.1, seed, args[0].dtype,
            args[1].dtype)

    want = [[t.clone() for t in step(*r)] for r in runs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in runs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(3):
        for s, r in zip(streams, runs):
            with torch.cuda.stream(s):
                outs.append(step(*r))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        for a, b in zip(got, want[i % 2]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_epilogue_forward_replays_in_a_graph(card, mode, rate):
    """Row 2's cooperative launch captured in a CUDA graph (three calls on
    the capture stream's counter, one launch after another): two replays
    give the same bytes as an eager call."""
    gen = torch.Generator().manual_seed(11)
    n = 12032
    args = _epilogue_inputs(card, mode, n, 256, gen)
    fwd = (*args, n - 32, 1e-5, rate, _seed(card) if rate else None)
    eager = [t.clone() for t in _forward(*fwd)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _forward(*fwd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(3):
            outs = _forward(*fwd)
    graph.replay()
    torch.cuda.synchronize()
    first = [t.clone() for t in outs]
    graph.replay()
    torch.cuda.synchronize()
    for a, b, e in zip(outs, first, eager):
        assert torch.equal(a, b) and torch.equal(a, e)


# a conv bias that feeds the BatchNorm (GCN and GAT ``bias``, GIN's last
# MLP layer): its gradient is zero in exact arithmetic, rounding noise here
_FEEDS_BN = re.compile(r"convs\.\d+\.(nn\.2\.)?bias")


# the Transformer's leaves whose gradient is zero in exact arithmetic: the
# key bias (every logit of a row alike), the value and skip biases (every
# row of a channel alike before the BatchNorm)
_TR_FEEDS_BN = re.compile(r"convs\.\d+\.lin_(key|value|skip)\.bias")


def _train_step_card_vs_cpu(card, tmp_path, cfg, zero_grad=_FEEDS_BN,
                            zero_tol=None):
    """One train step of ``cfg`` on the 336-cell case, card vs CPU;
    ``zero_grad``: the parameters whose gradient is rounding noise, held in
    bf16 and mixed, with ``zero_tol``, to that share of the largest
    group's norm (two noises have no ratio)."""
    from gnn_bfs_rans_tpu_torch.infer import load_graph

    generate_box_case(tmp_path / "case", 24, 14, 1)
    graph = load_graph(tmp_path / "case", cfg.layer_type)
    dtype = cfg.compute_dtype
    tcfg = TrainConfig(lr=1e-3)
    targets = torch.randn(2, graph.n_pad, 7,
                          generator=torch.Generator().manual_seed(6))
    results = []
    for dev in ("cpu", card):
        model = FlowGNN(cfg, generator=torch.Generator().manual_seed(2)).to(dev)
        loss = train_step(model, make_optimizer(model, tcfg), graph.to(dev),
                          targets.to(dev), 1e-3, tcfg)
        # the clipped gradients the step applied, and the parameters after
        results.append((loss.item(),
                        {k: p.grad.float().cpu()
                         for k, p in model.named_parameters()},
                        {k: p.detach().float().cpu()
                         for k, p in model.named_parameters()}))
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = results
    assert l_card == pytest.approx(l_cpu, rel=1e-5 if dtype == "float32"
                                   else 2e-2)
    if dtype != "float32":
        # each group's gradient on the card lies no further from the f32
        # step's than 1.5 × the CPU bf16 (mixed) step's own distance, plus
        # 1e-4 of the group's norm (of the largest group's for a conv bias,
        # whose gradient is rounding noise): the kernels are as accurate as
        # the plain versions, which round at the same points
        f32 = FlowGNN(dataclasses.replace(cfg, compute_dtype="float32"),
                      generator=torch.Generator().manual_seed(2))
        train_step(f32, make_optimizer(f32, tcfg), graph, targets, 1e-3,
                   tcfg)
        g_f32 = {k: p.grad for k, p in f32.named_parameters()}
        g_norm = max(g.norm().item() for g in g_f32.values())
        for k, ref in g_f32.items():
            own = (g_cpu[k] - ref).norm().item()
            dist = (g_card[k] - ref).norm().item()
            scale = g_norm if zero_grad.fullmatch(k) else ref.norm().item()
            if zero_tol is not None and zero_grad.fullmatch(k):
                assert dist <= zero_tol * g_norm, (k, dist, g_norm)
                continue
            assert dist <= 1.5 * own + 1e-4 * scale, (k, dist, own)
    if dtype == "float32":
        # f32 in other summation orders through 2 layers and back: an entry
        # of input_proj's gradient sums ± terms over every node, which
        # amplifies the rounding ~10× (measured 1.2e-4 of its largest
        # entry); a group whose gradient nearly cancels (input_proj's bias,
        # the attention vectors) is measured against 1e-3 of the largest one
        floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
        for k in g_cpu:
            if zero_grad.fullmatch(k):
                continue   # zero gradient up to rounding: Adam moves ±lr
            _close(g_card[k], g_cpu[k], 1e-3, floor)
            # Adam's first step is lr·g/(|g| + ε): it moves each entry by
            # ≈ ±lr whatever the size of g, so where g is small beside the
            # gradients' rounding the sign is a coin toss; the step is
            # compared where |g| ≥ 1e-6 and ≥ 1% of the group's largest
            firm = g_cpu[k].abs() >= max(1e-6, 1e-2 * g_cpu[k].abs().max().item())
            torch.testing.assert_close(p_card[k][firm], p_cpu[k][firm],
                                       rtol=1e-4, atol=1e-3 * tcfg.lr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
def test_train_step_card_matches_cpu(card, tmp_path, dtype):
    _train_step_card_vs_cpu(card, tmp_path, ModelConfig(
        hidden_dim=64, num_layers=2, layer_type="GAT", heads=2,
        backend="pallas", compute_dtype=dtype, dropout=0.0))


@pytest.mark.parametrize("layer,dtype", [
    ("GCN", "float32"), ("GCN", "bfloat16"), ("GCN", "mixed"),
    ("GIN", "float32"), ("GAT-unfused", "bfloat16")])
def test_train_step_card_matches_cpu_other_convs(card, tmp_path, layer,
                                                 dtype):
    extra = dict(layer_type="GAT", heads=2, fuse_train=False) \
        if layer == "GAT-unfused" else dict(layer_type=layer)
    _build.reset_launches()
    _train_step_card_vs_cpu(card, tmp_path, ModelConfig(
        hidden_dim=64, num_layers=2, backend="pallas", compute_dtype=dtype,
        dropout=0.0, **extra))
    want = "banded_gat_mean" if layer == "GAT-unfused" else "banded_spmm"
    # forward and backward of each layer (GCN, GIN) or the forward (GAT)
    assert _build.LAUNCHES[want] == (2 if layer == "GAT-unfused" else 4)


@pytest.mark.parametrize("layer,backend,norm,dtype", [
    ("GAT", "dense", "batch", "float32"),
    ("Transformer", "segment", "batch", "float32"),
    ("GCN", "dense", "layer", "bfloat16")])
def test_train_step_card_matches_cpu_backends(card, tmp_path, layer, backend,
                                              norm, dtype):
    """The dense and segment backends (plain torch on the card, the unfused
    BatchNorm or LayerNorm) launch no kernel of the port and train as on
    the CPU."""
    extra = dict(heads=2) if layer in ("GAT", "Transformer") else {}
    _build.reset_launches()
    _train_step_card_vs_cpu(card, tmp_path, ModelConfig(
        hidden_dim=64, num_layers=2, layer_type=layer, backend=backend,
        norm_type=norm, compute_dtype=dtype, dropout=0.0, **extra),
        zero_grad=_TR_FEEDS_BN if layer == "Transformer" else _FEEDS_BN)
    assert sum(_build.LAUNCHES.values()) == 0


def _spmm_band(n, width, seed=0):
    """The GCN and GIN planes of random symmetric edges, |s − r| < width."""
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(n, 1)
    keep = (((j - i) < width) & (rng.random(i.size) < 0.05)) | ((j - i) == 1)
    s = np.concatenate([i[keep], j[keep]]).astype(np.int32)
    r = np.concatenate([j[keep], i[keep]]).astype(np.int32)
    mask = np.arange(n) < n - 37            # a few padding rows
    keep = mask[s] & mask[r]
    s, r = s[keep], r[keep]
    deg = np.bincount(r, minlength=n).astype(np.float32)
    return build_band(s, r, n, mask, deg, tile=128, components=("adj", "gcn"))


# width 60 → W 3; width 200 → W 5
@pytest.mark.parametrize("width,window", [(60, 3), (200, 5)])
@pytest.mark.parametrize("plane", ["gcn", "adj"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_kernel_matches_plain(card, width, window, plane, dtype):
    n, f = 640, 64
    band = _spmm_band(n, width)
    a = getattr(band, plane).to(card)
    assert a.shape[1] == window
    gen = torch.Generator().manual_seed(7)
    dt = getattr(torch, dtype)
    x = torch.randn(n, f, generator=gen).to(card, dt)
    g = torch.randn(n, f, generator=gen).to(card, dt)
    _build.reset_launches()
    out = banded_spmm_fwd(a, x)
    xl = x.clone().requires_grad_()
    banded_spmm(a, xl).backward(g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_spmm"] == 3
    assert out.dtype == dt and xl.grad.dtype == dt
    # f32: exact f32 products summed in another order; bf16 x: the f32 sum
    # rounds once to bf16 on both sides, an order change may flip it
    tol = 1e-5 if dtype == "float32" else 1e-2
    _close(out, banded_spmm_plain(a, x), tol)
    _close(xl.grad, banded_spmm_plain(transpose_band(a), g), tol)


@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("plane", ["gcn", "adj"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_kernel_dense_and_boundary_rows(card, window, plane, dtype):
    """Row 8 on rows denser than a batch and than a whole window block
    (every coefficient of a row nonzero), on the boundary tiles' rows and
    on empty rows, against the plain version; the same bits on a second
    call."""
    n, f = 640, 256
    band = _spmm_band(n, {3: 60, 5: 200}[window])
    a = getattr(band, plane).clone().to(card)
    assert a.shape[1] == window
    val = 0.5 if plane == "gcn" else 1.0
    a[2, :, 7, :] = val                          # 384 (640) nonzeros
    a[1, window // 2, 100, :40] = val             # 40 in one block
    a[0, :, 3, :] = 0                            # an empty row
    a[0, : window // 2] = 0                      # boundary tiles' planes
    a[-1, window // 2 + 1:] = 0
    a[-1, window // 2, 127, :] = val
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(n, f, generator=gen).to(card, getattr(torch, dtype))
    out = banded_spmm_fwd(a, x)
    again = banded_spmm_fwd(a, x)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert not out[3].any()
    _close(out, banded_spmm_plain(a, x), 1e-5 if dtype == "float32" else 1e-2)


def test_spmm_kernel_rejects_bad_input(card):
    a = _spmm_band(256, 60).gcn.to(card)
    x = torch.zeros(256, 64, device=card)
    with pytest.raises(TypeError):
        banded_spmm_fwd(a, x.half())
    with pytest.raises(ValueError):
        banded_spmm_fwd(a, x[:128])
    with pytest.raises(ValueError):
        banded_spmm_fwd(a, torch.zeros(256, 6, device=card))
    with pytest.raises(ValueError):
        banded_spmm_fwd(a.cpu(), x)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_mean_kernel_and_op_match_plain(card, width, dtype, rate):
    n, heads, c = 512, 4, 64
    gen = torch.Generator().manual_seed(8)
    dt = getattr(torch, dtype)
    z = (0.5 * torch.randn(n, heads * c, generator=gen)).to(card, dt)
    alphas = torch.randn(n, 2 * heads, generator=gen).to(card)
    g = torch.randn(n, c, generator=gen).to(card, dt)
    mask = _band(n, width).to(card)
    seed = _seed(card) if rate else None
    args = (mask, z, alphas, heads, 0.2, rate, seed)
    _build.reset_launches()
    out = banded_gat_mean(*args)
    zl, al = z.clone().requires_grad_(), alphas.clone().requires_grad_()
    banded_gat_mean_packed(mask, zl, al, heads, 0.2, rate, seed).backward(g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_gat_mean"] == 2
    assert _build.LAUNCHES["banded_gat_bwd"] == 1
    _close(out, banded_gat_mean_plain(*args), KTOL[dtype])
    ref_dz, ref_da = banded_gat_bwd_plain(mask, z, alphas, g, heads, 0.2,
                                          rate, seed)
    _close(zl.grad, ref_dz, KTOL[dtype])
    _close(al.grad, ref_da, 1e-4 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_concat_kernel_and_op_match_plain(card, width, dtype, rate):
    """Row 4's concat form and row 5's per-head cotangent: the kernels
    through ``banded_gat`` and the op ``banded_gat_packed`` against their
    plain versions."""
    n, heads, c = 512, 4, 64
    gen = torch.Generator().manual_seed(9)
    dt = getattr(torch, dtype)
    z = (0.5 * torch.randn(n, heads * c, generator=gen)).to(card, dt)
    alphas = torch.randn(n, 2 * heads, generator=gen).to(card)
    g = torch.randn(n, heads * c, generator=gen).to(card, dt)
    mask = _band(n, width).to(card)
    seed = _seed(card) if rate else None
    args = (mask, z, alphas, heads, 0.2, rate, seed)
    _build.reset_launches()
    out = banded_gat(*args)
    zl, al = z.clone().requires_grad_(), alphas.clone().requires_grad_()
    banded_gat_packed(mask, zl, al, heads, 0.2, rate, seed).backward(g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_gat"] == 2
    assert _build.LAUNCHES["banded_gat_bwd"] == 1
    assert out.shape == (n, heads * c) and out.dtype == dt
    _close(out, banded_gat_plain(*args), KTOL[dtype])
    ref_dz, ref_da = banded_gat_bwd_plain(mask, z, alphas, g, heads, 0.2,
                                          rate, seed, mean_expand=False)
    _close(zl.grad, ref_dz, KTOL[dtype])
    _close(al.grad, ref_da, 1e-4 if dtype == "float32" else 1e-2)
    with pytest.raises(ValueError, match="shape"):
        banded_gat_bwd(mask, z, alphas, g[:, :c].contiguous(), heads, 0.2,
                       rate, seed, mean_expand=False,
                       mask_t=transpose_mask(mask))


def _tr_band(n, width, geometric, seed=0, tile=128):
    """bias_noself with geo planes (features of random positions) or the
    generic edge planes (random features); the last 37 rows are padding
    with no senders."""
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(n, 1)
    keep = (((j - i) < width) & (rng.random(i.size) < 0.05)) | ((j - i) == 1)
    s = np.concatenate([i[keep], j[keep]]).astype(np.int32)
    r = np.concatenate([j[keep], i[keep]]).astype(np.int32)
    real = np.arange(n) < n - 37
    keep = real[s] & real[r]
    s, r = s[keep], r[keep]
    pos = rng.random((n, 3)).astype(np.float32)
    feat = (compute_edge_features(pos.astype(np.float64), s, r) if geometric
            else rng.normal(size=(s.size, 4)).astype(np.float32))
    deg = np.bincount(r, minlength=n).astype(np.float32)
    band = build_band(s, r, n, real, deg, tile=tile,
                      components=("bias_noself", "geo", "edge"),
                      edge_feat=feat, node_pos=pos)
    assert (band.geo is not None) == geometric
    return band, ~real


def _check_s(band, s, s_ref, rel):
    """s by column group, each within ``rel`` of its own max: the geo
    form's direction columns (0-2 of each head) cancel terms of size
    max|pos|·max(1/dist) into values ≤ 1 and get 1e-6 of that size on top
    (f32 summation order); its dist column (3) and the edge form's columns
    do not cancel."""
    d, r = (s - s_ref).abs(), s_ref.abs()
    groups = [(d, r, 0.0)]
    if band.geo is not None:
        d, r = d.view(s.shape[0], -1, 4), r.view(s.shape[0], -1, 4)
        cancel = band.pos.abs().max().item() * band.geo[:, 1].max().item()
        groups = [(d[..., :3], r[..., :3], 1e-6 * cancel),
                  (d[..., 3], r[..., 3], 0.0)]
    for err, ref, extra in groups:
        err, tol = err.max().item(), rel * ref.max().item() + extra
        assert err <= tol, (err, tol)


# width 60 → Wcols 256, width 100 → Wcols 384
@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["plain", "edge", "geo"])
def test_transformer_kernel_matches_plain(card, form, dtype, width):
    n, heads, c = 512, 4, 64
    band, pad = _tr_band(n, width, geometric=form != "edge")
    band = band.to(card)
    gen = torch.Generator().manual_seed(9)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(n, heads * c, generator=gen).to(card, dt)
               for _ in range(3))
    extra = {}
    if form == "edge":
        extra = dict(edge=band.edge)
    elif form == "geo":
        extra = dict(geo=band.geo, pos=band.pos)
    if extra:
        extra["qw"] = torch.randn(n, heads * 4, generator=gen).to(card, dt)
    for mean in (False, True):
        _build.reset_launches()
        got = banded_transformer_fwd(band.bias_noself, q, k, v, heads,
                                     mean_heads=mean, **extra)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["banded_transformer_fwd"] == 1
        ref = banded_transformer_fwd_plain(band.bias_noself, q, k, v, heads,
                                           mean_heads=mean, **extra)
        got, ref = (got, ref) if extra else ((got,), (ref,))
        assert got[0].dtype == dt and got[0].shape == ref[0].shape
        # out: f32 summation order (and the geo logits' cancellation);
        # bf16 one rounding of the probability or the output may flip
        _close(got[0], ref[0], 1e-4 if dtype == "float32" else 1e-2)
        if extra:   # s: f32 from the same inputs in both dtypes
            _check_s(band, got[1], ref[1], 1e-4)
        for t in got:   # rows with no sender: exactly 0
            assert (t[torch.from_numpy(pad).to(card)] == 0).all()


@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_fused_kernel_matches_plain(card, dtype, width):
    n, heads, c, f = 512, 4, 64, 64
    band, pad = _tr_band(n, width, geometric=True, seed=1)
    band = band.to(card)
    gen = torch.Generator().manual_seed(10)
    dt = getattr(torch, dtype)
    x = torch.randn(n, f, generator=gen).to(card, dt)
    ws = [(torch.randn(f, heads * c, generator=gen) * f ** -0.5).to(card, dt)
          for _ in range(3)]
    bs = [(0.1 * torch.randn(heads * c, generator=gen)).to(card, dt)
          for _ in range(3)]
    w_e = torch.randn(4, heads, c, generator=gen) * 0.5
    wblk = (torch.eye(heads)[:, None, :, None] * w_e.permute(1, 2, 0)[:, :, None, :]
            ).reshape(heads * c, heads * 4).to(card, dt)
    args = (band.bias_noself, band.geo, band.pos, x, *ws, *bs, wblk, heads)
    _build.reset_launches()
    out, s = banded_transformer_geo_mean_fused(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_transformer_geo_mean_fused"] == 1
    ref, ref_s = banded_transformer_geo_mean_fused_plain(*args)
    assert out.dtype == dt and s.dtype == torch.float32
    # the projections: f32 in other orders; bf16 one rounding of q/k/v may
    # flip, and the attention follows
    _close(out, ref, 1e-4 if dtype == "float32" else 2e-2)
    _check_s(band, s, ref_s, 1e-4 if dtype == "float32" else 2e-2)
    padding = torch.from_numpy(pad).to(card)
    assert (out[padding] == 0).all() and (s[padding] == 0).all()


def test_transformer_kernels_reject_bad_input(card):
    band, _ = _tr_band(256, 60, geometric=True)
    band = band.to(card)
    q = torch.zeros(256, 128, device=card)
    with pytest.raises(TypeError):
        banded_transformer_fwd(band.bias_noself, q, q.bfloat16(), q, 2)
    with pytest.raises(ValueError):        # C 6 is not a multiple of 4
        banded_transformer_fwd(band.bias_noself, q[:, :12].contiguous(),
                               q[:, :12].contiguous(),
                               q[:, :12].contiguous(), 2)
    with pytest.raises(ValueError):
        banded_transformer_fwd(band.bias_noself.cpu(), q, q, q, 2)
    with pytest.raises(ValueError):        # qw of the wrong width
        banded_transformer_fwd(band.bias_noself, q, q, q, 2, geo=band.geo,
                               pos=band.pos, qw=torch.zeros(256, 4,
                                                            device=card))


@pytest.mark.parametrize("fuse_eval", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_predict_case_card_matches_cpu(card, tmp_path, dtype,
                                                   fuse_eval):
    info = generate_box_case(tmp_path / "case", 24, 14, 1)
    cfg = ModelConfig(hidden_dim=64, num_layers=2, layer_type="Transformer",
                      heads=2, backend="pallas", compute_dtype=dtype,
                      fuse_eval=fuse_eval)
    model = FlowGNN(cfg, generator=torch.Generator().manual_seed(2))
    save_checkpoint(tmp_path / "ckpt", "best", model.state_dict(),
                    model_config=cfg,
                    normalizer=FieldNormalizer().fit(
                        box_fields(info["cell_centers"])))
    for exact_bn in (False, True):
        _build.reset_launches()
        _, got, _ = predict_case(tmp_path / "ckpt", tmp_path / "case",
                                 exact_bn=exact_bn, device="cuda")
        # fuse_eval takes row 11 in eval only: exact_bn runs in train mode
        conv = ("banded_transformer_geo_mean_fused"
                if fuse_eval and not exact_bn else "banded_transformer_fwd")
        want_launch = {conv: 2}
        if exact_bn:
            want_launch["fused_epilogue_fwd"] = 4
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == want_launch
        _, ref, _ = predict_case(tmp_path / "ckpt", tmp_path / "case",
                                 exact_bn=exact_bn, device="cpu")
        tol = 1e-4 if dtype == "float32" else 5e-2
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=tol,
                                       atol=tol * np.abs(ref[k]).max())


def _tr_inputs(card, n, heads, c, dt, form, band, gen):
    q, k, v = (torch.randn(n, heads * c, generator=gen).to(card, dt)
               for _ in range(3))
    extra = {}
    if form == "edge":
        extra = dict(edge=band.edge)
    elif form == "geo":
        extra = dict(geo=band.geo, pos=band.pos)
    if extra:
        extra["qw"] = torch.randn(n, heads * 4, generator=gen).to(card, dt)
    return q, k, v, extra


# width 60 → Wcols 256, width 100 → Wcols 384
@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["plain", "edge", "geo"])
def test_transformer_kernel_dropout_matches_plain(card, form, dtype, width):
    """Row 9 at rate 0.1, head mean and concat: the same masks (the hash
    stream, one draw per head) on both sides."""
    n, heads, c = 512, 4, 64
    band, pad = _tr_band(n, width, geometric=form != "edge", seed=2)
    band = band.to(card)
    gen = torch.Generator().manual_seed(11)
    dt = getattr(torch, dtype)
    q, k, v, extra = _tr_inputs(card, n, heads, c, dt, form, band, gen)
    for mean in (False, True):
        args = (band.bias_noself, q, k, v, heads)
        kw = dict(mean_heads=mean, dropout_rate=0.1, seed=_seed(card), **extra)
        _build.reset_launches()
        got = banded_transformer_fwd(*args, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["banded_transformer_fwd"] == 1
        ref = banded_transformer_fwd_plain(*args, **kw)
        got, ref = (got, ref) if extra else ((got,), (ref,))
        _close(got[0], ref[0], 1e-4 if dtype == "float32" else 1e-2)
        if extra:
            _check_s(band, got[1], ref[1], 1e-4)


# the geo form (FlowGNN's) in every combination; the others at (rate 0, no
# gs) and (rate 0.1, gs)
_TR_BWD = ([("geo", m, r, g) for m in (True, False) for r in (0.0, 0.1)
            for g in (False, True)]
           + [("edge", m, r, r > 0) for m in (True, False) for r in (0.0, 0.1)]
           + [("plain", m, r, False) for m in (True, False)
              for r in (0.0, 0.1)])


@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form,mean,rate,with_gs", _TR_BWD)
def test_transformer_backward_kernel_matches_plain(card, form, mean, rate,
                                                   with_gs, dtype, width):
    """Row 10: dq and the dk/dv partials (f32 summation order; bf16 one
    rounding of dl, ẽ or an output may flip, KTOL) and dqw (f32 from the
    same inputs; by column group as s, the geo direction columns' terms
    cancel)."""
    n, heads, c = 512, 4, 64
    band, pad = _tr_band(n, width, geometric=form != "edge", seed=3)
    band = band.to(card)
    gen = torch.Generator().manual_seed(12)
    dt = getattr(torch, dtype)
    q, k, v, extra = _tr_inputs(card, n, heads, c, dt, form, band, gen)
    g = torch.randn(n, c if mean else heads * c, generator=gen).to(card, dt)
    if with_gs:
        extra["gs"] = torch.randn(n, heads * 4, generator=gen).to(card)
    args = (band.bias_noself, q, k, v, g, heads)
    kw = dict(mean_expand=mean, dropout_rate=rate,
              seed=_seed(card) if rate else None, **extra)
    _build.reset_launches()
    got = banded_transformer_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_transformer_bwd"] == 1
    ref = banded_transformer_bwd_plain(*args, **kw)
    assert len(got) == len(ref) == (3 if form == "plain" else 4)
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype == dt and a.shape == b.shape
        _close(a, b, KTOL[dtype])
    assert (got[0][torch.from_numpy(pad).to(card)] == 0).all()
    if form != "plain":
        assert got[3].dtype == torch.float32
        _check_s(band, got[3], ref[3], 1e-4 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("c", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["plain", "edge", "geo"])
def test_transformer_backward_empty_rows_and_columns(card, form, dtype, c):
    """Row 10 on the W 5 band (Wcols 384) at dropout 0.1, with C 64 and the
    flagship's 256 (two 128-column passes of the partials pass): a receiver
    row whose senders are all masked writes dq = dqw = 0, a window column
    with no receiver writes zero dk/dv partial rows, and the rest matches
    the plain version as in the test above."""
    n, heads = 512, 4
    band, _ = _tr_band(n, 100, geometric=form != "edge", seed=5)
    mask = band.bias_noself.clone()
    mask[0, 5] = 0           # row 5: no sender
    mask[1, :, 140] = 0      # tile 1, window column 140: no receiver
    band = dataclasses.replace(band, bias_noself=mask).to(card)
    gen = torch.Generator().manual_seed(18)
    dt = getattr(torch, dtype)
    q, k, v, extra = _tr_inputs(card, n, heads, c, dt, form, band, gen)
    g = torch.randn(n, c, generator=gen).to(card, dt)
    if form != "plain":
        extra["gs"] = torch.randn(n, heads * 4, generator=gen).to(card)
    args = (band.bias_noself, q, k, v, g, heads)
    kw = dict(mean_expand=True, dropout_rate=0.1, seed=_seed(card), **extra)
    got = banded_transformer_bwd(*args, **kw)
    ref = banded_transformer_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], ref[:3]):
        _close(a, b, KTOL[dtype])
    assert (got[0][5] == 0).all()
    sub = band.bias_noself.shape[1] // 2
    for part in got[1:3]:
        assert (part[1, 140 // sub, 140 % sub] == 0).all()
    if form != "plain":
        assert (got[3][5] == 0).all()
        _check_s(band, got[3], ref[3], 1e-4 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("window", [(6, 64), (10, 64), (4, 64), (3, 128)])
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("bfloat16", "float32")])
def test_fold_partials_kernel_matches_plain(card, window, dtypes):
    """Row 7: the same f32 sums in the same order, rounded once: equal in
    f32 and within one rounding (2^-8) in bf16; into a column block of a
    wider buffer too."""
    w_sub, sub = window
    n_tiles, tile, feat = 7, 128, 96
    gen = torch.Generator().manual_seed(13)
    part = torch.randn(n_tiles, w_sub, sub, feat, generator=gen).to(
        card, getattr(torch, dtypes[0]))
    out_dt = getattr(torch, dtypes[1])
    _build.reset_launches()
    got = fold_partials(part, tile, out=torch.empty(
        n_tiles * tile, feat, dtype=out_dt, device=card))
    wide = torch.zeros(n_tiles * tile, 3 * feat, dtype=out_dt, device=card)
    fold_partials(part, tile, out=wide[:, feat:2 * feat])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fold_partials"] == 2
    ref = fold_partials_plain(part, tile, out=torch.empty_like(got))
    assert got.dtype == out_dt
    _close(got, ref, 0.0 if out_dt == torch.float32 else 2.0 ** -8)
    torch.testing.assert_close(wide[:, feat:2 * feat], got, rtol=0, atol=0)
    assert (wide[:, :feat] == 0).all() and (wide[:, 2 * feat:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_project_bias_form_matches_plain(card, dtype):
    """Row 6's bias form: db = Σ_rows dz summed from the dz tiles the dW
    product stages (f32 summation order), dx and dW as before; x as a
    column block of a wider buffer (its row stride)."""
    n, f, hc = 1000, 64, 192
    gen = torch.Generator().manual_seed(14)
    dt = getattr(torch, dtype)
    dz = torch.randn(n, hc, generator=gen).to(card, dt)
    wide = torch.randn(n, 3 * f, generator=gen).to(card, dt)
    x = wide[:, f:2 * f]
    w = (torch.randn(f, hc, generator=gen) * f ** -0.5).to(card, dt)
    _build.reset_launches()
    dx, dw, db = fold_project_bwd(dz, x, w, with_bias=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fold_project_bwd"] == 1
    ref = fold_project_bwd_plain(dz, x, w, with_bias=True)
    assert dx.dtype == dt and dw.dtype == db.dtype == torch.float32
    assert dw.shape == (f, hc) and db.shape == (hc,)
    _close(dx, ref[0], KTOL[dtype])
    _close(dw, ref[1], 1e-4 if dtype == "float32" else 1e-3)
    _close(db, ref[2], 1e-5)


# row 6 at the main path's three shapes (n, F, H·C, bias, x's row stride):
# the GAT form, the Transformer's wblk form (dqw [N, H·4] against q read
# from its q|k|v buffer) and the bias form; N ragged (not a multiple of
# 128), small (one dW chunk) and at the flagship's 12,032 rows
_ROW6 = [(1000, 256, 1024, False, 256), (1000, 1024, 16, False, 3072),
         (1000, 256, 3072, True, 256), (12032, 256, 1024, False, 256),
         (12032, 1024, 16, False, 3072), (200, 64, 192, True, 192),
         (300, 128, 8, False, 384)]


@pytest.mark.parametrize("n,f,hc,bias,ldx", _ROW6)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_project_shapes_match_plain(card, n, f, hc, bias, ldx, dtype):
    """Row 6 (one persistent launch, dW folded from K-chunk slices) against
    its plain version at dz widths 16, 1,024 and 3,072, x a row-strided
    column block where ldx > F, ragged N: dx within KTOL (f32 summation
    order; bf16 one rounding), dW and db within f32 summation order (bf16
    operands are exact in the f32 products)."""
    gen = torch.Generator().manual_seed(17)
    dt = getattr(torch, dtype)
    dz = torch.randn(n, hc, generator=gen).to(card, dt)
    wide = torch.randn(n, ldx, generator=gen).to(card, dt)
    x = wide[:, ldx - f:] if ldx > f else wide
    w = (torch.randn(f, hc, generator=gen) * f ** -0.5).to(card, dt)
    _build.reset_launches()
    got = fold_project_bwd(dz, x, w, with_bias=bias)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fold_project_bwd"] == 1
    ref = fold_project_bwd_plain(dz, x, w, with_bias=bias)
    assert got[0].dtype == dt and got[1].dtype == torch.float32
    assert got[1].shape == (f, hc)
    _close(got[0], ref[0], KTOL[dtype])
    _close(got[1], ref[1], 1e-4 if dtype == "float32" else 1e-3)
    if bias:
        _close(got[2], ref[2], 1e-5)
    # deterministic: a second call gives the same bits
    again = fold_project_bwd(dz, x, w, with_bias=bias)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_projgrad_op_matches_plain(card, dtype, rate):
    """The projgrad op (rows 9, 10, 7, 6 and the projection) on the card
    against the same op through the plain versions on the CPU: out, s and
    every cotangent (f32 summation order; bf16 KTOL of each one's max, or
    of the largest cotangent for dbk, zero in exact arithmetic)."""
    n, heads, c, f = 512, 4, 64, 64
    band, _ = _tr_band(n, 60, geometric=True, seed=4)
    gen = torch.Generator().manual_seed(15)
    dt = getattr(torch, dtype)
    x = torch.randn(n, f, generator=gen)
    ws = [torch.randn(f, heads * c, generator=gen) * f ** -0.5
          for _ in range(3)]
    bs = [0.1 * torch.randn(heads * c, generator=gen) for _ in range(3)]
    w_e = torch.randn(4, heads, c, generator=gen) * 0.5
    wblk = (torch.eye(heads)[:, None, :, None]
            * w_e.permute(1, 2, 0)[:, :, None, :]).reshape(heads * c, heads * 4)
    g = torch.randn(n, c, generator=gen)
    gs = torch.randn(n, heads * 4, generator=gen)
    results = []
    for dev in ("cpu", card):
        b = band.to(dev)
        leaves = [t.to(dev, dt).detach().clone().requires_grad_()
                  for t in (x, *ws, *bs, wblk)]
        seed = torch.tensor([77], dtype=torch.int32, device=dev) if rate \
            else None
        _build.reset_launches()
        out, s = banded_transformer_geo_mean_projgrad(
            b.bias_noself, b.geo, b.pos, *leaves, heads, rate, seed)
        torch.autograd.backward((out, s), (g.to(dev, dt), gs.to(dev)))
        torch.cuda.synchronize()
        results.append(([out, s], [t.grad for t in leaves],
                        dict(_build.LAUNCHES)))
    (fwd_cpu, g_cpu, l_cpu), (fwd_card, g_card, l_card) = results
    assert not any(l_cpu.values())
    assert {k: v for k, v in l_card.items() if v} == {
        "transformer_project": 1, "banded_transformer_fwd": 1,
        "banded_transformer_bwd": 1, "fold_partials": 2,
        "fold_project_bwd": 2}
    tol = KTOL[dtype]
    _close(fwd_card[0], fwd_cpu[0], tol)
    top = max(t.float().abs().max().item() for t in g_cpu)
    names = ("dx", "dwq", "dwk", "dwv", "dbq", "dbk", "dbv", "dwblk")
    for name, a, b in zip(names, g_card, g_cpu):
        assert a.dtype == b.dtype == dt, name
        _close(a, b, tol, floor=top if name == "dbk" else 1e-30)


def test_transformer_project_matches_plain(card):
    """qkv = x·[Wq | Wk | Wv] + [bq | bk | bv] with the bias added in f32
    before the one rounding, qw = q·wblk over wblk's diagonal head blocks
    rounded once (a full random wblk: kernel and plain version read the
    same blocks): bf16 one rounding may flip (2^-8)."""
    n, f, hc, heads = 500, 64, 256, 4
    gen = torch.Generator().manual_seed(16)
    x = torch.randn(n, f, generator=gen).to(card, torch.bfloat16)
    ws = [(torch.randn(f, hc, generator=gen) * f ** -0.5).to(
        card, torch.bfloat16) for _ in range(3)]
    bs = [(0.1 * torch.randn(hc, generator=gen)).to(card, torch.bfloat16)
          for _ in range(3)]
    wblk = torch.randn(hc, 4 * heads, generator=gen).to(card, torch.bfloat16)
    qkv, qw = transformer_project(x, *ws, *bs, wblk)
    ref_qkv, ref_qw = transformer_project_plain(x, *ws, *bs, wblk)
    torch.cuda.synchronize()
    _close(qkv, ref_qkv, 2.0 ** -7)
    # qw from the kernel's own q (a q rounding may flip on either side)
    _close(qw, _qw_plain(qkv[:, :hc], wblk, heads).to(torch.bfloat16),
           2.0 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_off_diagonal_wblk_is_not_read(card, dtype):
    """transformer_project and row 11 read only wblk's diagonal head
    blocks, as their plain versions do: a wblk with random off-diagonal
    blocks gives the same bits as the same wblk with them zeroed, and
    agrees with the plain versions (f32 1e-5 / 1e-4; bf16 one rounding)."""
    n, heads, c, f = 512, 4, 64, 64
    hc = heads * c
    band, _ = _tr_band(n, 60, geometric=True, seed=1)
    band = band.to(card)
    gen = torch.Generator().manual_seed(18)
    dt = getattr(torch, dtype)
    x = torch.randn(n, f, generator=gen).to(card, dt)
    ws = [(torch.randn(f, hc, generator=gen) * f ** -0.5).to(card, dt)
          for _ in range(3)]
    bs = [(0.1 * torch.randn(hc, generator=gen)).to(card, dt)
          for _ in range(3)]
    wblk = (0.5 * torch.randn(hc, 4 * heads, generator=gen)).to(card, dt)
    diag = (torch.eye(heads)[:, None, :, None]
            * torch.ones(1, c, 1, 4)).reshape(hc, 4 * heads).to(card, dt)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    qkv, qw = transformer_project(x, *ws, *bs, wblk)
    qkv0, qw0 = transformer_project(x, *ws, *bs, wblk * diag)
    torch.cuda.synchronize()
    assert torch.equal(qkv, qkv0) and torch.equal(qw, qw0)
    _close(qw, transformer_project_plain(x, *ws, *bs, wblk)[1], tol)
    args = (band.bias_noself, band.geo, band.pos, x, *ws, *bs)
    out, s = banded_transformer_geo_mean_fused(*args, wblk, heads)
    out0, s0 = banded_transformer_geo_mean_fused(*args, wblk * diag, heads)
    torch.cuda.synchronize()
    assert torch.equal(out, out0) and torch.equal(s, s0)
    ref, ref_s = banded_transformer_geo_mean_fused_plain(*args, wblk, heads)
    _close(out, ref, 1e-4 if dtype == "float32" else 2e-2)
    _check_s(band, s, ref_s, 1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("n,heads,c,f", [
    (500, 4, 64, 64),      # H·C 256: four heads a tile (the qw epilogue)
    (1000, 4, 256, 256),   # H·C 1,024, the flagship widths: a head a tile
    (777, 4, 256, 200),    # ragged N, F not a multiple of the K step
    (300, 2, 128, 64),     # two heads a tile
    (400, 4, 24, 32),      # C does not divide the tile: qw_kernel
    (2048, 4, 256, 256),   # more tiles than SMs: blocks loop
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_project_shapes(card, dtype, n, heads, c, f):
    """The projection on gemm_sm90.cuh (bf16: qw in the q tiles' epilogue
    where C divides 256, else qw_kernel; f32: the SIMT tiles and qw_kernel)
    against the plain version: f32 summation order (1e-5); bf16 one
    rounding (2^-7 of each output's max), qw from the kernel's own q; two
    calls give the same bits."""
    hc = heads * c
    gen = torch.Generator().manual_seed(17)
    dt = getattr(torch, dtype)
    x = torch.randn(n, f, generator=gen).to(card, dt)
    ws = [(torch.randn(f, hc, generator=gen) * f ** -0.5).to(card, dt)
          for _ in range(3)]
    bs = [(0.1 * torch.randn(hc, generator=gen)).to(card, dt)
          for _ in range(3)]
    w_e = torch.randn(4, heads, c, generator=gen) * 0.5
    wblk = (torch.eye(heads)[:, None, :, None]
            * w_e.permute(1, 2, 0)[:, :, None, :]).reshape(hc, heads * 4)
    wblk = wblk.to(card, dt)
    _build.reset_launches()
    qkv, qw = transformer_project(x, *ws, *bs, wblk)
    qkv2, qw2 = transformer_project(x, *ws, *bs, wblk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["transformer_project"] == 2
    assert torch.equal(qkv, qkv2) and torch.equal(qw, qw2)
    ref_qkv, _ = transformer_project_plain(x, *ws, *bs, wblk)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    _close(qkv, ref_qkv, tol)
    _close(qw, (qkv[:, :hc].float() @ wblk.float()).to(dt), tol)


@pytest.mark.parametrize("edge,dtype", [
    (True, "float32"), (True, "bfloat16"), (True, "mixed"),
    (False, "float32"), (False, "bfloat16")])
def test_transformer_train_step_card_matches_cpu(card, tmp_path, edge,
                                                 dtype):
    """One Transformer train step on the card vs the CPU (the plain
    versions), as the other convs' (its zero-gradient biases, noise on both
    sides, within one bf16 rounding, 2^-8, of the largest group's norm, as
    chip_smoke.py holds them); the launches are the training path's:
    per layer the projection, rows 9, 10, two row-7 folds and two row-6
    launches on the geo path; rows 9, 10 and two folds without edges."""
    _build.reset_launches()
    _train_step_card_vs_cpu(card, tmp_path, ModelConfig(
        hidden_dim=64, num_layers=2, layer_type="Transformer", heads=2,
        backend="pallas", compute_dtype=dtype, dropout=0.0,
        use_edge_attr=edge), zero_grad=_TR_FEEDS_BN, zero_tol=2.0 ** -8)
    want = {"banded_transformer_fwd": 2, "banded_transformer_bwd": 2,
            "fold_partials": 4, "fused_epilogue_fwd": 4,
            "fused_epilogue_bwd": 4}
    if edge:
        want.update(transformer_project=2, fold_project_bwd=4)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == want


# ------------------------------------------ rows 5 and 11 as redesigned
@pytest.mark.parametrize("heads,c", [(4, 256), (2, 64), (8, 32), (3, 304),
                                    (6, 20)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("mean", [True, False], ids=["mean", "per_head"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_bwd_passes_match_plain(card, dtype, mean, width, rate, heads, c):
    """Row 5's receiver pass (the planes of round(ẽ) and round(dpre)) and
    sender pass (their sums, no recompute) against the plain version at
    C 256 (one 16-byte chunk per lane and head row in bf16, two in f32),
    C 64 and 32 (lanes past C idle), C 304 (two column blocks, the second
    partial) and 20 (8-byte chunks in bf16), heads 2, 3, 4, 6, 8 (head
    groups of 4, the last partial); the same bits call after call."""
    n = 640
    gen = torch.Generator().manual_seed(11)
    dt = getattr(torch, dtype)
    z = (0.5 * torch.randn(n, heads * c, generator=gen)).to(card, dt)
    alphas = torch.randn(n, 2 * heads, generator=gen).to(card)
    g = torch.randn(n, c if mean else heads * c, generator=gen).to(card, dt)
    mask = _band(n, width).to(card)
    seed = _seed(card) if rate else None
    args = (mask, z, alphas, g, heads, 0.2, rate, seed)
    _build.reset_launches()
    dz, da = banded_gat_bwd(*args, mean_expand=mean,
                            mask_t=transpose_mask(mask))
    dz2, da2 = banded_gat_bwd(*args, mean_expand=mean,
                              mask_t=transpose_mask(mask))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_gat_bwd"] == 2
    assert torch.equal(dz, dz2) and torch.equal(da, da2)
    ref_dz, ref_da = banded_gat_bwd_plain(*args, mean_expand=mean)
    assert dz.dtype == dt and da.dtype == torch.float32
    _close(dz, ref_dz, KTOL[dtype])
    _close(da, ref_da, 1e-4 if dtype == "float32" else 1e-2)


def test_gat_bwd_rejects_what_the_passes_do_not_take(card):
    n, c = 256, 64
    mask = _band(n, 60).to(card)
    g = torch.zeros(n, c, device=card)
    z = torch.zeros(n, 4 * 6, device=card)
    with pytest.raises(ValueError, match="multiple of 4"):
        banded_gat_bwd(mask, z, torch.zeros(n, 8, device=card),
                       torch.zeros(n, 6, device=card), 4,
                       mask_t=transpose_mask(mask))
    z = torch.zeros(n, 4 * c, device=card)
    with pytest.raises(ValueError, match="shape"):
        banded_gat_bwd(mask, z, torch.zeros(n, 8, device=card), g, 4,
                       mask_t=mask)


@pytest.mark.parametrize("n,heads,c,f,tile,width", [
    (512, 4, 256, 256, 128, 60),   # the flagship widths: a tile is one head
    (400, 4, 256, 200, 16, 20),    # ragged N, F not a multiple of the K step
    (512, 2, 64, 64, 128, 60),     # H·C 128: one tile, half past the weight
    (2048, 4, 256, 256, 128, 60),  # 192 tiles on 132 SMs: blocks loop
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_fused_projection_shapes(card, dtype, n, heads, c, f,
                                             tile, width):
    """Row 11 with its projection on gemm_sm90.cuh (bf16: wgmma fed by TMA
    from the three weights; f32: its SIMT tiles) against the plain version
    at the tolerances of ``test_transformer_fused_kernel_matches_plain``."""
    band, pad = _tr_band(n, width, geometric=True, seed=2, tile=tile)
    band = band.to(card)
    gen = torch.Generator().manual_seed(12)
    dt = getattr(torch, dtype)
    x = torch.randn(n, f, generator=gen).to(card, dt)
    ws = [(torch.randn(f, heads * c, generator=gen) * f ** -0.5).to(card, dt)
          for _ in range(3)]
    bs = [(0.1 * torch.randn(heads * c, generator=gen)).to(card, dt)
          for _ in range(3)]
    w_e = torch.randn(4, heads, c, generator=gen) * 0.5
    wblk = (torch.eye(heads)[:, None, :, None] * w_e.permute(1, 2, 0)[:, :, None, :]
            ).reshape(heads * c, heads * 4).to(card, dt)
    args = (band.bias_noself, band.geo, band.pos, x, *ws, *bs, wblk, heads)
    _build.reset_launches()
    out, s = banded_transformer_geo_mean_fused(*args)
    out2, s2 = banded_transformer_geo_mean_fused(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_transformer_geo_mean_fused"] == 2
    assert torch.equal(out, out2) and torch.equal(s, s2)
    ref, ref_s = banded_transformer_geo_mean_fused_plain(*args)
    _close(out, ref, 1e-4 if dtype == "float32" else 2e-2)
    _check_s(band, s, ref_s, 1e-4 if dtype == "float32" else 2e-2)
    padding = torch.from_numpy(pad).to(card)
    assert (out[padding] == 0).all() and (s[padding] == 0).all()


# ------------------------------------------ rows 9 and 1 as redesigned
def _dense_rows(mask, rows):
    """``mask`` with every in-range window column of ``rows`` on: more
    senders than one batch of the kernels (and than 32 lanes)."""
    mask = mask.clone()
    n_tiles, tile, width = mask.shape
    for i in rows:
        t = i // tile
        s = t * tile - (width - tile) // 2 + torch.arange(width)
        mask[t, i % tile] = ((s >= 0) & (s < n_tiles * tile)).to(mask.dtype)
    return mask


# the first rows of the first tile, one inside, the last of the last tile
_DENSE = (0, 1, 5, 200, 511)


@pytest.mark.parametrize("width", [60, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_dense_rows_match_plain(card, dtype, width):
    """Rows 1 and 4 (head mean and concat, rate 0 and 0.1) on a mask with
    some rows fully on: 256 or 384 senders, many batches and their tail."""
    n, heads, c, f = 512, 4, 64, 64
    gen = torch.Generator().manual_seed(13)
    dt = getattr(torch, dtype)
    x = torch.randn(n, f, generator=gen).to(card, dt)
    w = (torch.randn(f, heads * c, generator=gen) * f ** -0.5).to(card, dt)
    alphas = torch.randn(n, 2 * heads, generator=gen).to(card)
    mask = _dense_rows(_band(n, width).to(card), _DENSE)
    for rate in (0.0, 0.1):
        seed = _seed(card) if rate else None
        args = (mask, w, alphas, x, heads, 0.2, rate, seed)
        out, z = banded_gat_mean_fused(*args, emit_z=True)
        ref, ref_z = banded_gat_mean_fused_plain(*args, emit_z=True)
        _close(z, ref_z, 1e-6 if dtype == "float32" else 1e-2)
        _close(out, ref, KTOL[dtype])
        for fn, plain in ((banded_gat_mean, banded_gat_mean_plain),
                          (banded_gat, banded_gat_plain)):
            a4 = (mask, ref_z, alphas, heads, 0.2, rate, seed)
            _close(fn(*a4), plain(*a4), KTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["plain", "edge", "geo"])
def test_transformer_dense_rows_match_plain(card, form, dtype):
    """Row 9 in every form, head mean and concat, rate 0 and 0.1, on a mask
    with some rows fully on (the staged conditioning is 0 where the band
    has no edge, as in the plain version)."""
    n, heads, c = 512, 4, 64
    band, pad = _tr_band(n, 60, geometric=form != "edge", seed=3)
    band = dataclasses.replace(band, bias_noself=_dense_rows(
        band.bias_noself, (0, 1, 5, 200, 300))).to(card)
    gen = torch.Generator().manual_seed(14)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(n, heads * c, generator=gen).to(card, dt)
               for _ in range(3))
    extra = {}
    if form == "edge":
        extra = dict(edge=band.edge)
    elif form == "geo":
        extra = dict(geo=band.geo, pos=band.pos)
    if extra:
        extra["qw"] = torch.randn(n, heads * 4, generator=gen).to(card, dt)
    for mean in (False, True):
        for rate in (0.0, 0.1):
            kw = dict(extra, mean_heads=mean, dropout_rate=rate,
                      seed=_seed(card) if rate else None)
            got = banded_transformer_fwd(band.bias_noself, q, k, v, heads, **kw)
            ref = banded_transformer_fwd_plain(band.bias_noself, q, k, v,
                                               heads, **kw)
            got, ref = (got, ref) if extra else ((got,), (ref,))
            _close(got[0], ref[0], 1e-4 if dtype == "float32" else 1e-2)
            if extra:
                _check_s(band, got[1], ref[1], 1e-4)


@pytest.mark.parametrize("heads", [1, 2, 4, 8])
@pytest.mark.parametrize("c", [16, 64, 256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_kernel_heads_and_widths(card, dtype, c, heads):
    """Row 9's geo form, head mean and concat, at dropout 0.1, at C 16 (8
    columns a lane: half the lanes idle in bf16), 64, 256 (one column
    block) and 512 (two) and H 1, 2, 4 (one full group), 8 (two)."""
    n = 384
    band, pad = _tr_band(n, 60, geometric=True, seed=4)
    band = band.to(card)
    gen = torch.Generator().manual_seed(15)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(n, heads * c, generator=gen).to(card, dt)
               for _ in range(3))
    qw = torch.randn(n, heads * 4, generator=gen).to(card, dt)
    for mean in (False, True):
        kw = dict(geo=band.geo, pos=band.pos, qw=qw, mean_heads=mean,
                  dropout_rate=0.1, seed=_seed(card))
        _build.reset_launches()
        got = banded_transformer_fwd(band.bias_noself, q, k, v, heads, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["banded_transformer_fwd"] == 1
        ref = banded_transformer_fwd_plain(band.bias_noself, q, k, v, heads,
                                           **kw)
        assert got[0].shape == ref[0].shape and got[0].dtype == dt
        _close(got[0], ref[0], 1e-4 if dtype == "float32" else 1e-2)
        _check_s(band, got[1], ref[1], 1e-4)
        padding = torch.from_numpy(pad).to(card)
        assert (got[0][padding] == 0).all() and (got[1][padding] == 0).all()


@pytest.mark.parametrize("n,tile,heads,c,f", [
    (400, 16, 4, 256, 256),   # ragged N (not a multiple of 128), H·C 1,024
    (400, 16, 2, 32, 64),     # ragged N, H·C 64: one tile, 3/4 past z
    (8192, 128, 4, 256, 256),  # 256 tiles on 132 SMs: blocks loop
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_one_weight_projection_shapes(card, dtype, n, tile, heads, c, f):
    """Row 1's z = x·W on gemm_sm90.cuh with one weight and no bias (bf16:
    wgmma fed by TMA; f32: its SIMT tiles): z and out against the plain
    version at ragged N and H·C 64, and with more tiles than SMs; the same
    bits call after call."""
    gen = torch.Generator().manual_seed(16)
    dt = getattr(torch, dtype)
    x = torch.randn(n, f, generator=gen).to(card, dt)
    w = (torch.randn(f, heads * c, generator=gen) * f ** -0.5).to(card, dt)
    alphas = torch.randn(n, 2 * heads, generator=gen).to(card)
    mask = _band(n, 12 if tile == 16 else 60, tile=tile).to(card)
    args = (mask, w, alphas, x, heads, 0.2, 0.1, _seed(card))
    _build.reset_launches()
    out, z = banded_gat_mean_fused(*args, emit_z=True)
    out2, z2 = banded_gat_mean_fused(*args, emit_z=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_gat_mean_fused"] == 2
    assert torch.equal(out, out2) and torch.equal(z, z2)
    ref, ref_z = banded_gat_mean_fused_plain(*args, emit_z=True)
    assert z.shape == (n, heads * c) and out.shape == (n, c)
    _close(z, ref_z, 1e-6 if dtype == "float32" else 1e-2)
    _close(out, ref, KTOL[dtype])


# ------------------------------------------------ CUDA graphs of the steps
def _train_case(tmp_path, layer):
    from gnn_bfs_rans_tpu_torch.foam import drifting_box_fields
    from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
    from gnn_bfs_rans_tpu_torch.train.data import load_dataset

    times = ("100", "200", "282")
    generate_box_case(tmp_path / "case", 24, 14, 1, time_dirs=times,
                      time_field_fn=drifting_box_fields)
    return load_dataset(tmp_path / "case", list(times), with_band=True,
                        band_components=LAYER_COMPONENTS[layer])


GRAPH_CFGS = {
    "gat-bf16": dict(hidden_dim=64, num_layers=4, layer_type="GAT", heads=4,
                     compute_dtype="bfloat16"),
    "gcn-f32": dict(hidden_dim=64, num_layers=2, layer_type="GCN",
                    compute_dtype="float32"),
}


def _trainer(card, tmp_path, name, dropout=0.0, device=None, **tcfg):
    from gnn_bfs_rans_tpu_torch.train.trainer import Trainer

    ds = _train_case(tmp_path, GRAPH_CFGS[name]["layer_type"])
    cfg = ModelConfig(**GRAPH_CFGS[name], backend="pallas", dropout=dropout)
    return Trainer(ds, cfg, TrainConfig(**{"lr": 1e-3, **tcfg}),
                   output_dir=tmp_path / f"run_{name}_{len(tcfg)}",
                   log_fn=lambda *_: None, device=device or card)


def _snapshot(tr):
    """Parameters, buffers, Adam's state and the generator's state."""
    return ({k: v.clone() for k, v in tr.model.state_dict().items()},
            {p: {k: v.clone() for k, v in st.items()}
             for p, st in tr.optimizer.state.items()},
            tr.generator.get_state())


def _restore(tr, snap):
    """Back to ``snap`` in place: the captured graphs keep their tensors."""
    model, opt, gen = snap
    tr.model.load_state_dict(model)
    for p, st in opt.items():
        for k, v in st.items():
            tr.optimizer.state[p][k].copy_(v)
    tr.generator.set_state(gen)


def _replays_and_eager(tr, k, freeze=False):
    """From one state: k replays of the step graph, then k eager steps:
    (losses, parameters, launch counts) of each."""
    idx = torch.arange(tr.dataset.n_snapshots, device=tr.device)
    step = tr._step(freeze, idx.numel())
    step(idx, 1e-3)                     # warm-up
    step(idx, 1e-3)                     # capture and replay
    snap = _snapshot(tr)
    runs = []
    for replay in (True, False):
        _restore(tr, snap)
        _build.reset_launches()
        losses = [(step(idx, 1e-3) if replay else train_step(
            tr.model, tr.optimizer, tr.graph, tr.targets[idx], 1e-3,
            tr.config, tr.generator, freeze_pressure=freeze)).clone()
            for _ in range(k)]
        torch.cuda.synchronize()
        runs.append((torch.stack(losses).cpu(),
                     {n: p.detach().clone() for n, p in
                      tr.model.named_parameters()},
                     {n: c for n, c in _build.LAUNCHES.items() if c}))
    return runs


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("name", ["gat-bf16", "gcn-f32"])
def test_step_graph_replays_equal_eager_steps(card, tmp_path, name, dropout):
    """K replays of the captured train step and K eager steps from the same
    parameters, Adam state and generator state: the same losses and
    parameters bit for bit (the same kernels on the same inputs; dropout
    0.1: the replays draw the eager stream's seeds and masks, so the
    generator is registered with the graph), and the replays' launch
    counts equal the eager steps'."""
    tr = _trainer(card, tmp_path, name, dropout=dropout)
    (l_r, p_r, n_r), (l_e, p_e, n_e) = _replays_and_eager(tr, 3)
    assert torch.equal(l_r, l_e), (l_r, l_e)
    for k in p_e:
        assert torch.equal(p_r[k], p_e[k]), k
    assert n_r == n_e and n_r
    assert len(set(l_r.tolist())) == 3     # the parameters moved each step


@pytest.mark.parametrize("name", ["gat-bf16", "gcn-f32"])
def test_step_graph_draws_fresh_masks(card, tmp_path, name):
    """At dropout 0.1, two replays from the same parameters and Adam state
    but the generator left where the first one took it give different
    losses: each replay draws fresh seeds and masks."""
    tr = _trainer(card, tmp_path, name, dropout=0.1)
    idx = torch.arange(tr.dataset.n_snapshots, device=card)
    step = tr._step(False, idx.numel())
    step(idx, 1e-3)
    step(idx, 1e-3)
    model, opt, _ = _snapshot(tr)
    losses = []
    for _ in range(2):
        _restore(tr, (model, opt, tr.generator.get_state()))
        losses.append(step(idx, 1e-3).item())
    assert losses[0] != losses[1]


def test_freeze_graph_keeps_the_pressure_column(card, tmp_path):
    """The freeze graph (captured with the pressure freeze, a static part
    of the graph as JAX's ``freeze``) leaves ``out_3``'s pressure row and
    bias unmoved over its replays and moves the other rows."""
    tr = _trainer(card, tmp_path, "gcn-f32")
    w, b = tr.model.out_3.weight, tr.model.out_3.bias
    before = w.detach().clone(), b.detach().clone()
    idx = torch.arange(tr.dataset.n_snapshots, device=card)
    step = tr._step(True, idx.numel())
    for _ in range(4):
        step(idx, 1e-3)
    torch.cuda.synchronize()
    assert torch.equal(w[3], before[0][3]) and b[3] == before[1][3]
    assert not torch.equal(w[0], before[0][0])


def test_epoch_block_graph_equals_eager_block(card, tmp_path):
    """``train --epoch_block 3`` on the card (the epoch body replayed as a
    CUDA graph) against the same three epochs of ``epoch_body`` run
    eagerly on the card from the same seeds: batch 1 (a permutation drawn
    on the device each epoch), dropout 0.1, bf16 (exact-BN eval): the same
    outputs and parameters bit for bit."""
    from gnn_bfs_rans_tpu_torch.train.loop import (epoch_body,
                                                   init_epoch_block_carry)

    kw = dict(dropout=0.1, epochs=3, epoch_block=3, save_every=3)
    tr = _trainer(card, tmp_path, "gat-bf16", **kw)
    tr.train()
    ref = _trainer(card, tmp_path / "eager", "gat-bf16", **kw)
    carry = init_epoch_block_carry(ref.model, ref.scheduler.lr, 3)
    for _ in range(3):
        epoch_body(ref.model, ref.optimizer, ref.graph, ref.targets, carry,
                   ref.config, 3, ref.generator, recal=ref.bn_recal)
    assert ref.bn_recal and torch.equal(tr.carry.outs, carry.outs)
    for (k, p), q in zip(tr.model.named_parameters(),
                         ref.model.parameters()):
        assert torch.equal(p, q), k
    assert torch.equal(tr.carry.best_epoch, carry.best_epoch)
    assert tr.history["epoch"] == [1, 2, 3]


def test_predictor_replays_equal_eager(card, tmp_path):
    """``Predictor.predict_packed``: the first call eager, the later ones
    replays of its CUDA graph, all equal to the model's eager forward
    (GAT bf16, ``exact_bn`` off and on); after ``recalibrate_bn`` (in
    place) the replay equals the eager forward of the new statistics."""
    from gnn_bfs_rans_tpu_torch.infer import Predictor

    graph = _train_case(tmp_path, "GAT").graph
    cfg = ModelConfig(**GRAPH_CFGS["gat-bf16"], backend="pallas")
    # running statistics at their initial values: recalibration moves them
    save_checkpoint(tmp_path / "ckpt", "best", FlowGNN(
        cfg, generator=torch.Generator().manual_seed(3)).state_dict(),
        model_config=cfg, normalizer=None)
    for exact_bn in (False, True):
        pred = Predictor.from_checkpoint(tmp_path / "ckpt",
                                         exact_bn=exact_bn)
        dev_graph = graph.to(card)

        def eager():
            with torch.inference_mode():
                out = pred.model(dev_graph, exact_bn=exact_bn)
            return out.float().cpu().numpy()[: graph.n_nodes]

        want = eager()
        _build.reset_launches()
        outs = [pred.predict_packed(graph) for _ in range(3)]
        assert _build.LAUNCHES["banded_gat_mean_fused"] == 3 * 4
        perm = graph.perm.numpy()[: graph.n_nodes]
        for out in outs:
            np.testing.assert_array_equal(out[perm], want)
        if not exact_bn:
            pred.recalibrate_bn(graph)
            np.testing.assert_array_equal(pred.predict_packed(graph)[perm],
                                          eager())
            assert not np.array_equal(eager(), want)


def test_resume_across_capturable_optimizer_state(card, tmp_path):
    """A CPU checkpoint (Adam's state not capturable, a float lr) resumes on
    the card, where Adam is capturable with its lr a device tensor, and
    the card's checkpoint resumes on the CPU."""
    tr = _trainer(card, tmp_path, "gcn-f32", device="cpu", epochs=1,
                  save_every=1)
    tr.train()
    for device, epochs in ((card, 2), ("cpu", 3)):
        tr = _trainer(card, tmp_path, "gcn-f32", device=device,
                      epochs=epochs, save_every=1)
        tr.initialize(resume=True)
        group = tr.optimizer.param_groups[0]
        on_card = torch.device(device).type == "cuda"
        assert group["capturable"] is on_card
        assert bool(group["fused"]) is on_card
        assert isinstance(group["lr"], torch.Tensor) is on_card
        steps = [st["step"] for st in tr.optimizer.state.values()]
        assert steps and all(s.device.type == torch.device(device).type
                             for s in steps)
        hist = tr.train()
        assert hist["epoch"] == list(range(1, epochs + 1))
        assert np.isfinite(hist["train_loss"]).all()


# ------------------------------------------------------------ bench harness
def test_roofline_finds_the_cards_peaks(card):
    """utils/roofline.py knows the card it runs on: MFU and the roofline
    guard are live there."""
    from gnn_bfs_rans_tpu_torch.utils import roofline

    peak = roofline.device_peak(card)
    assert peak.kind == torch.cuda.get_device_name(card).lower()
    assert peak.flops is not None and peak.hbm is not None
    with pytest.raises(RuntimeError, match="roofline violation"):
        roofline.check_roofline(2 * peak.flops * 1e-3, 1e-3, device=card)


def test_chain_replays_read_the_buffer_they_update(card):
    """The chained body captured as a CUDA graph: each replay reads the
    static node_feat the previous replay updated (feat[0, 0] doubles plus
    one a call: 2^k − 1 after k calls; a replay that read a copy would
    give k) and consumes the whole output (only its last element is
    nonzero)."""
    from gnn_bfs_rans_tpu_torch.graph.structs import build_padded_graph
    from gnn_bfs_rans_tpu_torch.utils.bench import _chain

    g = build_padded_graph(np.array([0, 1], np.int32),
                           np.array([1, 0], np.int32),
                           np.zeros((2, 4), np.float32),
                           np.zeros((2, 3), np.float32),
                           node_align=8, edge_align=8).to(card)

    def apply_fn(graph):
        out = torch.zeros(5, 7, device=graph.node_feat.device)
        out[-1, -1] = (graph.node_feat[0, 0] + 1) * 1e30
        return out

    step, _ = _chain(apply_fn, g)       # warm-up, capture and replay
    for _ in range(3):                  # three replays
        feat = step()
    torch.cuda.synchronize()
    assert feat[0, 0].item() == 2 ** 5 - 1


def test_chained_marginal_time_on_the_card(card, tmp_path):
    """A replayed chain of the GAT forward on the banded kernels: a
    positive marginal time, and the kernel's launches counted per replay
    (warm-up and capture 2 calls, then a warm run and one trial at base 1
    and at reps 16: 36 calls of 2 layers)."""
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.utils.bench import chained_marginal_time

    generate_box_case(tmp_path / "case", 40, 12, 1)
    graph = load_graph(tmp_path / "case", "GAT").to(card)
    model = FlowGNN(ModelConfig(hidden_dim=64, num_layers=2,
                                layer_type="GAT", backend="pallas",
                                compute_dtype="bfloat16")).eval().to(card)
    _build.reset_launches()
    t = chained_marginal_time(model, graph, reps=16, base=1, trials=1,
                              min_snr=0.0, max_reps=16)
    assert 0 < t.step_s < 1.0 and t.reps == 16
    assert _build.LAUNCHES["banded_gat_mean_fused"] == 2 * 36
