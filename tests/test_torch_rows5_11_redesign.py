"""Rows 5 and 11 as redesigned for the H100: row 5's pass split and row
11's projection walk, on the CPU.

* row 5 (``banded_gat_bwd``): its receiver pass stores round(ẽ) and
  round(dpre) at the mask's nonzeros and its sender pass only sums them:
  dα_src[s] = Σ_i round(dpre_is) and dz[s] = Σ_i round(ẽ_is)·round(gout_i·
  inv_i), column by column and receiver by receiver in ascending order,
  reading the mask through its transpose [n_tiles, Wcols, T].  That split,
  emulated here from the plain receiver pass (``_gat_bwd_rows_plain``),
  equals the plain version (f32: summation order; bf16: one ulp) and the
  JAX kernel in interpret mode with its dz window partials folded into
  rows (f32, 1e-5 of each output's max), head mean and per head, at W 3 and
  W 5, with and without dropout (the port replays the interpret-mode hash);
* row 11 (``banded_transformer_geo_mean_fused``): its bf16 projection
  walks output tiles of 128 rows × 256 columns of one of the three weights
  on one persistent block per SM (``csrc/gemm_sm90.cuh::fwd::tile_of`` and
  ``run_proj_fwd_bf16``, modelled here; the card tests run the kernel's own
  walk with more tiles than SMs): every tile of q|k|v is written exactly
  once, and at C 256 each tile is one head of q, k or v.  The projection computed tile by tile from the
  three weights, then the attention, equals the plain version and the JAX
  kernel (f32, 1e-5).

The CUDA kernels themselves are held against the plain versions on the card
by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.graph.band import build_band as jax_build_band
from gnn_bfs_rans_tpu.kernels import banded as jk
from gnn_bfs_rans_tpu.kernels import banded_bwd as jkb
from gnn_bfs_rans_tpu_torch.foam import generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS, build_band
from gnn_bfs_rans_tpu_torch.infer import load_graph
from gnn_bfs_rans_tpu_torch.kernels import banded as tk
from gnn_bfs_rans_tpu_torch.kernels import banded_bwd as tb

# torch's first multi-threaded f32 exp in a process was seen to return
# values 1e-4 off in one thread's chunk (as in the other new test files)
torch.exp(torch.linspace(-10.0, 0.0, 1 << 16))

# ------------------------------------------------------------------ row 5
H, C, TILE, SEED = 2, 16, 16, 17
BOXES = {3: (20, 12), 5: (40, 28)}


@pytest.fixture(scope="module")
def gat_bands(tmp_path_factory):
    """window → (JAX band, port band) of the GAT mask at tile 16."""
    out = {}
    for window, (nx, ny) in BOXES.items():
        path = tmp_path_factory.mktemp(f"row5_w{window}") / "case"
        generate_box_case(path, nx, ny, 1)
        g = load_graph(path, "GAT")
        n = -(-g.n_nodes // TILE) * TILE
        args = (g.senders.numpy()[: g.n_edges],
                g.receivers.numpy()[: g.n_edges], n,
                g.node_mask.numpy()[:n], g.in_degree.numpy()[:n])
        kw = dict(tile=TILE, components=LAYER_COMPONENTS["GAT"])
        out[window] = (jax_build_band(*args, **kw), build_band(*args, **kw))
        assert out[window][1].bias_self.shape[-1] == window * TILE
    return out


def _case5(pb, mean, rate, dtype, seed=6):
    """Row 5's port arguments from a seeded numpy draw, and the arrays as
    numpy for the JAX side."""
    n = pb.bias_self.shape[0] * TILE
    rng = np.random.default_rng(seed)
    z = (0.5 * rng.normal(size=(n, H * C))).astype(np.float32)
    alphas = rng.normal(size=(n, 2 * H)).astype(np.float32)
    g = rng.normal(size=(n, C if mean else H * C)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    seed_t = torch.tensor([SEED], dtype=torch.int32) if rate else None
    args = (pb.bias_self, t(z), torch.from_numpy(alphas), t(g), H, 0.2, rate,
            seed_t)
    return args, (z, alphas, g)


def _split5(pb, args, mean):
    """Row 5 as the two CUDA passes split it: the receiver pass's planes,
    then each window column's dz and dα_src summed over its receivers in
    ascending order (f32), folded onto sender rows, dz rounded once.  Also
    returns the planes."""
    z = args[1]
    n_tiles, tile, width = pb.bias_self.shape
    n, hc = z.shape
    dad, ed_r, dpre_r, g_s = tb._gat_bwd_rows_plain(*args, mean_expand=mean)
    dz_win = torch.zeros(n_tiles, width, H, hc // H)
    das_win = torch.zeros(n_tiles, width, H)
    for i in range(tile):          # the receivers of every column, in order
        dz_win += ed_r[:, i, :, :, None] * g_s[:, i, None]
        das_win += dpre_r[:, i]
    dz = tb._fold_windows(dz_win.reshape(n_tiles, width, hc), tile)
    das = tb._fold_windows(das_win, tile)
    return (dz.to(z.dtype), torch.cat([das, dad], dim=1)), (ed_r, dpre_r)


SPLIT5 = [(m, r) for m in (True, False) for r in (0.0, 0.1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("mean,rate", SPLIT5,
                         ids=[f"{'mean' if m else 'per_head'}-rate{r}"
                              for m, r in SPLIT5])
def test_row5_split_matches_plain(gat_bands, mean, rate, window, dtype):
    """The planes are 0 off the mask (the kernel neither writes nor reads
    them there); the split's dz equals the plain version's, f32 within 1e-6
    of its max (summation order alone), bf16 within one ulp element by
    element (the f32 sums round once on both sides); dα too (f32)."""
    pb = gat_bands[window][1]
    args, _ = _case5(pb, mean, rate, dtype)
    (dz, da), (ed_r, dpre_r) = _split5(pb, args, mean)
    want_dz, want_da = tb.banded_gat_bwd_plain(*args, mean_expand=mean)
    off = (pb.bias_self == 0)[..., None].expand_as(ed_r)
    assert (ed_r[off] == 0).all() and (dpre_r[off] == 0).all()
    assert (ed_r[~off] != 0).any()
    assert dz.dtype == want_dz.dtype == dtype and dz.shape == want_dz.shape
    assert (da - want_da).abs().max() <= 1e-6 * want_da.abs().max()
    a, b = dz.float(), want_dz.float()
    if dtype == torch.float32:
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()
    else:
        assert ((a - b).abs() <= 2.0 ** -7 * torch.maximum(a.abs(),
                                                          b.abs())).all()


@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("mean,rate", SPLIT5,
                         ids=[f"{'mean' if m else 'per_head'}-rate{r}"
                              for m, r in SPLIT5])
def test_row5_split_matches_jax(gat_bands, mean, rate, window):
    """f32: the split's dz and dα within 1e-5 of each one's max of
    ``banded_gat_bwd(..., mxu_das=True, raw_dz_partials=True)`` (Pallas in
    interpret mode), its dz window partials folded into rows."""
    jb, pb = gat_bands[window]
    args, (z, alphas, g) = _case5(pb, mean, rate, torch.float32)
    (dz, da), _ = _split5(pb, args, mean)
    seed = jnp.asarray([SEED], jnp.int32) if rate else None
    part, jda = jkb.banded_gat_bwd(
        jnp.asarray(jb.bias_self), jnp.asarray(z), jnp.asarray(alphas),
        jnp.asarray(g), H, negative_slope=0.2, dropout_rate=rate, seed=seed,
        mean_expand=mean, mxu_das=True, raw_dz_partials=True)
    jdz = np.asarray(jkb.combine_partials(part.astype(jnp.float32), TILE))
    for name, a, b in (("dz", dz, jdz), ("da", da, np.asarray(jda))):
        assert tuple(a.shape) == b.shape, name
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max(), name


@pytest.mark.parametrize("window", [3, 5])
def test_row5_transposed_mask(gat_bands, window):
    """The sender pass's mask is the mask's transpose [n_tiles, Wcols, T],
    contiguous; the band computes it once and keeps it."""
    pb = gat_bands[window][1]
    mt = tb.transpose_mask(pb.bias_self)
    assert mt.is_contiguous() and mt.dtype == torch.int8
    assert torch.equal(mt, pb.bias_self.permute(0, 2, 1))
    n_tiles, tile, width = pb.bias_self.shape
    for t in range(n_tiles):
        for w in range(0, width, 7):
            assert torch.equal(mt[t, w], pb.bias_self[t, :, w])
    kept = pb.transposed("bias_self")
    assert torch.equal(kept, mt) and pb.transposed("bias_self") is kept


# ----------------------------------------------------------------- row 11
SMS = 132      # the H100's SMs
N, HEADS, CF = 12032, 4, 256   # the flagship shape
BM, BN = 128, 256              # the kernel's tile (fwd::BM, fwd::BN)


def _qkv_plan(n, hc, sms):
    """(column tiles per weight, tiles, grid) as ``run_proj_fwd_bf16``
    sets them: one block per SM, or per tile if fewer."""
    tpm = -(-hc // BN)
    tiles = -(-n // BM) * 3 * tpm
    return tpm, tiles, min(tiles, sms)


def _qkv_tile(tpm, tile_id):
    """(row tile, weight, first column) of one projection tile, column
    tile fastest, as the kernel decodes a tile id (``fwd::tile_of``)."""
    tm, j = divmod(tile_id, 3 * tpm)
    return tm, j // tpm, (j % tpm) * BN


@pytest.mark.parametrize("n,hc", [(N, HEADS * CF), (12000, HEADS * CF),
                                  (400, 2 * CF), (384, 32), (300, 600)])
def test_row11_plan_writes_each_tile_once(n, hc):
    """Block b walks tiles b, b + grid, …: every tile of q|k|v exactly once,
    on at most one block per SM; the tiles cover every (row, column) of
    each weight's output once; with H·C a multiple of 256 (C 256) each
    tile is one head of one of q, k, v."""
    bm, bn = BM, BN
    tpm, tiles, grid = _qkv_plan(n, hc, SMS)
    assert grid == min(tiles, SMS) and tiles == -(-n // bm) * 3 * tpm
    walked = sorted(i for b in range(grid) for i in range(b, tiles, grid))
    assert walked == list(range(tiles))
    cover = np.zeros((3, -(-n // bm) * bm, tpm * bn), np.int32)
    heads = set()
    for i in range(tiles):
        tm, m, col0 = _qkv_tile(tpm, i)
        assert 0 <= m < 3 and col0 < hc and tm * bm < n
        cover[m, tm * bm:(tm + 1) * bm, col0:col0 + bn] += 1
        if hc % bn == 0:
            heads.add((tm, m, col0 // bn))
    assert (cover[:, :n, :hc] == 1).all()
    if hc % bn == 0:
        assert len(heads) == tiles


def _tiled_qkv(x, ws, bs):
    """The projection as the kernel walks it: each tile's rows and columns
    of one weight, f32 accumulate, the bias added in f32, one rounding."""
    n, hc = x.shape[0], ws[0].shape[1]
    bm, bn = BM, BN
    tpm, tiles, _ = _qkv_plan(n, hc, SMS)
    qkv = torch.full((n, 3 * hc), float("nan"), dtype=x.dtype)
    for i in range(tiles):
        tm, m, col0 = _qkv_tile(tpm, i)
        rows = slice(tm * bm, min(n, (tm + 1) * bm))
        cols = slice(col0, min(hc, col0 + bn))
        acc = x[rows].float() @ ws[m][:, cols].float() + bs[m][cols].float()
        qkv[rows, m * hc + cols.start:m * hc + cols.stop] = acc.to(x.dtype)
    return qkv


@pytest.fixture(scope="module")
def geo_band(tmp_path_factory):
    """(JAX band, port band) of the Transformer's geo form on a 336-cell
    box case (48 padding rows), tile 128."""
    path = tmp_path_factory.mktemp("row11_plan") / "case"
    generate_box_case(path, 24, 14, 1)
    g = load_graph(path, "Transformer")
    args = (g.senders.numpy()[: g.n_edges], g.receivers.numpy()[: g.n_edges],
            g.n_pad, g.node_mask.numpy(), g.in_degree.numpy())
    kw = dict(tile=128, components=LAYER_COMPONENTS["Transformer"],
              edge_feat=g.edge_feat.numpy()[: g.n_edges],
              node_pos=g.node_feat.numpy())
    return jax_build_band(*args, **kw), build_band(*args, **kw)


@pytest.mark.parametrize("heads,c,f", [(2, 16, 32), (2, 160, 24)])
def test_row11_tiled_projection_matches_plain_and_jax(geo_band, heads, c, f):
    """f32: the three weights projected tile by tile (every q|k|v element
    written, by one tile), then row 9's geo-mean attention with qw = q·wblk
    in f32, within 1e-5 of the plain version and of
    ``banded_transformer_geo_mean_fused`` (Pallas in interpret mode); s is
    held by column group as ``test_torch_transformer.py`` holds it (the
    direction columns cancel terms of max|pos|·max(1/dist))."""
    jb, pb = geo_band
    n = pb.bias_noself.shape[0] * 128
    hc = heads * c
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, f)).astype(np.float32)
    ws = [(rng.normal(size=(f, hc)) * f ** -0.5).astype(np.float32)
          for _ in range(3)]
    bs = [(0.1 * rng.normal(size=hc)).astype(np.float32) for _ in range(3)]
    w_e = (rng.normal(size=(4, heads, c)) * 0.5).astype(np.float32)
    wblk = (np.eye(heads, dtype=np.float32)[:, None, :, None]
            * np.transpose(w_e, (1, 2, 0))[:, :, None, :]
            ).reshape(hc, heads * 4)
    t = torch.from_numpy
    qkv = _tiled_qkv(t(x), [t(w) for w in ws], [t(b) for b in bs])
    assert not torch.isnan(qkv).any()
    q, k, v = qkv[:, :hc], qkv[:, hc:2 * hc], qkv[:, 2 * hc:]
    got = tk.banded_transformer_fwd_plain(
        pb.bias_noself, q, k, v, heads, qw=q @ t(wblk), geo=pb.geo,
        pos=pb.pos, mean_heads=True)
    plain = tk.banded_transformer_geo_mean_fused_plain(
        pb.bias_noself, pb.geo, pb.pos, t(x), *map(t, ws), *map(t, bs),
        t(wblk), heads)
    jax_out = jk.banded_transformer_geo_mean_fused(
        jnp.asarray(jb.bias_noself), jnp.asarray(jb.geo), jnp.asarray(jb.pos),
        jnp.asarray(x), *map(jnp.asarray, ws), *map(jnp.asarray, bs),
        jnp.asarray(wblk), heads)
    cancel = pb.pos.abs().max().item() * pb.geo[:, 1].max().item()
    for want in (plain, [t(np.array(a, np.float32)) for a in jax_out]):
        out, s = got[0], got[1]
        assert (out - want[0]).abs().max() <= 1e-5 * want[0].abs().max()
        d = (s - want[1]).abs().view(n, heads, 4)
        r = want[1].abs().view(n, heads, 4)
        assert d[..., :3].max() <= 1e-5 * r[..., :3].max() + 1e-6 * cancel
        assert d[..., 3].max() <= 1e-5 * r[..., 3].max()
