"""Rows 6 and 10 as redesigned for the H100: their host-side planning and
row 10's pass split, on the CPU.

* row 6 (``fold_project_bwd``) runs dx = dz·Wᵀ and dW = xᵀ·dz as one
  persistent launch over a list of work items (``kernels/banded_bwd.py::
  _tiles``, ``_plan`` and ``_schedule``; ``csrc/gemm_sm90.cuh``): the
  tiles, the dW chunk count (fewer and smaller f32 slices than the former
  264-block split), and each block's items (longest first to the least
  loaded block), which must run every item once and cover each dW tile's
  K range without overlap;
* row 10 (``banded_transformer_bwd``): its receiver pass now stores
  round(dl) and round(ẽ) at the mask's nonzeros and its partials pass sums
  them with the receivers' q and G' = round(g·inv) rows, column by column
  and receiver by receiver in ascending order.  That split, emulated here
  from the plain receiver pass (``_tr_bwd_rows_plain``), equals the plain
  version (f32: summation order; bf16: one ulp) and the JAX kernel in
  interpret mode (f32, 1e-5 of each output's max, as
  ``test_torch_transformer_bwd.py`` holds the plain version).

The CUDA kernels themselves are held against the plain versions on the card
by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.graph.band import build_band as jax_build_band
from gnn_bfs_rans_tpu.kernels import banded_bwd as jkb
from gnn_bfs_rans_tpu_torch.foam import generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS, build_band
from gnn_bfs_rans_tpu_torch.infer import load_graph
from gnn_bfs_rans_tpu_torch.kernels import banded_bwd as tb

SMS = 132      # the H100's SMs
N, F, HEADS, C = 12032, 256, 4, 256   # the flagship shape
# (label, F, H·C, bias form) of row 6 on the main path
ROW6 = [("gat", F, HEADS * C), ("wblk", HEADS * C, HEADS * 4),
        ("bias", F, 3 * HEADS * C)]


def _cdiv(a, b):
    return -(-a // b)


# ------------------------------------------------------------------ row 6
def _costs(n, f, hc, bf16, splits, chunk):
    """The items' costs as ``_plan`` counts them (bytes loaded and stored),
    in item-id order, and the dW items' (tile, K steps)."""
    (xm, xn, xk), (wm, wn, wk), isz = tb._tiles(bf16, n, hc)
    w_steps, dw_tm, dw_tn = _cdiv(n, wk), _cdiv(f, wm), _cdiv(hc, wn)
    n_x = _cdiv(n, xm) * _cdiv(f, xn)
    costs = [_cdiv(hc, xk) * (xm + xn) * xk * isz + xm * xn * isz] * n_x
    steps = {}
    for j in range(dw_tm * dw_tn * splits):
        tn, tm, z = j % dw_tn, (j // dw_tn) % dw_tm, j // (dw_tn * dw_tm)
        k = range(z * chunk, min(w_steps, (z + 1) * chunk))
        steps.setdefault((tm, tn), []).extend(k)
        costs.append(len(k) * (wm + wn) * wk * isz + wm * wn * 4)
    return costs, n_x, steps, w_steps


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("label,f,hc", ROW6)
def test_row6_plan_at_the_main_path_shapes(label, f, hc, bf16):
    """The chunks cover dW's K steps with none empty; the grid is at most
    one block per item and per slot; the f32 slices are fewer than the
    former split's (264 blocks over the output tiles, at least 256 rows
    each) and stay within ``_SLICE_BYTES``."""
    slots = SMS * (1 if bf16 else 2)
    splits, chunk, grid, lists = tb._plan(N, f, hc, bf16, slots)
    costs, _, _, w_steps = _costs(N, f, hc, bf16, splits, chunk)
    assert splits * chunk >= w_steps > (splits - 1) * chunk
    assert grid == len(lists) == min(len(costs), slots)
    old = max(1, min(_cdiv(264, _cdiv(f, 128) * _cdiv(hc, 128)), N // 256))
    assert splits < old
    assert splits == 1 or splits * (f + 1) * hc * 4 <= tb._SLICE_BYTES


def test_row6_tiles():
    """bf16: dx tiles of 256 columns when dz fills half the L2 or more (read
    once), 128 below (the GAT form's 24.6 MB), the narrow forms when H·C is
    not a multiple of 64; f32 128 × 128 × 16."""
    assert tb._tiles(True, N, HEADS * C)[0] == (128, 128, 64)
    assert tb._tiles(True, N, 3 * HEADS * C)[0] == (128, 256, 64)
    assert tb._tiles(True, N, 3 * HEADS * C)[1] == (256, 128, 64)
    for hc in (8, 16, 40):
        assert tb._tiles(True, N, hc) == ((128, 256, 16), (256, 16, 64), 2)
    assert tb._tiles(False, N, 1024) == ((128, 128, 16), (128, 128, 16), 4)


@pytest.mark.parametrize("shape", [(N, F, 1024, True), (N, F, 3072, True),
                                   (N, 1024, 16, True), (N, F, 1024, False),
                                   (1000, 64, 192, True), (300, 128, 8, True),
                                   (12000, 256, 3072, False)])
def test_row6_schedule_runs_every_item_once(shape):
    """Every item on exactly one block; each dW tile's K steps exactly once
    across its chunks (so the fold sums each row of xᵀ·dz once); no block
    loaded beyond the average plus the largest item (the longest-first
    assignment's bound, which bf16's rounds meet at these shapes too); the
    kernel's int32 layout of the lists."""
    n, f, hc, bf16 = shape
    slots = SMS * (1 if bf16 else 2)
    splits, chunk, grid, lists = tb._plan(n, f, hc, bf16, slots)
    costs, _, steps, w_steps = _costs(n, f, hc, bf16, splits, chunk)
    ids = sorted(i for items in lists for i in items)
    assert ids == list(range(len(costs)))
    assert all(sorted(k) == list(range(w_steps)) for k in steps.values())
    loads = [sum(costs[i] for i in items) for items in lists]
    assert max(loads) <= sum(costs) / grid + max(costs)
    sched = tb._schedule(n, f, hc, bf16, slots, torch.device("cpu"))
    assert sched.dtype == torch.int32
    offs, flat = sched[:grid + 1].tolist(), sched[grid + 1:].tolist()
    assert offs[0] == 0 and offs[-1] == len(costs) == len(flat)
    assert [flat[offs[b]:offs[b + 1]] for b in range(grid)] == list(
        map(list, lists))


# ----------------------------------------------------------------- row 10
H, CS, TILE, RATE, SEED = 2, 16, 16, 0.3, 17
BOXES = {3: (20, 12), 5: (40, 28)}


@pytest.fixture(scope="module")
def bands(tmp_path_factory):
    """window → {form: (JAX band, port band)} at tile 16 (geo: the box's own
    geometric planes; edge: random features on the same edges)."""
    out = {}
    for window, (nx, ny) in BOXES.items():
        path = tmp_path_factory.mktemp(f"split_w{window}") / "case"
        generate_box_case(path, nx, ny, 1)
        g = load_graph(path, "Transformer")
        n = -(-g.n_nodes // TILE) * TILE
        s = g.senders.numpy()[: g.n_edges]
        r = g.receivers.numpy()[: g.n_edges]
        args = (s, r, n, g.node_mask.numpy()[:n], g.in_degree.numpy()[:n])
        feats = {"geo": g.edge_feat.numpy()[: g.n_edges],
                 "edge": np.random.default_rng(window).normal(
                     size=(s.size, 4)).astype(np.float32)}
        out[window] = {}
        for form, feat in feats.items():
            kw = dict(tile=TILE, components=LAYER_COMPONENTS["Transformer"],
                      edge_feat=feat, node_pos=g.node_feat.numpy()[:n])
            out[window][form] = (jax_build_band(*args, **kw),
                                 build_band(*args, **kw))
    return out


def _case(pb, form, mean, dtype, seed=6):
    """Row 10's port inputs (q, k, v, g, keywords) from a seeded numpy
    draw, and the same arrays as numpy for the JAX side."""
    n = pb.bias_noself.shape[0] * TILE
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(n, H * CS)).astype(np.float32)
               for _ in range(3))
    qw = rng.normal(size=(n, H * 4)).astype(np.float32)
    g = rng.normal(size=(n, CS if mean else H * CS)).astype(np.float32)
    gs = rng.normal(size=(n, H * 4)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    kw = dict(mean_expand=mean, dropout_rate=RATE,
              seed=torch.tensor([SEED], dtype=torch.int32))
    if form == "geo":
        kw.update(geo=pb.geo, pos=pb.pos, qw=t(qw), gs=torch.from_numpy(gs))
    elif form == "edge":
        kw.update(edge=pb.edge, qw=t(qw), gs=torch.from_numpy(gs))
    return (t(q), t(k), t(v), t(g)), kw, (q, k, v, g, qw, gs)


def _split(pb, args, kw):
    """Row 10 as the two CUDA passes split it: the receiver pass's planes,
    then each window column's dk/dv partial row summed over its receivers
    in ascending order (f32), rounded once.  Also returns the planes."""
    q = args[0]
    n_tiles, tile, width = pb.bias_noself.shape
    hc = q.shape[1]
    dq, dqw, dl_r, ed_r, g_s = tb._tr_bwd_rows_plain(pb.bias_noself, *args,
                                                     H, **kw)
    q4 = q.reshape(n_tiles, tile, H, hc // H).float()
    dk = torch.zeros(n_tiles, width, H, hc // H)
    dv = torch.zeros_like(dk)
    for i in range(tile):          # the receivers of every column, in order
        dk += dl_r[:, :, i, :].permute(0, 2, 1)[..., None] * q4[:, None, i]
        dv += ed_r[:, :, i, :].permute(0, 2, 1)[..., None] * g_s[:, None, i]
    parts = (n_tiles, width // (tile // 2), tile // 2, hc)
    out = (dq, dk.reshape(parts).to(q.dtype), dv.reshape(parts).to(q.dtype))
    return (out if dqw is None else (*out, dqw)), (dl_r, ed_r)


SPLIT = [(f, m) for f in ("plain", "edge", "geo") for m in (True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("form,mean", SPLIT)
def test_row10_split_matches_plain(bands, form, mean, window, dtype):
    """The planes are 0 off the mask (the kernel neither writes nor reads
    them there); the split's dk/dv partials equal the plain version's:
    f32 within 1e-6 of their max (summation order alone), bf16 within one
    ulp element by element (the f32 sums round once on both sides); dq and
    dqw are the receiver pass's own."""
    pb = bands[window]["edge" if form == "edge" else "geo"][1]
    args, kw, _ = _case(pb, form, mean, dtype)
    got, (dl_r, ed_r) = _split(pb, args, kw)
    want = tb.banded_transformer_bwd_plain(pb.bias_noself, *args, H, **kw)
    off = (pb.bias_noself == 0)[:, None].expand_as(dl_r)
    assert (dl_r[off] == 0).all() and (ed_r[off] == 0).all()
    assert len(got) == len(want)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    if len(got) == 4:
        torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
    for name, a, b in zip(("dk", "dv"), got[1:3], want[1:3]):
        a, b = a.float(), b.float()
        assert a.dtype == b.dtype and a.shape == b.shape
        if dtype == torch.float32:
            assert (a - b).abs().max() <= 1e-6 * b.abs().max(), name
        else:
            assert ((a - b).abs() <= 2.0 ** -7 * torch.maximum(
                a.abs(), b.abs())).all(), name


@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("form,mean", SPLIT)
def test_row10_split_matches_jax(bands, form, mean, window):
    """f32 at rate 0.3 with the cotangent of s: the split's dq and dk/dv
    partials within 1e-5 of each one's max of ``banded_transformer_bwd(...,
    raw_kv_partials=True)`` (Pallas in interpret mode)."""
    jb, pb = bands[window]["edge" if form == "edge" else "geo"]
    args, kw, (q, k, v, g, qw, gs) = _case(pb, form, mean, torch.float32)
    got, _ = _split(pb, args, kw)
    jc = {}
    if form == "geo":
        jc = dict(geo_band=jnp.asarray(jb.geo), pos=jnp.asarray(jb.pos),
                  qw=jnp.asarray(qw), gs=jnp.asarray(gs))
    elif form == "edge":
        jc = dict(edge_band=jnp.asarray(jb.edge), qw=jnp.asarray(qw),
                  gs=jnp.asarray(gs))
    want = jkb.banded_transformer_bwd(
        jnp.asarray(jb.bias_noself), *map(jnp.asarray, (q, k, v, g)), H,
        dropout_rate=RATE, seed=jnp.asarray([SEED], jnp.int32),
        mean_expand=mean, raw_kv_partials=True, **jc)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max(), name
