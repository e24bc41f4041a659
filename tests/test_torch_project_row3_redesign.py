"""Row 3 and the Transformer training projection as redesigned for the
H100: the kernels' order of work, emulated on the CPU.

* row 3 (``fused_epilogue_bwd``, ``csrc/epilogue_bwd.cu``): one cooperative
  launch of persistent blocks, each a contiguous range of rows.  A thread
  keeps 4 columns (or one, when C is not a multiple of 4) and sums g1 and
  g1·x̂ over its rows r0 + ty, r0 + ty + lanes, … in order; the block adds
  its row lanes in order into one partial; after a grid-wide barrier warp
  k folds column k of the partials, lane l the blocks l, l + 32, … (eight
  at a time), then a butterfly; after a second barrier each block forms
  dxr from the g1 and
  xr it holds in shared memory (g1 is exact in xr's dtype), or from g and
  xr read again when its rows do not fit.  The emulation does exactly that
  in torch f32 and is held against ``fused_epilogue_bwd_plain`` (f32: 1e-5
  of each output's max, the summation order; bf16: two bf16 ulps) and
  against ``jax.vjp`` of the JAX package's ``fused_epilogue`` in interpret
  mode (f32 1e-4, bf16 2e-2, as ``test_torch_train_kernels.py`` holds the
  plain version), on the same numpy inputs: rates 0 and 0.1, f32, bf16 and
  mixed, pad rows (n_valid < n_pad), with the dropout keep mask
  bit-identical to the JAX stream;
* ``transformer_project`` (``csrc/banded_transformer.cu`` on
  ``csrc/gemm_sm90.cuh``'s forward launch): the three-weight walk of output
  tiles of 128 rows × 256 columns (``fwd::tile_of``) writes every q|k|v
  tile once, and the q tiles' epilogue (``fwd::qw_epilogue``, mma.m16n8k16
  over 16-column chunks) writes each element of qw once, and nothing else
  writes qw; the tile-by-tile qkv and qw equal the plain version and,
  through row 9's geo-mean attention, the JAX package's projgrad op.

The CUDA kernels themselves are held against the plain versions on the card
by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.graph.band import build_band as jax_build_band
from gnn_bfs_rans_tpu.kernels import banded as jk
from gnn_bfs_rans_tpu.kernels.banded import _dropout_thresh, _hash_bits
from gnn_bfs_rans_tpu.kernels.epilogue import _pick_block
from gnn_bfs_rans_tpu.kernels.epilogue import fused_epilogue as jax_epilogue
from gnn_bfs_rans_tpu_torch.foam import generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS, build_band
from gnn_bfs_rans_tpu_torch.infer import load_graph
from gnn_bfs_rans_tpu_torch.kernels import banded as tk
from gnn_bfs_rans_tpu_torch.kernels import epilogue as te

# torch's first multi-threaded f32 exp in a process was seen to return
# values 1e-4 off in one thread's chunk (as in the other new test files)
torch.exp(torch.linspace(-10.0, 0.0, 1 << 16))

# ------------------------------------------------------------------ row 3
THREADS, FOLD, SMEM_MAX = 512, 8, 232448   # the kernel's constants
N_PAD, N_VALID, SEED = 1000, 937, 4321
MODES = {"float32": ("float32", "float32"),
         "bfloat16": ("bfloat16", "bfloat16"),
         "mixed": ("float32", "bfloat16")}
BF16_ULPS = 2.0 ** -7     # two bf16 ulps of an output's largest value


def _row3_inputs(mode, c, rate, seed=3):
    """numpy inputs; the port's forward residuals (xr, vec, mean) on them;
    the cotangent in xr's dtype."""
    dx, dxn = MODES[mode]
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N_PAD, c)) + rng.normal(size=c)).astype(np.float32)
    xn = rng.normal(size=(N_PAD, c)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    g = rng.normal(size=(N_PAD, c)).astype(np.float32)
    seed_t = torch.tensor([SEED], dtype=torch.int32) if rate else None
    _, mean, _, xr, vec = te._forward(
        torch.from_numpy(x).to(getattr(torch, dx)),
        torch.from_numpy(xn).to(getattr(torch, dxn)), torch.from_numpy(scale),
        torch.from_numpy(bias), N_VALID, 1e-5, rate, seed_t)
    args = (torch.from_numpy(g).to(xr.dtype), xr, vec, mean, N_VALID, rate,
            seed_t, getattr(torch, dx), getattr(torch, dxn))
    return (x, xn, scale, bias, g), args


def _layout(n, c, dtype, grid):
    """(V, row lanes, rows a block, blocks) as ``epilogue_bwd_launch`` sets
    them for ``grid`` blocks at most."""
    v = 4 if c % 4 == 0 else 1
    lanes = THREADS // (c // v)
    grid = min(grid, -(-n // lanes))
    rows = -(-n // grid)
    return v, lanes, rows, -(-n // rows)


def _rnd(t, dt):
    return t.to(dt).float()


def _g1_xhat(g, xr, vec, mean, rate, seed):
    """g1, x̂ (f32) and the keep mask at the kernel's rounding points."""
    dt = xr.dtype
    x = xr.float()
    y = _rnd(x - _rnd(vec[0], dt), dt)
    y = _rnd(y * _rnd(vec[1], dt), dt)
    y = _rnd(y + _rnd(vec[2], dt), dt)
    gv = g.float()
    keep = torch.ones_like(gv, dtype=torch.bool)
    if rate > 0:
        n, c = xr.shape
        keep = te._epilogue_keep(seed.long(), n, c,
                                 te.pick_block(n, c, xr.element_size()), rate,
                                 "cpu")
        gv = torch.where(keep, _rnd(gv * te.drop_scale(rate, dt), dt), 0.0)
    g1 = torch.where(y > 0, gv, torch.zeros(()))
    return g1, (x - mean) * vec[3], keep


def _butterfly(vals):
    """Lane 0's value after the kernel's xor butterfly over 32 lanes."""
    for o in (16, 8, 4, 2, 1):
        vals = [vals[lane] + vals[lane ^ o] for lane in range(32)]
    return vals[0]


def row3_emulated(g, xr, vec, mean, n_valid, rate, seed, x_dt, xn_dt,
                  grid, held=True):
    """(dx, dx_new, dscale, dbias) in the kernel's order of work over
    ``grid`` blocks; ``held``: phase 3 from the g1 and xr tiles kept in
    shared memory (g1 stored in xr's dtype), else from g and xr again."""
    dt = xr.dtype
    n, c = xr.shape
    _, lanes, rows, grid = _layout(n, c, dt, grid)
    g1, xh, keep = _g1_xhat(g, xr, vec, mean, rate, seed)
    part = torch.zeros(grid, 2, c)
    for b in range(grid):
        r0, r1 = b * rows, min(n, (b + 1) * rows)
        k = -(-(r1 - r0) // lanes)
        blk = torch.zeros(k * lanes, 2, c)
        blk[: r1 - r0, 0] = g1[r0:r1]
        blk[: r1 - r0, 1] = g1[r0:r1] * xh[r0:r1]
        blk = blk.view(k, lanes, 2, c)
        s = torch.zeros(lanes, 2, c)
        for i in range(k):          # each thread's rows in ascending order
            s = s + blk[i]
        p = torch.zeros(2, c)
        for lane in range(lanes):   # the block's row lanes in order
            p = p + s[lane]
        part[b] = p
    lane_sums = []
    for lane in range(32):          # lane l folds blocks l, l + 32, …
        s = torch.zeros(2, c)
        for b0 in range(0, grid, 32 * FOLD):
            for i in range(FOLD):
                b = b0 + 32 * i + lane
                s = s + (part[b] if b < grid else torch.zeros(2, c))
        lane_sums.append(s)
    tot = _butterfly(lane_sums)
    gvec = tot / torch.full_like(tot, float(n_valid))
    if held:   # g1 is exact in xr's dtype: the held tile gives it back
        assert torch.equal(_rnd(g1, dt), g1)
        g1 = _rnd(g1, dt)
        xh = (_rnd(xr.float(), dt) - mean) * vec[3]
    real = (torch.arange(n) < n_valid)[:, None]
    d = torch.where(real, g1 - (gvec[0] + xh * gvec[1]), g1)
    dxr = vec[1] * d
    outs = [dxr.to(dt) if od == dt else dxr.to(od) for od in (x_dt, xn_dt)]
    return outs[0], outs[1], tot[1], tot[0], keep


def _close(got, want, dtype):
    tol = 1e-5 if dtype == torch.float32 else BF16_ULPS
    want = want.float()
    assert (got.float() - want).abs().max() <= tol * want.abs().max()


ROW3 = [(mode, rate, c) for mode in MODES for rate in (0.0, 0.1)
        for c in (64, 96)]


@pytest.mark.parametrize("mode,rate,c", ROW3,
                         ids=[f"{m}-rate{r}-c{c}" for m, r, c in ROW3])
def test_row3_order_matches_plain(mode, rate, c):
    """The emulated launch over 6 blocks (shared-memory branch) and over 11
    (re-read branch) against the plain version: f32 summation order, bf16
    two ulps; both branches give the same bits."""
    _, args = _row3_inputs(mode, c, rate)
    ref = te.fused_epilogue_bwd_plain(*args)
    held = row3_emulated(*args, grid=6, held=True)
    reread = row3_emulated(*args, grid=11, held=False)
    again = row3_emulated(*args, grid=11, held=True)
    for h, r, a, want in zip(held[:4], reread[:4], again[:4], ref):
        assert h.dtype == r.dtype == want.dtype
        assert torch.equal(r, a)       # held or read again: the same bits
        for got in (h, r):
            _close(got, want, want.dtype)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_row3_order_matches_jax(mode, rate):
    """The emulated launch against ``jax.vjp`` of the JAX package's
    ``fused_epilogue`` (interpret mode) on the same numpy inputs, pad rows
    included; its keep mask is the JAX interpret-mode stream bit for bit."""
    c = 64
    dx, dxn = MODES[mode]
    (x, xn, scale, bias, g), args = _row3_inputs(mode, c, rate, seed=8)
    seed_j = jnp.array([SEED], jnp.int32) if rate else None
    (y, mean, var), vjp = jax.vjp(
        lambda a, b, s, t: jax_epilogue(a, b, s, t, seed_j, N_VALID, rate,
                                        1e-5),
        jnp.asarray(x, dx), jnp.asarray(xn, dxn), jnp.asarray(scale),
        jnp.asarray(bias))
    cts = vjp((jnp.asarray(g, y.dtype), jnp.zeros_like(mean),
               jnp.zeros_like(var)))
    got = row3_emulated(*args, grid=7)
    if rate:
        dt = args[1].dtype
        block = _pick_block(N_PAD, c, jnp.dtype(y.dtype).itemsize)
        assert block == te.pick_block(N_PAD, c, dt.itemsize)
        bits = np.concatenate([np.asarray(_hash_bits((block, c), SEED + i, 0))
                               for i in range(N_PAD // block)])
        np.testing.assert_array_equal(got[4].numpy(),
                                      bits >= _dropout_thresh(rate))
    for name, a, want, dt in (("dx", got[0], cts[0], dx),
                              ("dx_new", got[1], cts[1], dxn),
                              ("dscale", got[2], cts[2], "float32"),
                              ("dbias", got[3], cts[3], "float32")):
        tol = 2e-2 if "bfloat16" in (dt, dx) else 1e-4
        want = torch.from_numpy(np.array(want, np.float32))
        assert a.dtype == getattr(torch, dt), name
        err = (a.float() - want).abs().max() / want.abs().max()
        assert err <= tol, (name, err.item())


@pytest.mark.parametrize("n,c,dtype,held", [
    (12032, 256, torch.bfloat16, True), (12032, 256, torch.float32, True),
    (40000, 256, torch.bfloat16, False), (20000, 256, torch.float32, False),
    (1000, 96, torch.bfloat16, True), (3000, 50, torch.bfloat16, True)])
def test_row3_branch_by_size(n, c, dtype, held):
    """On the H100's 132 SMs, one block a SM holds its rows' g1 and xr
    tiles (and the row lanes' partials) in at most 227 KB at the
    flagship's 12,032 rows in both dtypes; 40,000 rows in bf16 and 20,000
    in f32 take the re-read branch (the card tests' sizes)."""
    v, lanes, rows, grid = _layout(n, c, dtype, 132)
    isz = torch.tensor([], dtype=dtype).element_size()
    smem = lanes * 2 * c * 4 + 2 * rows * c * isz
    assert (smem <= SMEM_MAX) == held
    assert grid * rows >= n > (grid - 1) * rows and lanes * (c // v) <= THREADS


# ---------------------------------------------------------- the projection
SMS = 132                      # the H100's SMs
BM, BN = 128, 256              # the kernel's tile (fwd::BM, fwd::BN)


def _plan(n, hc):
    """(column tiles per weight, tiles, grid) of the three-weight walk."""
    tpm = -(-hc // BN)
    tiles = -(-n // BM) * 3 * tpm
    return tpm, tiles, min(tiles, SMS)


def _tile(tpm, tile_id):
    """(row tile, weight, first column) of the walk with qw: a row tile's
    ids with the weights rotated by its index (``fwd::tile_of``)."""
    tm, j = divmod(tile_id, 3 * tpm)
    j = (j + tm * tpm) % (3 * tpm)
    return tm, j // tpm, (j % tpm) * BN


def _writes(c):
    """The q epilogue's qw writes in one tile: (row, local head, first
    column) of each 2-column store, as ``fwd::qw_epilogue`` maps warp w
    (rows 16w … 16w + 15) and lane l (rows l/4 and l/4 + 8, columns 2·(l %
    4) and + 1, stored by the lanes with l % 4 < 2)."""
    out = []
    for lh in range(BN // c):
        for warp in range(8):
            for lane in range(32):
                kq = 2 * (lane % 4)
                if kq < 4:
                    out += [(16 * warp + lane // 4 + 8 * h, lh, kq)
                            for h in range(2)]
    return out


@pytest.mark.parametrize("n,heads,c", [(12032, 4, 256), (12000, 4, 256),
                                       (500, 4, 64), (300, 2, 128),
                                       (384, 3, 16), (777, 6, 32)])
def test_projection_walk_writes_qw_once(n, heads, c):
    """Every q|k|v tile once over the persistent blocks, the q tiles spread
    over them (no block takes more than one more q tile than another);
    each (row, head, d) of qw written once, by a q tile's epilogue; k and v
    tiles write no qw."""
    hc = heads * c
    tpm, tiles, grid = _plan(n, hc)
    walked = sorted(i for b in range(grid) for i in range(b, tiles, grid))
    assert walked == list(range(tiles))
    assert sorted({_tile(tpm, i) for i in range(tiles)}) == sorted(
        (tm, m, col * BN) for tm in range(-(-n // BM)) for m in range(3)
        for col in range(tpm))
    q_tiles = [sum(_tile(tpm, i)[1] == 0 for i in range(b, tiles, grid))
               for b in range(grid)]
    if tiles >= 3 * grid:
        assert max(q_tiles) - min(q_tiles) <= 1
    writes = _writes(c)
    qw = np.zeros((-(-n // BM) * BM, 4 * heads), np.int32)
    for i in range(tiles):
        tm, m, col0 = _tile(tpm, i)
        if m != 0:
            continue
        for r, lh, kq in writes:
            head = col0 // c + lh
            if (head + 1) * c <= hc and tm * BM + r < n:
                qw[tm * BM + r, 4 * head + kq:4 * head + kq + 2] += 1
    assert (qw[:n] == 1).all() and (qw[n:] == 0).all()


def _fma_sum(q, w):
    """Σ_j q[:, j]·w[j] in column order as f32 fused multiply-adds (the
    exact products emulated in f64): [rows, 4]."""
    s = torch.zeros(q.shape[0], 4)
    for j in range(q.shape[1]):
        s = (s.double() + q[:, j].double()[:, None] * w[j].double()[None, :]
             ).float()
    return s


def _qw_chain(q, wblk, heads):
    """qw as ``qw_kernel`` sums it (f32, or C not dividing the tile): one
    chain over a head's columns in ascending order."""
    c = q.shape[1] // heads
    qw = torch.empty(q.shape[0], 4 * heads)
    for h in range(heads):
        cols = slice(h * c, (h + 1) * c)
        qw[:, 4 * h:4 * h + 4] = _fma_sum(q[:, cols], wblk[cols, 4 * h:4 * h + 4])
    return qw.to(q.dtype)


def _tiled_projection(x, ws, bs, wblk, heads):
    """qkv tile by tile (f32 accumulate, the bias added in f32, one
    rounding) and qw: in bf16 with C a multiple of 16 dividing the tile
    from each rounded q tile as the epilogue sums it (16-column chunks in
    order, each chunk's sum exact as the tensor core forms it, then into an
    f32 accumulator; one rounding), else as ``qw_kernel`` does."""
    n, hc = x.shape[0], ws[0].shape[1]
    c = hc // heads
    dt = x.dtype
    tpm, tiles, _ = _plan(n, hc)
    qkv = torch.full((n, 3 * hc), float("nan"), dtype=dt)
    qw = torch.full((n, 4 * heads), float("nan"), dtype=dt)
    epilogue = dt == torch.bfloat16 and BN % c == 0 and c % 16 == 0
    for i in range(tiles):
        tm, m, col0 = _tile(tpm, i)
        rows = slice(tm * BM, min(n, (tm + 1) * BM))
        cols = slice(col0, min(hc, col0 + BN))
        acc = x[rows].float() @ ws[m][:, cols].float() + bs[m][cols].float()
        qkv[rows, m * hc + cols.start:m * hc + cols.stop] = acc.to(dt)
        if m != 0 or not epilogue:
            continue
        for head in range(col0 // c, min(heads, (col0 + BN) // c)):
            acc = torch.zeros(rows.stop - rows.start, 4)
            for k0 in range(head * c, (head + 1) * c, 16):   # an mma a chunk
                cs = slice(k0, k0 + 16)
                acc = (acc.double() + qkv[rows, cs].double()
                       @ wblk[cs, 4 * head:4 * head + 4].double()).float()
            qw[rows, 4 * head:4 * head + 4] = acc.to(dt)
    if not epilogue:
        qw = _qw_chain(qkv[:, :hc], wblk, heads)
    return qkv, qw


def _weights(rng, f, heads, c):
    hc = heads * c
    ws = [(rng.normal(size=(f, hc)) * f ** -0.5).astype(np.float32)
          for _ in range(3)]
    bs = [(0.1 * rng.normal(size=hc)).astype(np.float32) for _ in range(3)]
    w_e = (rng.normal(size=(4, heads, c)) * 0.5).astype(np.float32)
    wblk = (np.eye(heads, dtype=np.float32)[:, None, :, None]
            * np.transpose(w_e, (1, 2, 0))[:, :, None, :]
            ).reshape(hc, heads * 4)
    return ws, bs, wblk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads,c,f", [(2, 16, 32), (2, 128, 24),
                                       (1, 256, 16), (3, 40, 16)])
def test_tiled_projection_matches_plain(heads, c, f, dtype):
    """The tile-by-tile qkv and qw (the epilogue's, or ``qw_kernel``'s for
    f32 and for C 40, which does not divide the tile) against
    ``transformer_project_plain`` (f32 1e-5 of each output's max; bf16 two
    ulps, a rounding of q or qw may flip)."""
    n = 300
    rng = np.random.default_rng(13)
    x = rng.normal(size=(n, f)).astype(np.float32)
    ws, bs, wblk = _weights(rng, f, heads, c)
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    args = (t(x), *map(t, ws), *map(t, bs), t(wblk))
    qkv, qw = _tiled_projection(t(x), [t(w) for w in ws], [t(b) for b in bs],
                                t(wblk), heads)
    assert not torch.isnan(qkv).any() and not torch.isnan(qw).any()
    ref_qkv, ref_qw = tk.transformer_project_plain(*args)
    got_qkv, got_qw = tk.transformer_project(*args)   # the CPU: plain
    assert torch.equal(got_qkv, ref_qkv) and torch.equal(got_qw, ref_qw)
    _close(qkv, ref_qkv, dtype)
    _close(qw, (qkv[:, :heads * c].float() @ t(wblk).float()).to(dtype), dtype)


@pytest.fixture(scope="module")
def geo_band(tmp_path_factory):
    """(JAX band, port band) of the Transformer's geo form on a 336-cell
    box case (48 padding rows), tile 128."""
    path = tmp_path_factory.mktemp("project_walk") / "case"
    generate_box_case(path, 24, 14, 1)
    g = load_graph(path, "Transformer")
    args = (g.senders.numpy()[: g.n_edges], g.receivers.numpy()[: g.n_edges],
            g.n_pad, g.node_mask.numpy(), g.in_degree.numpy())
    kw = dict(tile=128, components=LAYER_COMPONENTS["Transformer"],
              edge_feat=g.edge_feat.numpy()[: g.n_edges],
              node_pos=g.node_feat.numpy())
    return jax_build_band(*args, **kw), build_band(*args, **kw)


def test_tiled_projection_matches_jax_projgrad(geo_band):
    """f32: the tile-by-tile qkv and qw, then row 9's geo-mean attention,
    within 1e-5 of the JAX package's ``banded_transformer_geo_mean_projgrad``
    forward (interpret mode) and of the port's op on the CPU; s held by
    column group (the direction columns cancel terms of
    max|pos|·max(1/dist))."""
    jb, pb = geo_band
    heads, c, f = 2, 32, 24
    n = pb.bias_noself.shape[0] * 128
    rng = np.random.default_rng(14)
    x = rng.normal(size=(n, f)).astype(np.float32)
    ws, bs, wblk = _weights(rng, f, heads, c)
    t = torch.from_numpy
    qkv, qw = _tiled_projection(t(x), [t(w) for w in ws], [t(b) for b in bs],
                                t(wblk), heads)
    hc = heads * c
    got = tk.banded_transformer_fwd_plain(
        pb.bias_noself, qkv[:, :hc], qkv[:, hc:2 * hc], qkv[:, 2 * hc:],
        heads, qw=qw, geo=pb.geo, pos=pb.pos, mean_heads=True)
    port = tk.banded_transformer_geo_mean_projgrad(
        pb.bias_noself, pb.geo, pb.pos, t(x), *map(t, ws), *map(t, bs),
        t(wblk), heads)
    jax_out = jk.banded_transformer_geo_mean_projgrad(
        jnp.asarray(jb.bias_noself), jnp.asarray(jb.geo), jnp.asarray(jb.pos),
        jnp.asarray(x), *map(jnp.asarray, ws), *map(jnp.asarray, bs),
        jnp.asarray(wblk), heads)
    cancel = pb.pos.abs().max().item() * pb.geo[:, 1].max().item()
    for want in (port, [t(np.array(a, np.float32)) for a in jax_out]):
        out, s = got
        assert (out - want[0]).abs().max() <= 1e-5 * want[0].abs().max()
        d = (s - want[1]).abs().view(n, heads, 4)
        r = want[1].abs().view(n, heads, 4)
        assert d[..., :3].max() <= 1e-5 * r[..., :3].max() + 1e-6 * cancel
        assert d[..., 3].max() <= 1e-5 * r[..., 3].max()
