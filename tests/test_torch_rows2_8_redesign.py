"""Rows 2 and 8 as redesigned for the H100, emulated on the CPU, and the
two repaired trainer faults.

* row 2 (``fused_epilogue_fwd``, ``csrc/epilogue_fwd.cu``): one cooperative
  launch of persistent blocks, each a contiguous range of rows.  A thread
  keeps 4 columns (or one, when C is not a multiple of 4), forms xr =
  round(x + x_new) once and sums xr and xr² over its rows r0 + ty, r0 + ty
  + lanes, … below n_valid in order; the block adds its row lanes in order
  into one partial; after a grid-wide barrier one warp a column pair folds
  the partials in block order (lane l the blocks l, l + 32, … eight at a
  time, then a butterfly); the keep bits are drawn while a second barrier
  publishes the statistics; then y = dropout(relu(round(round(round(xr −
  m̃)·a) + b̃))) from the held tile, or from xr read back with the bits
  drawn there.  The emulation does exactly that in
  torch f32 (rsqrt correctly rounded, as ``__frsqrt_rn``) and is held
  against ``fused_epilogue_fwd_plain`` (f32: 1e-5 of each output's max, the
  summation order; bf16: two bf16 ulps) and against the JAX package's
  ``fused_epilogue`` in interpret mode (the tolerances of
  ``test_torch_epilogue.py``) on the same numpy inputs: rates 0 and 0.1,
  f32, bf16 and mixed, pad rows, the keep mask bit-identical to the JAX
  stream;
* row 8 (``banded_spmm_fwd``, ``csrc/banded_spmm.cu``): each warp's list of
  (coefficient, sender) built chunk by chunk from four ballots and their
  counts below the lane, walked in batches with a tail; the list is the
  row's nonzeros in ascending window column, the order of the kernel's
  first design (rounds of 32 columns, a ballot, set bits in order), so
  both give the same bits (one fmaf chain a column, emulated in f64 and rounded to f32);
  held against ``banded_spmm_plain`` and the JAX ``banded_spmm_fwd``
  (interpret mode) at W 3 and W 5, f32 and bf16 planes, with boundary
  tiles, empty rows and rows denser than one batch and than one chunk;
* the trainer: ``KeyboardInterrupt`` in epoch 2 leaves ``epoch_1`` with
  ``interrupted: True`` and the history, and ``resume`` finishes the run;
  a checkpoint whose meta says ``remat: true`` serves.

The CUDA kernels themselves are held against the plain versions on the card
by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.graph.band import build_band as jax_build_band
from gnn_bfs_rans_tpu.kernels.banded import _dropout_thresh, _hash_bits
from gnn_bfs_rans_tpu.kernels.banded import banded_spmm_fwd as jax_spmm
from gnn_bfs_rans_tpu.kernels.epilogue import _pick_block
from gnn_bfs_rans_tpu.kernels.epilogue import fused_epilogue as jax_epilogue
from gnn_bfs_rans_tpu_torch.foam import drifting_box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import build_band
from gnn_bfs_rans_tpu_torch.infer import Predictor
from gnn_bfs_rans_tpu_torch.kernels import banded as tk
from gnn_bfs_rans_tpu_torch.kernels import epilogue as te
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.train import loop as tl
from gnn_bfs_rans_tpu_torch.train.checkpoint import load_checkpoint
from gnn_bfs_rans_tpu_torch.train.data import load_dataset
from gnn_bfs_rans_tpu_torch.train.trainer import Trainer

# ------------------------------------------------------------------ row 2
THREADS, FOLD, SMEM_MAX = 512, 8, 232448   # the kernel's constants
N_PAD, N_VALID, SEED = 1000, 937, 4321
MODES = {"float32": ("float32", "float32"),
         "bfloat16": ("bfloat16", "bfloat16"),
         "mixed": ("float32", "bfloat16")}
BF16_ULPS = 2.0 ** -7     # two bf16 ulps of an output's largest value


def _row2_inputs(mode, c, seed=2):
    """numpy inputs and the torch tensors the wrapper takes."""
    dx, dxn = MODES[mode]
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N_PAD, c)) + rng.normal(size=c)).astype(np.float32)
    xn = rng.normal(size=(N_PAD, c)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    args = (torch.from_numpy(x).to(getattr(torch, dx)),
            torch.from_numpy(xn).to(getattr(torch, dxn)),
            torch.from_numpy(scale), torch.from_numpy(bias))
    return (x, xn, scale, bias), args


def _layout(n, c, grid):
    """(V, row lanes, rows a block, blocks) as ``epilogue_fwd_launch`` (and
    ``coop::partition``) set them for ``grid`` blocks at most."""
    v = 4 if c % 4 == 0 else 1
    lanes = THREADS // (c // v)
    grid = min(grid, -(-n // lanes))
    rows = -(-n // grid)
    return v, lanes, rows, -(-n // rows)


def _rnd(t, dt):
    return t.to(dt).float()


def _butterfly(vals):
    """Lane 0's value after the kernel's xor butterfly over 32 lanes."""
    for o in (16, 8, 4, 2, 1):
        vals = [vals[lane] + vals[lane ^ o] for lane in range(32)]
    return vals[0]


def _keep(seed, n, c, dt, rate):
    return te._epilogue_keep(seed, n, c, te.pick_block(n, c, dt.itemsize),
                             rate, "cpu")


def row2_emulated(x, xn, scale, bias, n_valid, eps, rate, seed, grid,
                  held=True):
    """(y, mean, var, xr, vec, keep) in the kernel's order of work over
    ``grid`` blocks; ``held``: y from the tile kept in shared memory and
    the keep bits drawn between the two barriers, else from xr read back
    and the bits drawn there."""
    dt = torch.promote_types(x.dtype, xn.dtype)
    n, c = x.shape
    _, lanes, rows, grid = _layout(n, c, grid)
    xr = _rnd(x.float() + xn.float(), dt)             # phase 1
    real = (torch.arange(n) < n_valid)[:, None]
    v1 = torch.where(real, xr, torch.zeros(()))
    v2 = torch.where(real, xr * xr, torch.zeros(()))
    part = torch.zeros(grid, 2, c)
    for b in range(grid):
        r0, r1 = b * rows, min(n, (b + 1) * rows)
        k = -(-(r1 - r0) // lanes)
        blk = torch.zeros(k * lanes, 2, c)
        blk[: r1 - r0, 0] = v1[r0:r1]
        blk[: r1 - r0, 1] = v2[r0:r1]
        blk = blk.view(k, lanes, 2, c)
        s = torch.zeros(lanes, 2, c)
        for i in range(k):          # each thread's rows in ascending order
            s = s + blk[i]
        p = torch.zeros(2, c)
        for lane in range(lanes):   # the block's row lanes in order
            p = p + s[lane]
        part[b] = p
    lane_sums = []                  # lane l folds blocks l, l + 32, …
    for lane in range(32):
        s = torch.zeros(2, c)
        for b0 in range(0, grid, 32 * FOLD):
            for i in range(FOLD):
                b = b0 + 32 * i + lane
                s = s + (part[b] if b < grid else torch.zeros(2, c))
        lane_sums.append(s)
    tot = _butterfly(lane_sums)
    nf = torch.full((c,), float(n_valid))
    mean = tot[0] / nf
    var = torch.clamp_min(tot[1] / nf - mean * mean, 0.0)
    # __frsqrt_rn: rsqrt rounded once (f64 holds the exact value closely)
    inv = (1.0 / torch.sqrt((var + eps).double())).float()
    a = scale * inv
    m_lo = _rnd(mean, dt)
    bt = bias + (m_lo - mean) * a
    keep = torch.ones(n, c, dtype=torch.bool)
    if rate > 0:                    # phase 3 (held) or phase 4: one hash
        keep = _keep(seed.long(), n, c, dt, rate)
    tile = xr if held else _rnd(xr, dt)              # phase 4
    y = _rnd(tile - _rnd(m_lo, dt), dt)
    y = _rnd(y * _rnd(a, dt), dt)
    y = _rnd(y + _rnd(bt, dt), dt)
    y = torch.where(y > 0, y, torch.zeros(()))
    if rate > 0:
        y = torch.where(keep, _rnd(y * te.drop_scale(rate, dt), dt),
                        torch.zeros(()))
    vec = torch.stack([m_lo, a, bt, inv])
    return y.to(dt), mean, var, xr.to(dt), vec, keep


def _close(got, want, dtype):
    tol = 1e-5 if dtype == torch.float32 else BF16_ULPS
    want = want.float()
    assert (got.float() - want).abs().max() <= tol * want.abs().max()


ROW2 = [(mode, rate, c) for mode in MODES for rate in (0.0, 0.1)
        for c in (64, 50)]


@pytest.mark.parametrize("mode,rate,c", ROW2,
                         ids=[f"{m}-rate{r}-c{c}" for m, r, c in ROW2])
def test_row2_order_matches_plain(mode, rate, c):
    """The emulated launch over 6 blocks (held), 11 and 40 (read back)
    against the plain version: f32 summation order, bf16 two ulps; held and
    read back give the same bits; the dropped elements are zero on both
    sides (rate 0.1)."""
    _, args = _row2_inputs(mode, c)
    seed = torch.tensor([SEED], dtype=torch.int32) if rate else None
    ref_y, ref_m, ref_v, ref_xr, ref_vec = te._forward_plain(
        *args, N_VALID, 1e-5, rate, seed)
    outs = {}
    for grid, held in ((6, True), (11, False), (11, True), (40, False)):
        outs[grid, held] = got = row2_emulated(*args, N_VALID, 1e-5, rate,
                                               seed, grid, held)
        y, mean, var, xr, vec, _ = got
        assert y.dtype == ref_y.dtype == xr.dtype
        assert torch.equal(xr, ref_xr)   # one rounding of x + x_new
        _close(y, ref_y, y.dtype)
        torch.testing.assert_close(mean, ref_m, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(var, ref_v, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(vec, ref_vec, rtol=1e-5, atol=1e-6)
    for a, b in zip(outs[11, False], outs[11, True]):
        assert torch.equal(a, b)         # held or read back: the same bits
    if rate:
        keep = outs[6, True][5]
        assert 0 < (~keep).sum() < keep.numel()
        assert not ref_y[~keep].any() and not outs[6, True][0][~keep].any()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_row2_order_matches_jax(mode, rate):
    """The emulated launch against the JAX package's ``fused_epilogue``
    (interpret mode) on the same numpy inputs, pad rows included; its keep
    mask is the JAX interpret-mode stream bit for bit."""
    c = 64
    dx, dxn = MODES[mode]
    (x, xn, scale, bias), args = _row2_inputs(mode, c, seed=8)
    seed_j = jnp.array([SEED], jnp.int32) if rate else None
    y_ref, m_ref, v_ref = jax_epilogue(
        jnp.asarray(x, dx), jnp.asarray(xn, dxn), jnp.asarray(scale),
        jnp.asarray(bias), seed_j, N_VALID, rate, 1e-5)
    seed = torch.tensor([SEED], dtype=torch.int32) if rate else None
    y, mean, var, _, _, keep = row2_emulated(*args, N_VALID, 1e-5, rate,
                                             seed, grid=7)
    if rate:
        block = _pick_block(N_PAD, c, jnp.dtype(y_ref.dtype).itemsize)
        assert block == te.pick_block(N_PAD, c, y.dtype.itemsize)
        bits = np.concatenate([np.asarray(_hash_bits((block, c), SEED + i, 0))
                               for i in range(N_PAD // block)])
        np.testing.assert_array_equal(keep.numpy(),
                                      bits >= _dropout_thresh(rate))
    y_ref = np.asarray(y_ref, np.float32)
    if mode == "bfloat16":
        # test_torch_epilogue.py's limits: interpret mode keeps the bf16
        # add and affine in f32
        np.testing.assert_allclose(y.float().numpy(), y_ref, rtol=5e-2,
                                   atol=5e-2)
        np.testing.assert_allclose(mean.numpy(), np.asarray(m_ref), atol=2e-3)
        np.testing.assert_allclose(var.numpy(), np.asarray(v_ref), rtol=1e-2)
    else:
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mean.numpy(), np.asarray(m_ref), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(var.numpy(), np.asarray(v_ref), rtol=1e-5)


@pytest.mark.parametrize("n,c,dtype,held", [
    (12032, 256, torch.bfloat16, True), (12032, 256, torch.float32, True),
    (1024, 256, torch.bfloat16, True), (49000, 256, torch.bfloat16, True),
    (60000, 256, torch.bfloat16, False), (30000, 256, torch.float32, False),
    (1000, 96, torch.bfloat16, True), (3000, 50, torch.float32, True)])
def test_row2_branch_by_size(n, c, dtype, held):
    """On the H100's 132 SMs one block a SM holds its rows' xr tile, their
    keep bits (a byte a row and thread) and the row lanes' partials in at
    most 227 KB up to ~49,000 bf16 rows (~26,000 f32) at C 256; above, phase
    3 reads xr back (the card tests' sizes)."""
    v, lanes, rows, grid = _layout(n, c, 132)
    isz = torch.tensor([], dtype=dtype).element_size()
    smem = max(2 * lanes, 3) * c * 4 + rows * c * isz + rows * (c // v)
    assert (smem <= SMEM_MAX) == held
    assert grid * rows >= n > (grid - 1) * rows and lanes * (c // v) <= THREADS


# ------------------------------------------------------------------ row 8
CHUNKS = 3                 # the kernel's chunks a round
BATCH = {torch.float32: 2, torch.bfloat16: 4}   # 64 bytes of x a lane


def _chunk_coefs(a, row, q, groups):
    """(k, [32, 4] coefficients of lane l at columns 128·g + 4l + b, zero
    past the tile or outside the window's tiles) of chunk q of ``row``."""
    n_tiles, window, tile, _ = a.shape
    t, i = divmod(row, tile)
    k, g = divmod(q, groups)
    out = np.zeros((32, 4), np.float32)
    if 0 <= t - window // 2 + k < n_tiles:
        cols = 128 * g + 4 * np.arange(32)[:, None] + np.arange(4)[None, :]
        ok = cols < tile
        out[ok] = a[t, k, i, cols[ok]]
    return k, out


def row8_lists(a):
    """Each row's list as the kernel builds it: rounds of CHUNKS chunks,
    each chunk's nonzeros placed at (count so far) + (the lane's nonzeros
    below it: the four ballots' counts) + (its own earlier columns)."""
    n_tiles, window, tile, _ = a.shape
    groups = -(-tile // 128)
    n_chunks = window * groups
    lists = []
    for row in range(n_tiles * tile):
        t = row // tile
        entries = []
        for q0 in range(0, n_chunks, CHUNKS):
            lst = {}
            cnt = 0
            for q in range(q0, min(q0 + CHUNKS, n_chunks)):
                k, c4 = _chunk_coefs(a, row, q, groups)
                nz = c4 != 0
                ballots = [sum(1 << lane for lane in range(32) if nz[lane, b])
                           for b in range(4)]
                sender0 = (t - window // 2 + k) * tile + 128 * (q % groups)
                for lane in range(32):
                    below = (1 << lane) - 1
                    pos = cnt + sum(bin(bal & below).count("1")
                                    for bal in ballots)
                    for b in range(4):
                        if nz[lane, b]:
                            assert pos not in lst
                            lst[pos] = (float(c4[lane, b]),
                                        sender0 + 4 * lane + b)
                            pos += 1
                cnt += int(nz.sum())
            assert sorted(lst) == list(range(cnt))   # dense, no collision
            entries += [lst[p] for p in range(cnt)]
        lists.append(entries)
    return lists


def first_design_lists(a):
    """Each row's products in the kernel's first design's order: window
    blocks in order (out-of-range tiles skipped), rounds of 32 columns,
    each round's ballot's set bits in ascending order."""
    n_tiles, window, tile, _ = a.shape
    lists = []
    for row in range(n_tiles * tile):
        t, i = divmod(row, tile)
        entries = []
        for k in range(window):
            st = t - window // 2 + k
            if not 0 <= st < n_tiles:
                continue
            for base in range(0, tile, 32):
                for j in range(base, min(base + 32, tile)):
                    if a[t, k, i, j] != 0:
                        entries.append((float(a[t, k, i, j]), st * tile + j))
        lists.append(entries)
    return lists


def walk(lists, x, batch):
    """out [N, F]: each row's fmaf chain over its list in batches of
    ``batch`` (a tail batch at the end), from 0, in f32 (fmaf emulated in
    f64: the product of two f32 values is exact there)."""
    xf = x.float().double()
    acc = torch.zeros(x.shape, dtype=torch.float32)
    order = []
    for row, entries in enumerate(lists):
        seen = []
        for e0 in range(0, len(entries), batch):
            seen += entries[e0:e0 + batch]   # the batch's loads, then its adds
        assert seen == entries
        order.append(seen)
    longest = max(map(len, order), default=0)
    for e in range(longest):
        rows = [r for r, ent in enumerate(order) if len(ent) > e]
        coef = torch.tensor([order[r][e][0] for r in rows], dtype=torch.float64)
        src = torch.tensor([order[r][e][1] for r in rows])
        acc[rows] = (coef[:, None] * xf[src] + acc[rows].double()).float()
    return acc.to(x.dtype)


def _spmm_bands(n, tile, width, seed=0):
    """(JAX, port) bands of random symmetric edges |s − r| < width with a
    few padding rows (empty), built from the same edges."""
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(n, 1)
    keep = (((j - i) < width) & (rng.random(i.size) < 0.08)) | ((j - i) == 1)
    s = np.concatenate([i[keep], j[keep]]).astype(np.int32)
    r = np.concatenate([j[keep], i[keep]]).astype(np.int32)
    mask = np.arange(n) < n - 5
    keep = mask[s] & mask[r]
    s, r = s[keep], r[keep]
    order = np.lexsort((s, r))
    args = (s[order], r[order], n, mask,
            np.bincount(r, minlength=n).astype(np.float32))
    kw = dict(tile=tile, components=("adj", "gcn"))
    return jax_build_band(*args, **kw), build_band(*args, **kw)


# tile 32: edges narrower than a tile give W 3, up to 60 apart W 5
SPMM = [(window, plane, dt) for window in (3, 5) for plane in ("gcn", "adj")
        for dt in ("float32", "bfloat16")]
SPMM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # test_torch_spmm.py's


@pytest.mark.parametrize("window,plane,dtype", SPMM,
                         ids=[f"w{w}-{p}-{d}" for w, p, d in SPMM])
def test_row8_lists_and_batches_match_plain_and_jax(window, plane, dtype):
    """The compaction and batched walk on a W 3 / W 5 band whose rows
    include boundary tiles, empty padding rows, a row denser than one
    batch and one denser than a chunk (all 4·32 columns of a window
    block): the lists equal the first design's order, the outputs its
    bits, and both the plain version and the JAX kernel within their
    tolerances."""
    n, tile = 192, 32
    jb, tb = _spmm_bands(n, tile, {3: 14, 5: 60}[window])
    a = getattr(tb, plane).clone()
    assert a.shape == (n // tile, window, tile, tile)
    a[2, window // 2, 7, :] = 0.5          # a dense row: 32 in one block
    a[3, :, 11, :] = -0.25                 # nonzeros in every window block
    a[0, : window // 2, 3, :] = 0          # boundary tile (kept empty)
    a[-1, window // 2 + 1:, 9, :] = 0
    an = a.float().numpy()
    lists = row8_lists(an)
    assert lists == first_design_lists(an)
    assert max(map(len, lists)) > 2 * BATCH[torch.bfloat16]
    assert all(len(lists[r]) == 0 for r in range(n - 5, n))   # padding rows
    rng = np.random.default_rng(window)
    x = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32)).to(
        getattr(torch, dtype))
    out = walk(lists, x, BATCH[x.dtype])
    # the first design's bits
    assert torch.equal(out, walk(first_design_lists(an), x, 1))
    assert torch.equal(out, walk(lists, x, 3))            # any batch size
    want = tk.banded_spmm_plain(a, x)
    tol = SPMM_TOL[dtype]
    assert (out.float() - want.float()).abs().max() <= tol * want.float(
        ).abs().max()
    jx = np.asarray(jax_spmm(jnp.asarray(an if plane == "gcn" else
                                         an.astype(jnp.bfloat16)),
                             jnp.asarray(x.float().numpy(), dtype)),
                    np.float32)
    assert np.abs(out.float().numpy() - jx).max() <= tol * np.abs(jx).max()


@pytest.mark.parametrize("n_pad,resident", [(12032, 3 * 132 * 8),
                                            (30080, 3 * 132 * 8),
                                            (640, 3 * 132 * 8)])
def test_row8_persistent_warps_take_each_row_once(n_pad, resident):
    """The persistent grid (at most one warp a row, as many blocks as the
    SMs hold) walks every row once: warp w of block b takes rows 8b + w,
    8b + w + stride, …"""
    blocks = min(-(-n_pad // 8), resident // 8)
    stride = blocks * 8
    rows = sorted(r for b in range(blocks) for w in range(8)
                  for r in range(8 * b + w, n_pad, stride))
    assert rows == list(range(n_pad))


# ------------------------------------------------------------- the trainer
def _dataset(tmp_path):
    case = tmp_path / "case"
    generate_box_case(case, 16, 8, 1, time_dirs=("100", "200"),
                      time_field_fn=drifting_box_fields)
    return load_dataset(case, ["100", "200"], with_band=True,
                        band_components=("gcn",))


CFG = dict(hidden_dim=16, num_layers=2, layer_type="GCN", backend="pallas",
           dropout=0.0)


def test_interrupt_saves_a_checkpoint_and_resume_finishes(tmp_path,
                                                          monkeypatch):
    """A train step that raises KeyboardInterrupt in epoch 2 leaves
    ``epoch_1`` marked interrupted, with the history written, and re-raises;
    ``resume`` continues from it and finishes the run."""
    ds = _dataset(tmp_path)
    out = tmp_path / "run"
    tcfg = tl.TrainConfig(epochs=3, save_every=10, seed=3)
    step = tl.train_step
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == ds.n_snapshots + 1:    # epoch 2's first step
            raise KeyboardInterrupt
        return step(*args, **kwargs)

    monkeypatch.setattr("gnn_bfs_rans_tpu_torch.train.trainer.train_step",
                        flaky)
    trainer = Trainer(ds, ModelConfig(**CFG), tcfg, output_dir=out,
                      log_fn=lambda *_: None, device="cpu")
    with pytest.raises(KeyboardInterrupt):
        trainer.train()
    _, meta = load_checkpoint(out, "epoch_1")
    assert meta["interrupted"] is True and meta["epoch"] == 1
    hist = json.loads((out / "training_history.json").read_text())
    assert hist["epoch"] == [1]
    assert meta["val_loss"] == hist["val_loss"][0]

    monkeypatch.setattr("gnn_bfs_rans_tpu_torch.train.trainer.train_step",
                        step)
    resumed = Trainer(ds, ModelConfig(**CFG), tcfg, output_dir=out,
                      log_fn=lambda *_: None, device="cpu")
    resumed.initialize(resume=True)
    assert resumed.start_epoch == 2
    hist = resumed.train()
    assert hist["epoch"] == [1, 2, 3]
    assert all(np.isfinite(hist["train_loss"]))


def test_interrupt_before_the_first_epoch_saves_epoch_0(tmp_path,
                                                        monkeypatch):
    ds = _dataset(tmp_path)

    def interrupt(*args, **kwargs):
        raise KeyboardInterrupt

    monkeypatch.setattr("gnn_bfs_rans_tpu_torch.train.trainer.train_step",
                        interrupt)
    trainer = Trainer(ds, ModelConfig(**CFG), tl.TrainConfig(epochs=2),
                      output_dir=tmp_path / "run", log_fn=lambda *_: None,
                      device="cpu")
    with pytest.raises(KeyboardInterrupt):
        trainer.train()
    _, meta = load_checkpoint(tmp_path / "run", "epoch_0")
    assert meta["interrupted"] is True and meta["val_loss"] == float("inf")


def test_remat_serves(tmp_path):
    """A checkpoint whose meta says remat: true (as a JAX meta file may)
    parses and serves: the same fields as without it."""
    ds = _dataset(tmp_path)
    out = tmp_path / "run"
    Trainer(ds, ModelConfig(**CFG), tl.TrainConfig(epochs=1, save_every=1),
            output_dir=out, log_fn=lambda *_: None, device="cpu").train()
    meta_path = out / "epoch_1.meta.json"
    meta = json.loads(meta_path.read_text())
    plain = Predictor.from_checkpoint(out, "epoch_1", device="cpu")
    meta["model_config"]["remat"] = True
    meta_path.write_text(json.dumps(meta))
    remat = Predictor.from_checkpoint(out, "epoch_1", device="cpu")
    assert remat.model.config.remat
    np.testing.assert_array_equal(remat.predict_packed(ds.graph),
                                  plain.predict_packed(ds.graph))
