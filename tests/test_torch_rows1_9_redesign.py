"""Rows 9 and 1 as redesigned for the H100: the kernels' order of work,
emulated on the CPU.

Both attention kernels (``csrc/banded_transformer.cu::transformer_kernel``,
row 9; ``csrc/banded_gat.cu::gat_attention_kernel``, rows 1 and 4) give one
warp to a receiver row and

* compact its mask row from 4-byte words, 4 flags a lane in groups of 128
  bytes, a warp-wide prefix sum placing each lane's columns (senders in
  ascending window order, none outside [0, n_pad));
* load the chunks of k (row 9) and v or z of U senders and all heads of a
  group before using any (U = IN_FLIGHT / (HG·accesses per head); the last
  batch repeats its last sender and uses only the real ones);
* sum a logit's dot product per lane over the lane's columns of each
  256-column block (column 256·b + 4·lane + 128·g + e) and then across the
  lanes by a butterfly; everything lane-parallel over senders (logits,
  softmax sums, s) per lane in sender order and then across the lanes the
  same way;
* take the value sum in ascending sender order with round(ẽ).

The emulation below does exactly that in torch f32 and is held against the
plain versions (f32: 1e-5 of each output's max, the geo s's direction
columns plus 1e-6 of the size they cancel; bf16: two bf16 ulps of each
output's max, as one rounding of a probability or of the output may flip)
and against the JAX kernels in interpret mode (f32, the same limits), on
the same numpy inputs, with the dropout keep masks bit-identical to the JAX
stream: masks with empty (padding) rows, rows in the first and last tiles,
and rows with more senders than one batch (and than 32 lanes).  The
one-weight walk of ``csrc/gemm_sm90.cuh``'s forward projection (row 1's z)
writes every tile of z once.  The CUDA kernels themselves are held against
the plain versions on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.graph.band import build_band as jax_build_band
from gnn_bfs_rans_tpu.kernels import banded as jk
from gnn_bfs_rans_tpu_torch.foam import generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS, build_band
from gnn_bfs_rans_tpu_torch.infer import load_graph
from gnn_bfs_rans_tpu_torch.kernels import banded as tk
from gnn_bfs_rans_tpu_torch.kernels import dropout as tdrop

# torch's first multi-threaded f32 exp in a process was seen to return
# values 1e-4 off in one thread's chunk (as in the other new test files)
torch.exp(torch.linspace(-10.0, 0.0, 1 << 16))

TILE, SEED, RATE = 16, 23, 0.1
# the kernels' constants
LANES, CB, HG, MAX_WGROUPS = 32, 256, 4, 6
IN_FLIGHT = {"row9": 16, "row1": 8}
# W 3 (Wcols 48) and W 5 (Wcols 80) boxes at tile 16, both with padding rows
BOXES = {3: (20, 13), 5: (41, 27)}
BF16_ULPS = 2.0 ** -7     # two bf16 ulps of an output's largest value


def _dense(mask, rows):
    """``mask`` [n_tiles, T, Wcols] with every in-range window column of
    ``rows`` on (more senders than one batch and than 32 lanes)."""
    mask = mask.copy()
    n_tiles, tile, width = mask.shape
    for i in rows:
        t = i // tile
        s = t * tile - (width - tile) // 2 + np.arange(width)
        mask[t, i % tile] = ((s >= 0) & (s < n_tiles * tile)).astype(mask.dtype)
    return mask


@pytest.fixture(scope="module")
def bands(tmp_path_factory):
    """window → dict of (JAX band, port band) pairs at tile 16: the
    Transformer's geo form, its generic edge form (the same edges, random
    features) and the GAT's mask, each with rows 0, 5, 40 and the last real
    row made dense; and the number of real rows."""
    out = {}
    for window, (nx, ny) in BOXES.items():
        path = tmp_path_factory.mktemp(f"rows19_w{window}") / "case"
        generate_box_case(path, nx, ny, 1)
        g = load_graph(path, "Transformer")
        n = -(-g.n_nodes // TILE) * TILE
        args = (g.senders.numpy()[: g.n_edges], g.receivers.numpy()[: g.n_edges],
                n, g.node_mask.numpy()[:n], g.in_degree.numpy()[:n])
        pos = g.node_feat.numpy()[:n]
        feat = np.random.default_rng(window).normal(
            size=(g.n_edges, 4)).astype(np.float32)
        dense = (0, 5, 40, g.n_nodes - 1)
        pairs = {}
        for name, kw in (
                ("geo", dict(components=LAYER_COMPONENTS["Transformer"],
                             edge_feat=g.edge_feat.numpy()[: g.n_edges],
                             node_pos=pos)),
                ("edge", dict(components=LAYER_COMPONENTS["Transformer"],
                              edge_feat=feat, node_pos=pos)),
                ("gat", dict(components=("bias_self",)))):
            jb = jax_build_band(*args, tile=TILE, **kw)
            pb = build_band(*args, tile=TILE, **kw)
            field = "bias_self" if name == "gat" else "bias_noself"
            m = _dense(np.asarray(getattr(jb, field)), dense)
            jb = dataclasses.replace(jb, **{field: m})
            pb = dataclasses.replace(pb, **{field: torch.from_numpy(m.copy())})
            pairs[name] = (jb, pb)
        assert pairs["geo"][1].bias_noself.shape[-1] == window * TILE
        assert pairs["edge"][1].edge is not None
        out[window] = dict(pairs, n_nodes=g.n_nodes)
    return out


# ------------------------------------------------------------ the emulation
def _compact(mask_rows, s0, n_pad):
    """The kernels' compaction of each mask row [n, Wcols]: lane l holds the
    flags of bytes 4·l … 4·l + 3 of each 128-byte group (masked to senders
    in [0, n_pad)), the lanes' counts are scanned (inclusive, warp-wide) to
    place each lane's columns.  Returns (idx [n, Wcols], -1 past cnt; cnt)."""
    n, wcols = mask_rows.shape
    assert wcols % 4 == 0 and wcols <= 128 * MAX_WGROUPS
    s = s0[:, None] + np.arange(wcols)
    on = (mask_rows != 0) & (s >= 0) & (s < n_pad)
    idx = np.full((n, wcols), -1)
    cnt = np.zeros(n, int)
    for g in range(-(-wcols // 128)):
        blk = np.zeros((n, 128), bool)
        w = min(128, wcols - 128 * g)
        blk[:, :w] = on[:, 128 * g:128 * g + w]
        lanes = blk.reshape(n, LANES, 4)
        c = lanes.sum(2)
        incl = np.cumsum(c, 1)                 # the shuffle-up scan
        first = cnt[:, None] + incl - c
        for b in range(4):
            rank = lanes[:, :, :b].sum(2)
            rr, ll = np.nonzero(lanes[:, :, b])
            idx[rr, first[rr, ll] + rank[rr, ll]] = 128 * g + 4 * ll + b
        cnt += incl[:, -1]
    return idx, cnt


def _batches(cnt, u):
    """The senders each batch loads (the tail repeats the last) and how
    many of them it uses."""
    return [([min(k0 + i, cnt - 1) for i in range(u)], min(u, cnt - k0))
            for k0 in range(0, cnt, u)]


def _butterfly(x):
    """Lane 0's value of the warp's xor-butterfly sum over the last axis."""
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., torch.arange(LANES) ^ o]
    return x[..., 0]


def _lane_dot(a, b, v):
    """Σ a·b over the last axis as a warp forms it: in column block k lane
    l sums columns CB·k + V·l + 32·V·g + e in (g, e) order, the lanes by
    butterfly, the blocks in order."""
    c = a.shape[-1]
    blocks, ng = -(-c // CB), CB // (LANES * v)
    prod = torch.nn.functional.pad(a * b, (0, blocks * CB - c))
    prod = prod.reshape(*prod.shape[:-1], blocks, ng, LANES, v)
    part = torch.zeros(prod.shape[:-3] + (LANES,))
    for g in range(ng):
        for e in range(v):
            part = part + prod[..., g, :, e]
    sums = _butterfly(part)                     # [..., blocks]
    out = sums[..., 0]
    for k in range(1, blocks):
        out = out + sums[..., k]
    return out


def _lane_sum(x, cnt_mask):
    """Σ over senders (axis 1) lane-parallel: lane l sums senders l, l + 32,
    … in order, then the lanes by butterfly."""
    x = torch.where(cnt_mask.reshape(cnt_mask.shape + (1,) * (x.dim() - 2)),
                    x, torch.zeros(()))
    m = -(-x.shape[1] // LANES)
    x = torch.nn.functional.pad(x.movedim(1, -1), (0, m * LANES - x.shape[1]))
    x = x.reshape(*x.shape[:-1], m, LANES)
    part = x[..., 0, :]
    for i in range(1, m):
        part = part + x[..., i, :]
    return _butterfly(part)


def _f32(x):
    return float(np.float32(x))


def _access(dtype, c):
    """Values of one access: 8 (16 bytes) in bf16 when C allows, else 4."""
    return 8 if dtype == torch.bfloat16 and c % 8 == 0 else 4


def _schedule(cnt, kernel, v):
    """Every sender of every row is used once, in ascending order, by the
    batches of U senders (the tail repeating the last without use)."""
    u = IN_FLIGHT[kernel] // (HG * (CB // (LANES * v)))
    for c in cnt:
        used = [s for slots, k in _batches(int(c), u) for s in slots[:k]]
        assert used == list(range(int(c)))
    return u


def _rows(mask):
    n_tiles, tile, width = mask.shape
    rows = np.arange(n_tiles * tile)
    t, r = rows // tile, rows % tile
    return t, r, t * tile - (width - tile) // 2


def _value(ep, vals, srow, valid, heads, c, dt):
    """Σ_k round(ẽ_k)·v_k in ascending sender order, per head [n, H, C]."""
    n, mc = srow.shape
    acc = torch.zeros(n, heads, c)
    for kk in range(mc):
        p = ep[:, kk]
        if dt == torch.bfloat16:
            p = p.to(dt).float()
        p = torch.where(valid[:, kk, None], p, torch.zeros(()))
        acc = acc + p[..., None] * vals[srow[:, kk]].float().reshape(n, heads, c)
    return acc


def _out(acc, inv, heads, mean, dt):
    oh = acc * inv[..., None]
    if not mean:
        return oh.reshape(oh.shape[0], -1).to(dt)
    total = oh[:, 0]
    for h in range(1, heads):
        total = total + oh[:, h]
    return (total * _f32(1.0 / heads)).to(dt)


def row9_emulated(mask, q, k, v, heads, edge=None, qw=None, geo=None,
                  pos=None, mean=False, rate=0.0, seed=SEED):
    """Row 9 in the kernel's order; also returns the keep mask it drew
    ([n, senders, H], False past cnt) and the compacted columns."""
    n_tiles, tile, width = mask.shape
    n, hc = q.shape
    c = hc // heads
    dt = q.dtype
    v_ = _access(dt, c)
    t, r, s0 = _rows(mask)
    idx, cnt = _compact(mask.reshape(n, width).numpy(), s0, n)
    _schedule(cnt, "row9", v_)
    mc = max(int(cnt.max()), 1)
    jj = np.where(idx[:, :mc] >= 0, idx[:, :mc], 0)
    valid = torch.from_numpy(idx[:, :mc] >= 0)
    srow = torch.from_numpy(s0[:, None] + jj)
    scale = _f32(1.0 / c ** 0.5)
    dots = _lane_dot(q.float().reshape(n, 1, heads, c),
                     k.float()[srow].reshape(n, mc, heads, c), 4)
    logit = dots * scale                                   # [n, mc, H]
    tt, rr, jt = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                  (np.broadcast_to(t[:, None], jj.shape),
                   np.broadcast_to(r[:, None], jj.shape), jj))
    if edge is not None:
        d_e = edge.shape[1]
        qe = qw.float().reshape(n, heads, d_e) * float(
            torch.tensor(scale, dtype=dt).float())
        for d in range(d_e):
            logit = logit + qe[:, None, :, d] * edge[tt, d, rr, jt][..., None]
    if geo is not None:
        qd = qw.float().reshape(n, heads, 4) * scale
        pi = pos[torch.arange(n)]                           # [n, 4]
        qself = (qd[..., 0] * pi[:, None, 0] + qd[..., 1] * pi[:, None, 1]
                 + qd[..., 2] * pi[:, None, 2] + qd[..., 3] * pi[:, None, 3])
        pj = pos[srow]                                      # [n, mc, 4]
        qpos = (qd[:, None, :, 0] * pj[..., 0, None]
                + qd[:, None, :, 1] * pj[..., 1, None]
                + qd[:, None, :, 2] * pj[..., 2, None]
                + qd[:, None, :, 3] * pj[..., 3, None])
        dist = geo[tt, 0, rr, jt][..., None]
        invd = geo[tt, 1, rr, jt][..., None]
        logit = logit + (qself[:, None] - qpos) * invd + qd[:, None, :, 3] * dist
    logit = torch.where(valid[..., None], logit, torch.tensor(-float("inf")))
    mx = logit.amax(1, keepdim=True)
    e = torch.where(valid[..., None], torch.exp(logit - mx), torch.zeros(()))
    inv = 1.0 / _lane_sum(e, valid).clamp_min(1e-16)          # [n, H]
    keep = torch.zeros(n, mc, heads, dtype=torch.bool)
    if rate:
        flat = torch.from_numpy(r[:, None] * width + jj)
        for h in range(heads):
            bits = tdrop.hash_bits(torch.from_numpy(seed + t)[:, None], flat, h)
            keep[..., h] = (bits >= tdrop.threshold(rate)) & valid
        e = torch.where(keep, e * tk.inv_keep(rate), torch.zeros(()))
    out = _out(_value(e, v, srow, valid, heads, c, dt), inv, heads, mean, dt)
    if geo is not None:
        ew = e * invd
        t0 = _lane_sum(ew, valid)
        tj = [_lane_sum(ew * pj[..., d, None], valid) for d in range(3)]
        s3 = _lane_sum(e * dist, valid)
        s = torch.stack([(pi[:, None, d] * t0 - tj[d]) * inv for d in range(3)]
                        + [s3 * inv], -1)
        return (out, s.reshape(n, heads * 4)), keep, idx
    if edge is not None:
        s = torch.stack([_lane_sum(e * edge[tt, d, rr, jt][..., None], valid)
                         * inv for d in range(edge.shape[1])], -1)
        return (out, s.reshape(n, -1)), keep, idx
    return (out,), keep, idx


def row1_emulated(mask, z, alphas, heads, slope=0.2, rate=0.0, mean=True,
                  seed=SEED):
    """Rows 1 and 4's attention in the kernel's order (the keep mask and
    compacted columns as for row 9)."""
    n_tiles, tile, width = mask.shape
    n, hc = z.shape
    c = hc // heads
    dt = z.dtype
    v_ = _access(dt, c)
    t, r, s0 = _rows(mask)
    idx, cnt = _compact(mask.reshape(n, width).numpy(), s0, n)
    _schedule(cnt, "row1", v_)
    mc = max(int(cnt.max()), 1)
    jj = np.where(idx[:, :mc] >= 0, idx[:, :mc], 0)
    valid = torch.from_numpy(idx[:, :mc] >= 0)
    srow = torch.from_numpy(s0[:, None] + jj)
    a = alphas[:, None, heads:] + alphas[srow][..., :heads]     # [n, mc, H]
    a = torch.where(a >= 0, a, slope * a)
    a = torch.where(valid[..., None], a, torch.tensor(-float("inf")))
    mx = a.amax(1, keepdim=True)
    e = torch.where(valid[..., None], torch.exp(a - mx), torch.zeros(()))
    inv = 1.0 / _lane_sum(e, valid).clamp_min(1e-16)
    keep = torch.zeros(n, mc, heads, dtype=torch.bool)
    if rate:
        for h in range(heads):
            flat = torch.from_numpy((h * tile + r[:, None]) * width + jj)
            bits = tdrop.hash_bits(torch.from_numpy(seed + t)[:, None], flat)
            keep[..., h] = (bits >= tdrop.threshold(rate)) & valid
        e = torch.where(keep, e * tk.inv_keep(rate), torch.zeros(()))
    return _out(_value(e, z, srow, valid, heads, c, dt), inv, heads, mean,
                dt), keep, idx


# ------------------------------------------------------------------- checks
def _close(got, want, dtype, cancel=None, heads=None):
    """f32: 1e-5 of want's max (a geo s's direction columns: plus 1e-6 of
    the size they cancel); bf16: two bf16 ulps of want's max."""
    got, want = got.float(), want.float()
    if cancel is not None:        # the geo s: direction and dist columns
        g4, w4 = got.view(-1, heads, 4), want.view(-1, heads, 4)
        for part, extra in ((slice(0, 3), 1e-6 * cancel), (slice(3, 4), 0.0)):
            _close_one(g4[..., part], w4[..., part], dtype, extra)
        return
    _close_one(got, want, dtype, 0.0)


def _close_one(got, want, dtype, extra):
    rel = 1e-5 if dtype == torch.float32 else BF16_ULPS
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item() + extra, err


def _cancel(pb):
    return pb.pos.abs().max().item() * pb.geo[:, 1].max().item()


def test_compaction_is_ascending_nonzero_columns(bands):
    """The compaction keeps exactly the in-range nonzero columns of each row,
    in ascending order: empty rows (padding) get none, dense rows all
    in-range ones (fewer in the first and last tiles)."""
    for window in BOXES:
        pb = bands[window]["geo"][1]
        mask = pb.bias_noself.numpy()
        n_tiles, tile, width = mask.shape
        n = n_tiles * tile
        t, r, s0 = _rows(mask)
        idx, cnt = _compact(mask.reshape(n, width), s0, n)
        for i in range(n):
            s = s0[i] + np.arange(width)
            want = np.nonzero((mask[t[i], r[i]] != 0) & (s >= 0) & (s < n))[0]
            assert list(idx[i, :cnt[i]]) == list(want)
            assert (idx[i, cnt[i]:] == -1).all()
        assert (cnt[bands[window]["n_nodes"]:] == 0).all()
        assert cnt.max() > 32 and cnt[0] < width


@pytest.mark.parametrize("cnt", [0, 1, 3, 4, 5, 8, 9, 47])
@pytest.mark.parametrize("u", [1, 2, 4])
def test_batches_use_every_sender_once(cnt, u):
    """The batches' tail repeats the last sender and uses only real ones."""
    batches = _batches(cnt, u)
    assert len(batches) == -(-cnt // u)
    assert [s for slots, k in batches for s in slots[:k]] == list(range(cnt))
    assert all(max(slots) < max(cnt, 1) for slots, _ in batches)


def _row9_inputs(pb, heads, c, d_e, dtype, seed=5):
    n = pb.bias_noself.shape[0] * TILE
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(n, heads * c)).astype(np.float32)
            for _ in range(3)]
    arrs.append(rng.normal(size=(n, heads * d_e)).astype(np.float32))
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs]


ROW9 = [(f, m, rt) for f in ("plain", "edge", "geo") for m in (True, False)
        for rt in (0.0, RATE)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("form,mean,rate", ROW9,
                         ids=[f"{f}-{'mean' if m else 'concat'}-rate{rt}"
                              for f, m, rt in ROW9])
def test_row9_order_matches_plain(bands, form, mean, rate, window, dtype):
    heads, c = (2, 64) if window == 3 else (4, 16)
    jb, pb = bands[window]["edge" if form == "edge" else "geo"]
    _, (q, k, v, qw) = _row9_inputs(pb, heads, c, 4, dtype)
    kw = {}
    if form == "edge":
        kw = dict(edge=pb.edge, qw=qw)
    elif form == "geo":
        kw = dict(geo=pb.geo, pos=pb.pos, qw=qw)
    seed = torch.tensor([SEED], dtype=torch.int32)
    got, _, _ = row9_emulated(pb.bias_noself, q, k, v, heads, mean=mean,
                              rate=rate, **kw)
    want = tk.banded_transformer_fwd_plain(
        pb.bias_noself, q, k, v, heads, mean_heads=mean, dropout_rate=rate,
        seed=seed if rate else None, **kw)
    want = want if isinstance(want, tuple) else (want,)
    assert got[0].dtype == dtype and got[0].shape == want[0].shape
    _close(got[0], want[0], dtype)
    if form == "geo":    # s: f32 from the same inputs in both dtypes
        _close(got[1], want[1], torch.float32, _cancel(pb), heads)
    elif form == "edge":
        _close(got[1], want[1], torch.float32)
    n_nodes = bands[window]["n_nodes"]
    for a in got:        # padding rows have no sender: exactly 0
        assert (a[n_nodes:] == 0).all()


@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("form,mean,rate", ROW9,
                         ids=[f"{f}-{'mean' if m else 'concat'}-rate{rt}"
                              for f, m, rt in ROW9])
def test_row9_order_matches_jax(bands, form, mean, rate, window):
    """f32, against ``banded_transformer_fwd`` (Pallas in interpret mode);
    the keep mask the emulation drew is the JAX stream's, bit for bit."""
    heads, c = (2, 64) if window == 3 else (4, 16)
    jb, pb = bands[window]["edge" if form == "edge" else "geo"]
    (qn, kn, vn, qwn), (q, k, v, qw) = _row9_inputs(pb, heads, c, 4,
                                                    torch.float32)
    kw, jkw = {}, {}
    if form == "edge":
        kw = dict(edge=pb.edge, qw=qw)
        jkw = dict(edge_band=jnp.asarray(jb.edge), qw=jnp.asarray(qwn))
    elif form == "geo":
        kw = dict(geo=pb.geo, pos=pb.pos, qw=qw)
        jkw = dict(geo_band=jnp.asarray(jb.geo), pos=jnp.asarray(jb.pos),
                   qw=jnp.asarray(qwn))
    got, keep, idx = row9_emulated(pb.bias_noself, q, k, v, heads, mean=mean,
                                   rate=rate, **kw)
    want = jk.banded_transformer_fwd(
        jnp.asarray(jb.bias_noself), jnp.asarray(qn), jnp.asarray(kn),
        jnp.asarray(vn), heads, dropout_rate=rate,
        seed=jnp.asarray([SEED], jnp.int32) if rate else None,
        mean_heads=mean, **jkw)
    want = want if isinstance(want, tuple) else (want,)
    want = [torch.from_numpy(np.array(a, np.float32)) for a in want]
    _close(got[0], want[0], torch.float32)
    if form != "plain":
        _close(got[1], want[1], torch.float32,
               _cancel(pb) if form == "geo" else None, heads)
    if rate:
        n_tiles, tile, width = pb.bias_noself.shape
        t, r, _ = _rows(pb.bias_noself.numpy())
        thresh = np.asarray(jk._dropout_thresh(rate))
        for h in range(heads):
            bits = np.stack([np.asarray(jk._dropout_bits(
                (tile, width), jnp.int32(SEED + tt), h)) for tt in range(n_tiles)])
            want_keep = bits[t[:, None], r[:, None], np.maximum(idx, 0)] >= thresh
            mc = keep.shape[1]
            valid = idx[:, :mc] >= 0
            np.testing.assert_array_equal(keep[..., h].numpy(),
                                          want_keep[:, :mc] & valid)


def _row1_inputs(pb, heads, c, f, dtype, seed=7):
    n = pb.bias_self.shape[0] * TILE
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = (rng.normal(size=(f, heads * c)) * f ** -0.5).astype(np.float32)
    alphas = rng.normal(size=(n, 2 * heads)).astype(np.float32)
    return (x, w, alphas), (torch.from_numpy(x).to(dtype),
                            torch.from_numpy(w).to(dtype),
                            torch.from_numpy(alphas))


ROW1 = [(rt, m) for rt in (0.0, RATE) for m in (True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("rate,mean", ROW1,
                         ids=[f"{'eval' if rt == 0 else 'train'}-"
                              f"{'mean' if m else 'concat'}" for rt, m in ROW1])
def test_row1_order_matches_plain(bands, rate, mean, window, dtype):
    """Row 1's eval and training forms (and row 4's concat form, which runs
    the same attention) against the plain versions.  The GAT mask holds
    every row's self loop, padding rows included, so no row is empty."""
    heads, c, f = (4, 32, 32) if window == 3 else (2, 20, 24)
    pb = bands[window]["gat"][1]
    _, (x, w, alphas) = _row1_inputs(pb, heads, c, f, dtype)
    seed = torch.tensor([SEED], dtype=torch.int32) if rate else None
    want, z = tk.banded_gat_mean_fused_plain(pb.bias_self, w, alphas, x, heads,
                                             0.2, rate, seed, emit_z=True)
    got, _, _ = row1_emulated(pb.bias_self, z, alphas, heads, rate=rate,
                              mean=mean)
    if not mean:
        want = tk.banded_gat_plain(pb.bias_self, z, alphas, heads, 0.2, rate,
                                   seed)
    assert got.dtype == dtype and got.shape == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("rate", [0.0, RATE], ids=["eval", "train"])
def test_row1_order_matches_jax(bands, rate, window):
    """f32, against ``banded_gat_mean_fused`` (Pallas in interpret mode)
    with z = x·W; the keep mask is the JAX stream's, bit for bit."""
    heads, c, f = (4, 32, 32) if window == 3 else (2, 20, 24)
    jb, pb = bands[window]["gat"]
    (xn, wn, an), (x, w, alphas) = _row1_inputs(pb, heads, c, f,
                                                torch.float32)
    z = (x @ w).contiguous()
    got, keep, idx = row1_emulated(pb.bias_self, z, alphas, heads, rate=rate)
    want = jk.banded_gat_mean_fused(
        jnp.asarray(jb.bias_self), jnp.asarray(wn), jnp.asarray(an),
        jnp.asarray(xn), heads, 0.2, rate,
        jnp.asarray([SEED], jnp.int32) if rate else None)
    _close(got, torch.from_numpy(np.array(want, np.float32)), torch.float32)
    if rate:
        n_tiles, tile, width = pb.bias_self.shape
        t, r, _ = _rows(pb.bias_self.numpy())
        thresh = np.asarray(jk._dropout_thresh(rate))
        bits = np.stack([np.asarray(jk._dropout_bits(
            (heads * tile, width), jnp.int32(SEED + tt))) for tt in range(n_tiles)])
        mc = keep.shape[1]
        valid = idx[:, :mc] >= 0
        for h in range(heads):
            want_keep = bits[t[:, None], h * tile + r[:, None],
                             np.maximum(idx[:, :mc], 0)] >= thresh
            np.testing.assert_array_equal(keep[..., h].numpy(), want_keep & valid)


# ------------------------------------------- the forward projection's walk
SMS = 132                 # the H100's SMs
BM, BN = 128, 256         # the bf16 kernel's tile (fwd::BM, fwd::BN)


def _walk(n, hc, nw, sms=SMS):
    """(column tiles per weight, tiles, grid) as ``run_proj_fwd_bf16`` sets
    them for nw weights: one block per SM, or per tile if fewer."""
    tpm = -(-hc // BN)
    tiles = -(-n // BM) * nw * tpm
    return tpm, tiles, min(tiles, sms)


def _tile_of(tpm, nw, tile_id):
    """(row tile, weight, first column), column tile fastest, as the kernel
    decodes a tile id (``fwd::tile_of``)."""
    tm, j = divmod(tile_id, nw * tpm)
    return tm, j // tpm, (j % tpm) * BN


@pytest.mark.parametrize("nw", [1, 3])
@pytest.mark.parametrize("n,hc", [(12032, 1024), (12000, 1024), (12032, 64),
                                  (400, 64), (300, 600)])
def test_projection_walk_writes_each_tile_once(n, hc, nw):
    """Block b walks tiles b, b + grid, …: with one weight (row 1's z [N,
    H·C]) or three (row 11's q|k|v), every tile exactly once on at most one
    block per SM, the tiles covering every (row, column) of each weight's
    output once (the flagship z: 94 × 4 = 376 tiles, about 3 waves)."""
    tpm, tiles, grid = _walk(n, hc, nw)
    if (n, hc, nw) == (12032, 1024, 1):
        assert tiles == 376 and grid == SMS
    walked = sorted(i for b in range(grid) for i in range(b, tiles, grid))
    assert walked == list(range(tiles))
    cover = np.zeros((nw, -(-n // BM) * BM, tpm * BN), np.int32)
    for i in range(tiles):
        tm, m, col0 = _tile_of(tpm, nw, i)
        assert 0 <= m < nw and col0 < hc and tm * BM < n
        cover[m, tm * BM:(tm + 1) * BM, col0:col0 + BN] += 1
    assert (cover[:, :n, :hc] == 1).all()


def test_tiled_one_weight_projection_matches_plain(bands):
    """z projected tile by tile from one weight (f32 accumulate, no bias,
    one rounding): every element written, equal to the plain version's z."""
    pb = bands[3]["gat"][1]
    for dtype in (torch.float32, torch.bfloat16):
        _, (x, w, alphas) = _row1_inputs(pb, 4, 32, 32, dtype)
        n, hc = x.shape[0], w.shape[1]
        tpm, tiles, _ = _walk(n, hc, 1)
        z = torch.full((n, hc), float("nan"), dtype=dtype)
        for i in range(tiles):
            tm, _, col0 = _tile_of(tpm, 1, i)
            rows = slice(tm * BM, min(n, (tm + 1) * BM))
            cols = slice(col0, min(hc, col0 + BN))
            z[rows, cols] = (x[rows].float() @ w[:, cols].float()).to(dtype)
        _, want = tk.banded_gat_mean_fused_plain(pb.bias_self, w, alphas, x, 4,
                                                 emit_z=True)
        assert not torch.isnan(z.float()).any()
        # f32: the same dot products, perhaps in another order; bf16: one
        # rounding of each, which such an order change may flip (one ulp)
        a, b = z.float(), want.float()
        if dtype == torch.float32:
            assert (a - b).abs().max() <= 1e-6 * b.abs().max()
        else:
            assert ((a - b).abs() <= 2.0 ** -8 * b.abs()).all()
