"""Port Transformer backward kernels (rows 10, 7, 6's bias form, row 9's
dropout form) and the projgrad op vs the JAX package (CPU).

* the Transformer's dropout masks (one draw per head of the hash stream)
  are bit-identical to the JAX package's ``_hash_bits(…, draw=h)``;
* row 9's plain version at rate 0.3 matches ``banded_transformer_fwd``
  (Pallas in interpret mode) on out and s, every form;
* row 10's plain version matches ``banded_transformer_bwd(...,
  raw_kv_partials=True)``: dq, the dk/dv window partials and dqw, every
  form, with and without the cotangent of s, at rate 0 and 0.3;
* row 7's plain version matches ``fold_partials`` and ``combine_partials``;
  row 6's bias form matches ``fold_project_bwd(with_bias=True)``;
* ``banded_transformer_geo_mean_projgrad``'s gradients match ``jax.vjp`` of
  the JAX op (its partials mode at this H·C) and, on the W 3 band, the
  JAX package's in-kernel projection mode (``project_x=``), which drops
  tail gradients on the W 5 band (ROADMAP Queue 3).

Bands: generated box cases at tile 16 (sub 8), windows of 3 tiles (Wcols
48, 20×12 cells) and 5 tiles (Wcols 80, 40×28 cells); H 2, C 16, F 16.
The CUDA kernels are held against the plain versions on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
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
from gnn_bfs_rans_tpu_torch.kernels import _build
from gnn_bfs_rans_tpu_torch.kernels import banded as tk
from gnn_bfs_rans_tpu_torch.kernels import banded_bwd as tb
from gnn_bfs_rans_tpu_torch.kernels import dropout as td

H, C, F, TILE = 2, 16, 16, 16
SEED, RATE = 17, 0.3
# window in tiles → box case (nx, ny) whose RCM bandwidth gives it at T 16
BOXES = {3: (20, 12), 5: (40, 28)}


@pytest.fixture(scope="module")
def bands(tmp_path_factory):
    """window → {"geo": (JAX band, port band), "edge": (...)}: the geo
    planes of the case's own geometric features, and the generic edge plane
    of random features on the same edges."""
    out = {}
    for window, (nx, ny) in BOXES.items():
        path = tmp_path_factory.mktemp(f"tr_bwd_w{window}") / "case"
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
            jb, pb = jax_build_band(*args, **kw), build_band(*args, **kw)
            assert pb.bias_noself.shape[-1] == window * TILE
            assert (pb.geo is not None) == (form == "geo")
            out[window][form] = (jb, pb)
    return out


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(n, H * C)).astype(np.float32)
               for _ in range(3))
    qw = rng.normal(size=(n, H * 4)).astype(np.float32)
    return q, k, v, qw


def _cond(form, jb, pb, qw, dtype="float32"):
    """Row 9/10 conditioning keywords for (JAX, port)."""
    j = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    if form == "edge":
        return (dict(edge_band=jnp.asarray(jb.edge), qw=j(qw)),
                dict(edge=pb.edge, qw=t(qw)))
    if form == "geo":
        return (dict(geo_band=jnp.asarray(jb.geo), pos=jnp.asarray(jb.pos),
                     qw=j(qw)),
                dict(geo=pb.geo, pos=pb.pos, qw=t(qw)))
    return {}, {}


def _seeds(rate):
    if not rate:
        return None, None
    return (jnp.asarray([SEED], jnp.int32),
            torch.tensor([SEED], dtype=torch.int32))


def _close(got, want, tol, what, floor=0.0):
    """max |got − want| ≤ tol × max(max |want|, floor)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), floor)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} × {scale}"


def _cancel(pb):
    """max|pos|·max(1/dist): the size of the terms the geo form's direction
    columns cancel into O(1) values (s and dqw alike)."""
    return float(pb.pos.abs().max()) * float(pb.geo[:, 1].max())


def test_transformer_masks_match_jax_hash():
    """Bit for bit: hash_bits with a draw index, and transformer_keep's
    [n_tiles, H, T, Wcols] mask (stream seed + t, draw h)."""
    flat = torch.arange(16 * 48).reshape(16, 48)
    for draw in (0, 1, 3):
        for seed in (0, 12345, 2 ** 31 - 9):
            want = np.asarray(jk._hash_bits((16, 48), jnp.int32(seed), draw))
            np.testing.assert_array_equal(
                td.hash_bits(seed, flat, draw).numpy(), want.astype(np.int64))
    keep = td.transformer_keep(torch.tensor([SEED]), 3, 16, 48, H, RATE)
    assert keep.shape == (3, H, 16, 48)
    for t in range(3):
        for h in range(H):
            want = (np.asarray(jk._hash_bits((16, 48), jnp.int32(SEED + t), h))
                    >= np.asarray(jk._dropout_thresh(RATE)))
            np.testing.assert_array_equal(keep[t, h].numpy(), want)


@pytest.mark.parametrize("mean", [True, False], ids=["mean", "concat"])
@pytest.mark.parametrize("form", ["plain", "edge", "geo"])
def test_row9_dropout_plain_matches_jax(bands, form, mean):
    """f32 at rate 0.3: out within 1e-5 of its max (summation order); s by
    column group as in test_torch_transformer.py (the geo direction
    columns plus 1e-6 of their cancellation scale)."""
    jb, pb = bands[3]["edge" if form == "edge" else "geo"]
    n = pb.bias_noself.shape[0] * TILE
    q, k, v, qw = _inputs(n, 5)
    jc, pc = _cond(form, jb, pb, qw)
    js, ps = _seeds(RATE)
    want = jk.banded_transformer_fwd(
        jnp.asarray(jb.bias_noself), *map(jnp.asarray, (q, k, v)), H,
        mean_heads=mean, dropout_rate=RATE, seed=js, **jc)
    got = tk.banded_transformer_fwd(
        pb.bias_noself, *map(torch.from_numpy, (q, k, v)), H, mean_heads=mean,
        dropout_rate=RATE, seed=ps, **pc)
    want, got = ((want, got) if form != "plain" else ((want,), (got,)))
    _close(got[0], want[0], 1e-5, "out")
    # the dropped entries change out: the rate-0 forward differs
    rate0 = tk.banded_transformer_fwd(
        pb.bias_noself, *map(torch.from_numpy, (q, k, v)), H, mean_heads=mean,
        **pc)
    assert not torch.allclose(got[0], rate0[0] if form != "plain" else rate0)
    if form == "plain":
        return
    s, ws = got[1].numpy(), np.asarray(want[1])
    if form == "edge":
        _close(s, ws, 1e-5, "s")
        return
    s4, w4 = s.reshape(n, H, 4), ws.reshape(n, H, 4)
    assert (np.abs(s4[..., :3] - w4[..., :3]).max()
            <= 1e-5 * np.abs(w4[..., :3]).max() + 1e-6 * _cancel(pb))
    _close(s4[..., 3], w4[..., 3], 1e-5, "s dist")


# every form with the head mean and concat; the geo form (FlowGNN's) at
# both rates with and without the cotangent of s, the others at
# (rate 0, no gs) and (rate 0.3, gs); the plain form has no s
ROW10 = ([("geo", m, r, g) for m in (True, False) for r in (0.0, RATE)
          for g in (False, True)]
         + [("edge", m, r, r > 0) for m in (True, False) for r in (0.0, RATE)]
         + [("plain", m, r, False) for m in (True, False)
            for r in (0.0, RATE)])


@pytest.mark.parametrize(
    "form,mean,rate,with_gs", ROW10,
    ids=[f"{f}-{'mean' if m else 'concat'}-rate{r}-{'gs' if g else 'nogs'}"
         for f, m, r, g in ROW10])
def test_row10_plain_matches_jax(bands, form, mean, rate, with_gs):
    """f32, the W 3 band: dq, the dk/dv partials and dqw each within 1e-5
    of their max (summation order; the partials compare exactly as laid
    out), the geo dqw's direction columns plus 1e-6 of the cancellation
    scale, as s's."""
    jb, pb = bands[3]["edge" if form == "edge" else "geo"]
    n = pb.bias_noself.shape[0] * TILE
    q, k, v, qw = _inputs(n, 6)
    rng = np.random.default_rng(7)
    g = rng.normal(size=(n, C if mean else H * C)).astype(np.float32)
    gs = rng.normal(size=(n, H * 4)).astype(np.float32) if with_gs else None
    jc, pc = _cond(form, jb, pb, qw)
    js, ps = _seeds(rate)
    want = jkb.banded_transformer_bwd(
        jnp.asarray(jb.bias_noself), *map(jnp.asarray, (q, k, v)),
        jnp.asarray(g), H, gs=None if gs is None else jnp.asarray(gs),
        dropout_rate=rate, seed=js, mean_expand=mean, raw_kv_partials=True,
        **jc)
    got = tb.banded_transformer_bwd(
        pb.bias_noself, *map(torch.from_numpy, (q, k, v)), torch.from_numpy(g),
        H, gs=None if gs is None else torch.from_numpy(gs), mean_expand=mean,
        dropout_rate=rate, seed=ps, **pc)
    assert len(got) == len(want) == (3 if form == "plain" else 4)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        _close(a, b, 1e-5, name)
    if form == "plain":
        return
    dqw, wdqw = got[3].numpy(), np.asarray(want[3])
    if form == "edge":
        _close(dqw, wdqw, 1e-5, "dqw")
        return
    d4, w4 = dqw.reshape(n, H, 4), wdqw.reshape(n, H, 4)
    assert (np.abs(d4[..., :3] - w4[..., :3]).max()
            <= 1e-5 * np.abs(w4[..., :3]).max() + 1e-6 * _cancel(pb))
    _close(d4[..., 3], w4[..., 3], 1e-5, "dqw dist")


def test_row10_plain_matches_jax_w5_and_bf16(bands):
    """The W 5 band (W_sub 10) in f32 as above, geo head mean at rate 0.3
    with gs; and bf16 on the W 3 band: the port's dq, partials and dqw no
    further from JAX f32 than 1.5 × JAX bf16's own distance (norms)."""
    rng = np.random.default_rng(8)
    for window, dtype in ((5, "float32"), (3, "bfloat16"), (3, "float32")):
        jb, pb = bands[window]["geo"]
        n = pb.bias_noself.shape[0] * TILE
        q, k, v, qw = _inputs(n, 9)
        g = rng.normal(size=(n, C)).astype(np.float32)
        gs = rng.normal(size=(n, H * 4)).astype(np.float32)

        def run(dt, jax_side):
            jc, pc = _cond("geo", jb, pb, qw, dt)
            js, ps = _seeds(RATE)
            if jax_side:
                j = lambda a: jnp.asarray(a, dt)  # noqa: E731
                res = jkb.banded_transformer_bwd(
                    jnp.asarray(jb.bias_noself), j(q), j(k), j(v), j(g), H,
                    gs=jnp.asarray(gs), dropout_rate=RATE, seed=js,
                    mean_expand=True, raw_kv_partials=True, **jc)
                return [np.asarray(a, np.float32) for a in res]
            t = lambda a: torch.from_numpy(a).to(getattr(torch, dt))  # noqa: E731
            res = tb.banded_transformer_bwd(
                pb.bias_noself, t(q), t(k), t(v), t(g), H,
                gs=torch.from_numpy(gs), mean_expand=True, dropout_rate=RATE,
                seed=ps, **pc)
            return [a.float().numpy() for a in res]

        got, want = run(dtype, False), run(dtype, True)
        if dtype == "float32":
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                _close(a, b, 1e-5, f"W {window} {name}")
            continue
        want32 = run("float32", True)
        for name, a, b, b32 in zip(("dq", "dk", "dv", "dqw"), got, want,
                                   want32):
            own = np.linalg.norm(b - b32)
            dist = np.linalg.norm(a - b32)
            assert dist <= 1.5 * own, f"bf16 {name}: {dist} > 1.5 × {own}"


@pytest.mark.parametrize("n_tiles,w_sub,sub,tile", [
    (8, 6, 4, 8),    # 3-tile window, r=2 (flagship layout)
    (8, 10, 4, 8),   # 5-tile window, r=2
    (8, 4, 4, 8),    # half-tile-clamped window (k0 not a multiple of r)
    (5, 3, 8, 8),    # r=1 degenerate
])
def test_row7_plain_matches_combine_partials(n_tiles, w_sub, sub, tile):
    """f32: the same sums in the same order (ascending window block)."""
    part = np.random.default_rng(0).normal(
        size=(n_tiles, w_sub, sub, 5)).astype(np.float32)
    want = np.asarray(jkb.combine_partials(jnp.asarray(part), tile))
    got = tb.fold_partials(torch.from_numpy(part), tile)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w_sub,n_tiles", [(3, 5), (4, 7), (5, 4)])
def test_row7_plain_matches_fold_partials(w_sub, n_tiles):
    """f32 against the Pallas fold (interpret mode), 1e-6 as the JAX
    package's own test; bf16 output rounds the same f32 sums once."""
    tile, sub, feat = 16, 8, 128
    part = np.random.default_rng(11).normal(
        size=(n_tiles, w_sub, sub, feat)).astype(np.float32)
    want = np.asarray(jkb.fold_partials(jnp.asarray(part), tile))
    got = tb.fold_partials(torch.from_numpy(part), tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jkb.fold_partials(jnp.asarray(part), tile,
                                        out_dtype=jnp.bfloat16), np.float32)
    out = torch.empty(n_tiles * tile, 2 * feat, dtype=torch.bfloat16)
    got = tb.fold_partials(torch.from_numpy(part), tile, out=out[:, feat:])
    assert got.data_ptr() == out[:, feat:].data_ptr()
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row6_bias_form_matches_jax(dtype):
    """(dx, dW, db) from the folded rows against the JAX kernel, which
    folds the partials itself (the same f32 fold, rounded once to the
    primal dtype): f32 1e-5 of each output's max (summation order); bf16
    dx rounds once on both sides (2^-8), dW and db 1e-4."""
    n_tiles, w_sub, sub, tile, f, hc = 6, 6, 8, 16, 32, 24
    rng = np.random.default_rng(4)
    part = rng.normal(size=(n_tiles, w_sub, sub, hc)).astype(np.float32)
    x = rng.normal(size=(n_tiles * tile, f)).astype(np.float32)
    w = (rng.normal(size=(f, hc)) / np.sqrt(f)).astype(np.float32)
    j = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    want = jkb.fold_project_bwd(j(part), j(x), j(w), tile, with_bias=True)
    t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    dz = tb.fold_partials(t(part), tile)
    got = tb.fold_project_bwd(dz, t(x), t(w), with_bias=True)
    assert got[0].dtype == getattr(torch, dtype)
    assert got[1].dtype == got[2].dtype == torch.float32
    tols = (1e-5, 1e-5, 1e-5) if dtype == "float32" else (1e-2, 1e-4, 1e-4)
    for name, a, b, tol in zip(("dx", "dW", "db"), got, want, tols):
        _close(a, b, tol, name)


def _projgrad_inputs(n, seed=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    ws = [(rng.normal(size=(F, H * C)) * F ** -0.5).astype(np.float32)
          for _ in range(3)]
    bs = [(0.1 * rng.normal(size=H * C)).astype(np.float32) for _ in range(3)]
    w_e = (rng.normal(size=(4, H, C)) * 0.5).astype(np.float32)
    wblk = (np.eye(H, dtype=np.float32)[:, None, :, None]
            * np.transpose(w_e, (1, 2, 0))[:, :, None, :]).reshape(H * C, H * 4)
    g = rng.normal(size=(n, C)).astype(np.float32)
    gs = rng.normal(size=(n, H * 4)).astype(np.float32)
    return x, ws, bs, wblk, g, gs


def _port_projgrad(pb, x, ws, bs, wblk, g, gs, rate, seed):
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, *ws, *bs, wblk)]
    _build.reset_launches()
    out, s = tk.banded_transformer_geo_mean_projgrad(
        pb.bias_noself, pb.geo, pb.pos, *leaves, H, rate, seed)
    torch.autograd.backward((out, s), (torch.from_numpy(g),
                                       torch.from_numpy(gs)))
    assert not any(_build.LAUNCHES.values())   # CPU: the plain versions
    return (out, s), [t.grad for t in leaves]


NAMES = ("dx", "dwq", "dwk", "dwv", "dbq", "dbk", "dbv", "dwblk")


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("window", [3, 5])
def test_projgrad_matches_jax_vjp(bands, window, rate):
    """f32: out, s and every cotangent against ``jax.vjp`` of the JAX op
    (its partials mode: H·C 32 < 128), each within 1e-5 of its max, or of
    the largest cotangent for dbk, which is zero in exact arithmetic (the
    key bias shifts every logit of a row alike)."""
    jb, pb = bands[window]["geo"]
    n = pb.bias_noself.shape[0] * TILE
    x, ws, bs, wblk, g, gs = _projgrad_inputs(n)
    js, ps = _seeds(rate)
    prim, vjp = jax.vjp(
        lambda *a: jk.banded_transformer_geo_mean_projgrad(
            jnp.asarray(jb.bias_noself), jnp.asarray(jb.geo),
            jnp.asarray(jb.pos), *a, H, rate, js),
        *map(jnp.asarray, (x, *ws, *bs, wblk)))
    want = vjp((jnp.asarray(g), jnp.asarray(gs)))
    fwd, got = _port_projgrad(pb, x, ws, bs, wblk, g, gs, rate, ps)
    _close(fwd[0], prim[0], 1e-5, "out")
    top = max(float(np.abs(np.asarray(a)).max()) for a in want)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, 1e-5, name, floor=top if name == "dbk" else 0.0)


def test_projgrad_matches_jax_project_mode_w3(bands):
    """On the W 3 band the JAX package's in-kernel projection mode
    (carry-based, ``project_x=``) gives the same cotangents: f32, 1e-5 as
    above (its dx sums the q and k/v streams once in f32).  That mode forms
    dwblk's diagonal head blocks only, the entries the block-diagonal wblk
    passes on to W_e; the port's dwblk = qᵀ·dqw is held there."""
    jb, pb = bands[3]["geo"]
    n = pb.bias_noself.shape[0] * TILE
    x, ws, bs, wblk, g, gs = _projgrad_inputs(n, seed=13)
    j = [jnp.asarray(a) for a in (x, *ws, *bs, wblk)]
    q, k, v = ((j[0] @ j[1 + m] + j[4 + m]) for m in range(3))
    qw = q @ j[7]
    want = jkb.banded_transformer_bwd(
        jnp.asarray(jb.bias_noself), q, k, v, jnp.asarray(g), H, qw=qw,
        gs=jnp.asarray(gs), geo_band=jnp.asarray(jb.geo),
        pos=jnp.asarray(jb.pos), mean_expand=True, project_x=j[0],
        project_wq=j[1], project_wk=j[2], project_wv=j[3], project_wblk=j[7])
    _, got = _port_projgrad(pb, x, ws, bs, wblk, g, gs, 0.0, None)
    diag = (np.eye(H)[:, None, :, None] * np.ones((1, C, 1, 4))).reshape(
        H * C, H * 4)
    got[-1] = got[-1] * torch.from_numpy(diag).float()
    top = max(float(np.abs(np.asarray(a)).max()) for a in want)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, 1e-5, name, floor=top if name == "dbk" else 0.0)
