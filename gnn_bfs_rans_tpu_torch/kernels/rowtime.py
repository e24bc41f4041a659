"""Time rows 1–6, 8–11 and the Transformer training projection of one
checkout of the port on the card.

    python gnn_bfs_rans_tpu_torch/kernels/rowtime.py [--root DIR] [--label L]
        [--rows 1,2,3,4,5,6,8,9,10,11,project]

imports ``gnn_bfs_rans_tpu_torch`` from ``DIR`` (default: the checkout this
file lies in), builds its CUDA sources and prints one JSON line of device
times per call (ten calls in one CUDA graph, replayed), each beside its
kernels' device times by name from ``torch.profiler``, its largest error
relative to the plain version and a digest of its outputs' bits (two
checkouts whose digests agree compute bit-identical outputs):

* row 1, ``banded_gat_mean_fused``, eval and training (dropout 0.1, z
  emitted) forms (the projection and the attention by kernel name), bf16
  and f32, with one ``torch.matmul(x, W)`` beside it as the projection's
  yardstick;
* row 2, ``fused_epilogue_fwd`` (the BatchNorm epilogue's forward, through
  ``_forward``, which also returns xr and vec), n_valid 12,000 of 12,032
  rows, bf16 and f32 at rate 0 and 0.1, mixed (x f32, x_new bf16) at 0.1,
  each beside its bound (x and x_new read, xr and y written once, at 3.35
  TB/s); and at 1,024 rows (bf16, rate 0.1), its fixed cost; where the
  checkout has ``csrc/epilogue_fwd.cu``, also an empty cooperative launch
  of row 2's grid at 1,024 rows that meets at one grid barrier
  (``barrier_probe``);
* row 3, ``fused_epilogue_bwd`` (the BatchNorm epilogue's backward) on
  the kernel forward's own residuals, n_valid 12,000 of 12,032 rows, at
  rate 0 and 0.1, bf16 and f32, and mixed (x f32, x_new bf16) at 0.1;
  and at 1,024 rows (bf16, rate 0.1), its fixed cost;
* row 8, ``banded_spmm_fwd`` in its four forms (GCN: the f32 ``gcn`` plane
  times x in f32 and bf16; GIN: the bf16 ``adj`` plane times x in f32 and
  bf16) on the 400×30 box's band (W 3) and a 200×150 box's (W 5), each
  beside its bound (the plane, x and out once) and ``torch.sparse.mm`` of
  the same band as an f32 CSR matrix;
* row 4, ``banded_gat_mean`` (head mean) and ``banded_gat`` (concat) at
  dropout 0.1, bf16 and f32;
* row 5, ``banded_gat_bwd``, head mean and per head at dropout 0.1 (the
  receiver and sender passes by kernel name), bf16 and f32;
* row 6, ``fold_project_bwd``, at the main path's three shapes (the GAT
  form dz [N, 1,024], the Transformer's wblk form dz [N, 16] against q read
  from its q|k|v buffer, the bias form dz [N, 3,072]) in bf16 and f32, with
  the time of the same products as ``torch.matmul`` calls beside them;
* row 9, ``banded_transformer_fwd``: geo head mean in eval (also on q, k
  and v as column blocks of one q|k|v buffer, as row 11 reads them) and at
  dropout 0.1, and the plain and edge (4 random features per edge)
  head-mean and the geo concat forms in eval, bf16 and f32;
* row 10, ``banded_transformer_bwd``, geo head-mean at dropout 0.1;
* row 11, ``banded_transformer_geo_mean_fused`` (the projection and the
  attention by kernel name), bf16 and f32, with one ``torch.addmm`` of x
  by [Wq | Wk | Wv] beside it as the projection's yardstick;
* ``project``: ``transformer_project``, the training path's q|k|v = x·W +
  b and qw = q·wblk, bf16 and f32, with ``torch.addmm`` of x by [Wq | Wk |
  Wv] and ``torch.matmul`` of its q block by wblk beside it.

N 12,032 (the 400×30 box case), F 256, H 4, C 256: the flagship shape.
Run it once per checkout inside one call on the card to compare two
versions (parent, change, change, parent), since cards and their power
limits differ between calls.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
from pathlib import Path


def _graph_ms(fn, calls=10, replays=5):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _kernel_us(fn, steps=10):
    """Device µs per call of ``fn`` by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.device_time / steps
    return out


def _launches_us(fn):
    """Device µs of each launch of one call of ``fn``, in launch order
    (splits launches that share a kernel name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    return [[e.name[:48], e.device_time] for e in events]


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _rel_err(got, ref):
    """The largest of the outputs' max |got − ref| / max |ref|."""
    return max(((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item() for a, b in zip(got, ref))


def _entry(call, plain, **extra):
    """One row's reading: device ms per call, µs by kernel name, the largest
    relative error against the plain version, and ``sha``, a digest of the
    outputs' bits (equal digests from two checkouts: bit-identical
    outputs), and ``shas``, one for each output."""
    import torch

    got = _tuple(call())
    digest = hashlib.sha256()
    shas = []
    for t in got:
        bits = t.contiguous().cpu().view(-1).view(torch.uint8).numpy()
        digest.update(bits)
        shas.append(hashlib.sha256(bits).hexdigest()[:16])
    return dict(ms=_graph_ms(call), kernels_us=_kernel_us(call),
                launches_us=_launches_us(call), shas=shas,
                rel_err=_rel_err(got, _tuple(plain())),
                sha=digest.hexdigest()[:16], **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--rows", default="1,2,3,4,5,6,8,9,10,11,project",
                    help="comma-separated rows to time")
    args = ap.parse_args(argv)
    rows = set(args.rows.split(","))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    dtypes = (torch.bfloat16, torch.float32)
    if not torch.cuda.is_available():
        print("rowtime: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import numpy as np
    from gnn_bfs_rans_tpu_torch.foam import generate_box_case
    from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS, build_band
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.kernels import banded as bk
    from gnn_bfs_rans_tpu_torch.kernels import banded_bwd as bb

    dev = torch.device("cuda")
    gen = torch.Generator()
    n, f, heads, c = 12032, 256, 4, 256
    hc = heads * c
    res = {"root": str(Path(bb.__file__).resolve().parents[2]),
           "label": args.label, "card": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as tmp:
        generate_box_case(Path(tmp) / "box", 400, 30, 1)
        g = load_graph(Path(tmp) / "box", "Transformer")
        band = g.band.to(dev)
        mask5 = load_graph(Path(tmp) / "box", "GAT").band.bias_self.to(dev)
    # row 9's generic edge form: the same edges with 4 random features
    feat = np.random.default_rng(400).normal(
        size=(g.n_edges, 4)).astype(np.float32)
    edge_band = build_band(
        g.senders.numpy()[: g.n_edges], g.receivers.numpy()[: g.n_edges],
        g.n_pad, g.node_mask.numpy(), g.in_degree.numpy(),
        components=LAYER_COMPONENTS["Transformer"], edge_feat=feat,
        node_pos=g.node_feat.numpy()).to(dev)
    seed = torch.tensor([2025], dtype=torch.int32, device=dev)
    gen.manual_seed(1)
    for dtype in dtypes:
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        x = torch.randn(n, f, generator=gen).to(dev, dtype)
        w = (torch.randn(f, hc, generator=gen) * f ** -0.5).to(dev, dtype)
        wa = (torch.randn(f, 2 * heads, generator=gen) * f ** -0.5).to(
            dev, dtype)
        alphas = (x.float() @ wa.float()).contiguous()
        z = (x.float() @ w.float()).to(dtype)
        if "1" in rows:
            for form, extra in (("eval", ()), ("train", (0.1, seed))):
                a1 = (mask5, w, alphas, x, heads, 0.2, *extra)
                kw1 = dict(emit_z=bool(extra))
                res[f"row1_{form}_{name}"] = _entry(
                    lambda: bk.banded_gat_mean_fused(*a1, **kw1),
                    lambda: bk.banded_gat_mean_fused_plain(*a1, **kw1),
                    matmul_ms=_graph_ms(lambda: torch.matmul(x, w)))
        if "4" in rows:
            a4 = (mask5, z, alphas, heads, 0.2, 0.1, seed)
            for form, fn, plain in (
                    ("mean", bk.banded_gat_mean, bk.banded_gat_mean_plain),
                    ("concat", bk.banded_gat, bk.banded_gat_plain)):
                res[f"row4_{form}_{name}"] = _entry(lambda: fn(*a4),
                                                    lambda: plain(*a4))
    gen.manual_seed(9)
    for dtype in dtypes:
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        if "9" not in rows:
            break
        q, k, v = (torch.randn(n, hc, generator=gen).to(dev, dtype)
                   for _ in range(3))
        qw = torch.randn(n, heads * 4, generator=gen).to(dev, dtype)
        geo = dict(geo=band.geo, pos=band.pos, qw=qw)
        edge = dict(edge=edge_band.edge, qw=qw)
        qkv = torch.cat([q, k, v], 1)
        for form, b9, kw9 in (
                ("geo_mean", band, dict(geo, mean_heads=True)),
                ("geo_mean_qkv", band, dict(geo, mean_heads=True)),
                ("geo_mean_drop", band, dict(geo, mean_heads=True,
                                             dropout_rate=0.1, seed=seed)),
                ("plain_mean", band, dict(mean_heads=True)),
                ("edge_mean", edge_band, dict(edge, mean_heads=True)),
                ("geo_concat", band, dict(geo))):
            a9 = (b9.bias_noself, q, k, v, heads)
            if form.endswith("_qkv"):   # column blocks of one q|k|v buffer
                a9 = (b9.bias_noself, *qkv.split(hc, 1), heads)
            res[f"row9_{form}_{name}"] = _entry(
                lambda: bk.banded_transformer_fwd(*a9, **kw9),
                lambda: bk.banded_transformer_fwd_plain(*a9, **kw9))
    gen.manual_seed(5)
    for dtype in dtypes:
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        if "5" not in rows:
            break
        z = (0.5 * torch.randn(n, hc, generator=gen)).to(dev, dtype)
        alphas = torch.randn(n, 2 * heads, generator=gen).to(dev)
        for form, mean in (("mean", True), ("per_head", False)):
            g = torch.randn(n, c if mean else hc, generator=gen).to(dev, dtype)
            a5 = (mask5, z, alphas, g, heads, 0.2, 0.1, seed)
            kw5 = dict(mean_expand=mean)
            if hasattr(bb, "transpose_mask"):   # kept per band by the convs
                kw5["mask_t"] = bb.transpose_mask(mask5)
            res[f"row5_{form}_{name}"] = _entry(
                lambda: bb.banded_gat_bwd(*a5, **kw5),
                lambda: bb.banded_gat_bwd_plain(*a5, mean_expand=mean))
    gen.manual_seed(0)
    for dtype in dtypes:
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        if "6" not in rows:
            break
        x = torch.randn(n, f, generator=gen).to(dev, dtype)
        qkv = torch.randn(n, 3 * hc, generator=gen).to(dev, dtype)
        shapes = {
            "gat": (torch.randn(n, hc, generator=gen).to(dev, dtype), x,
                    (torch.randn(f, hc, generator=gen) / 16).to(dev, dtype),
                    False),
            "wblk": (torch.randn(n, 4 * heads, generator=gen).to(dev, dtype),
                     qkv[:, :hc],
                     (torch.randn(hc, 4 * heads, generator=gen) / 32).to(
                         dev, dtype), False),
            "bias": (torch.randn(n, 3 * hc, generator=gen).to(dev, dtype), x,
                     (torch.randn(f, 3 * hc, generator=gen) / 16).to(
                         dev, dtype), True),
        }
        for form, (dz, xx, w, bias) in shapes.items():
            wt = w.t()
            lib = ((lambda: (dz @ wt, xx.t() @ dz, dz.sum(0))) if bias
                   else (lambda: (dz @ wt, xx.t() @ dz)))
            res[f"row6_{form}_{name}"] = _entry(
                lambda: bb.fold_project_bwd(dz, xx, w, with_bias=bias),
                lambda: bb.fold_project_bwd_plain(dz, xx, w, with_bias=bias),
                library_ms=_graph_ms(lib))
    dt = torch.bfloat16
    gen.manual_seed(10)
    if "10" in rows:
        q, k, v = (torch.randn(n, hc, generator=gen).to(dev, dt)
                   for _ in range(3))
        qw = torch.randn(n, heads * 4, generator=gen).to(dev, dt)
        g = torch.randn(n, c, generator=gen).to(dev, dt)
        gs = torch.randn(n, heads * 4, generator=gen).to(dev)
        a10 = (band.bias_noself, q, k, v, g, heads)
        kw = dict(geo=band.geo, pos=band.pos, qw=qw, gs=gs, mean_expand=True,
                  dropout_rate=0.1, seed=seed)
        res["row10_geo_mean_bf16"] = _entry(
            lambda: bb.banded_transformer_bwd(*a10, **kw),
            lambda: bb.banded_transformer_bwd_plain(*a10, **kw))
    gen.manual_seed(11)
    for dtype in dtypes:
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        if "11" not in rows:
            break
        x = torch.randn(n, f, generator=gen).to(dev, dtype)
        ws = [(torch.randn(f, hc, generator=gen) * f ** -0.5).to(dev, dtype)
              for _ in range(3)]
        bs = [(0.1 * torch.randn(hc, generator=gen)).to(dev, dtype)
              for _ in range(3)]
        w_e = torch.rand(4, heads, c, generator=gen) - 0.5
        wblk = (torch.eye(heads)[:, None, :, None]
                * w_e.permute(1, 2, 0)[:, :, None, :]).reshape(hc, heads * 4)
        a11 = (band.bias_noself, band.geo, band.pos, x, *ws, *bs,
               wblk.to(dev, dtype), heads)
        wcat, bcat = torch.cat(ws, 1), torch.cat(bs)
        res[f"row11_{name}"] = _entry(
            lambda: bk.banded_transformer_geo_mean_fused(*a11),
            lambda: bk.banded_transformer_geo_mean_fused_plain(*a11),
            addmm_ms=_graph_ms(lambda: torch.addmm(bcat, x, wcat)))
    gen.manual_seed(3)
    if "3" in rows:
        from gnn_bfs_rans_tpu_torch.kernels import epilogue as ep

        n_valid = 12000
        for name, dx, dxn, rates in (
                ("bf16", torch.bfloat16, torch.bfloat16, (0.0, 0.1)),
                ("f32", torch.float32, torch.float32, (0.0, 0.1)),
                ("mixed", torch.float32, torch.bfloat16, (0.1,))):
            x = (torch.randn(n, c, generator=gen) + 1).to(dev, dx)
            xn = torch.randn(n, c, generator=gen).to(dev, dxn)
            scale = (1 + 0.1 * torch.randn(c, generator=gen)).to(dev)
            bias = (0.1 * torch.randn(c, generator=gen)).to(dev)
            for rate in rates:
                sd = seed if rate else None
                _, mean, _, xr, vec = ep._forward(x, xn, scale, bias,
                                                  n_valid, 1e-5, rate, sd)
                g = torch.randn(n, c, generator=gen).to(dev, xr.dtype)
                a3 = (g, xr, vec, mean, n_valid, rate, sd, dx, dxn)
                res[f"row3_{name}_rate{rate}"] = _entry(
                    lambda: ep.fused_epilogue_bwd(*a3),
                    lambda: ep.fused_epilogue_bwd_plain(*a3))
        # the fixed cost: 1,024 rows, bf16, rate 0.1
        x = torch.randn(1024, c, generator=gen).to(dev, torch.bfloat16)
        _, mean, _, xr, vec = ep._forward(x, x, scale, bias, 1000, 1e-5, 0.1,
                                          seed)
        a3 = (x, xr, vec, mean, 1000, 0.1, seed, x.dtype, x.dtype)
        res["row3_bf16_small"] = _entry(
            lambda: ep.fused_epilogue_bwd(*a3),
            lambda: ep.fused_epilogue_bwd_plain(*a3))
    gen.manual_seed(12)
    for dtype in dtypes:
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        if "project" not in rows:
            break
        import inspect

        x = torch.randn(n, f, generator=gen).to(dev, dtype)
        ws = [(torch.randn(f, hc, generator=gen) * f ** -0.5).to(dev, dtype)
              for _ in range(3)]
        bs = [(0.1 * torch.randn(hc, generator=gen)).to(dev, dtype)
              for _ in range(3)]
        w_e = torch.rand(4, heads, c, generator=gen) - 0.5
        wblk = (torch.eye(heads)[:, None, :, None]
                * w_e.permute(1, 2, 0)[:, :, None, :]).reshape(
                    hc, heads * 4).to(dev, dtype)
        wcat, bcat = torch.cat(ws, 1), torch.cat(bs)
        if "wq" in inspect.signature(bk.transformer_project).parameters:
            ap_ = (x, *ws, *bs, wblk)
        else:   # the earlier (x, w, b, wblk) form: one weight, f32 bias
            ap_ = (x, wcat, bcat.float(), wblk)
        q = torch.addmm(bcat, x, wcat)[:, :hc]
        res[f"project_{name}"] = _entry(
            lambda: bk.transformer_project(*ap_),
            lambda: bk.transformer_project_plain(*ap_),
            addmm_ms=_graph_ms(lambda: torch.addmm(bcat, x, wcat)),
            matmul_ms=_graph_ms(lambda: torch.matmul(q, wblk)))
    if "2" in rows:
        res.update(_row2(dev, gen, seed))
    if "8" in rows:
        res.update(_row8(dev, gen))
    print(json.dumps(res))
    return 0


_BYTES_PER_S = 3.35e12   # the H100's device memory


def _row2(dev, gen, seed):
    """Row 2's forms, its fixed cost and, in a checkout that has it, the
    empty one-barrier launch."""
    import ctypes

    import torch
    from gnn_bfs_rans_tpu_torch.kernels import _build
    from gnn_bfs_rans_tpu_torch.kernels import epilogue as ep

    gen.manual_seed(2)
    c, out = 256, {}
    forms = [("bf16", torch.bfloat16, torch.bfloat16, rate, 12032, 12000)
             for rate in (0.0, 0.1)]
    forms += [("f32", torch.float32, torch.float32, rate, 12032, 12000)
              for rate in (0.0, 0.1)]
    forms += [("mixed", torch.float32, torch.bfloat16, 0.1, 12032, 12000),
              ("bf16_small", torch.bfloat16, torch.bfloat16, 0.1, 1024, 1000)]
    for name, dx, dxn, rate, n, n_valid in forms:
        x = (torch.randn(n, c, generator=gen) + 1).to(dev, dx)
        xn = torch.randn(n, c, generator=gen).to(dev, dxn)
        scale = (1 + 0.1 * torch.randn(c, generator=gen)).to(dev)
        bias = (0.1 * torch.randn(c, generator=gen)).to(dev)
        a2 = (x, xn, scale, bias, n_valid, 1e-5, rate, seed if rate else None)
        nbytes = (x.numel() * x.element_size() + xn.numel() * xn.element_size()
                  + 2 * x.numel() * max(x.element_size(), xn.element_size()))
        out[f"row2_{name}_rate{rate}"] = _entry(
            lambda: ep._forward(*a2), lambda: ep._forward_plain(*a2),
            bound_ms=nbytes / _BYTES_PER_S * 1e3)
    root = Path(ep.__file__).resolve().parents[1]
    if (root / "csrc" / "epilogue_fwd.cu").exists():
        lib = _build.bind("epilogue_fwd", "grid_barrier_probe_launch",
                          [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p])
        bar = torch.zeros(1, dtype=torch.int32, device=dev)

        def probe():
            rc = lib.grid_barrier_probe_launch(
                bar.data_ptr(), 1024, c,
                torch.cuda.current_stream().cuda_stream)
            _build.check(lib, rc, "grid_barrier_probe")

        out["row2_barrier_probe_1024"] = dict(
            ms=_graph_ms(probe), kernels_us=_kernel_us(probe))
    return out


def _row8(dev, gen):
    """Row 8's four forms on a W 3 and a W 5 band, beside torch.sparse.mm."""
    import torch
    from gnn_bfs_rans_tpu_torch.foam import FoamCase, generate_box_case
    from gnn_bfs_rans_tpu_torch.graph.build import build_graph
    from gnn_bfs_rans_tpu_torch.kernels import banded as bk

    gen.manual_seed(8)
    out = {}
    for nx, ny in ((400, 30), (200, 150)):
        with tempfile.TemporaryDirectory() as tmp:
            generate_box_case(Path(tmp) / "box", nx, ny, 1)
            band = build_graph(FoamCase(Path(tmp) / "box").load_mesh(),
                               with_band=True,
                               band_components=("adj", "gcn")).band.to(dev)
        for conv, plane in (("gcn", band.gcn), ("gin", band.adj)):
            n_tiles, window, tile, _ = plane.shape
            n = n_tiles * tile
            t, k, i, j = (plane != 0).nonzero(as_tuple=True)
            csr = torch.sparse_coo_tensor(
                torch.stack([t * tile + i, (t - window // 2 + k) * tile + j]),
                plane[t, k, i, j].float(), (n, n)).coalesce().to_sparse_csr()
            for xname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                x = torch.randn(n, 256, generator=gen).to(dev, dt)
                xf = x.float()
                nbytes = (plane.numel() * plane.element_size()
                          + 2 * x.numel() * x.element_size())
                out[f"row8_{conv}_x{xname}_w{window}"] = _entry(
                    lambda: bk.banded_spmm_fwd(plane, x),
                    lambda: bk.banded_spmm_plain(plane, x),
                    bound_ms=nbytes / _BYTES_PER_S * 1e3, nnz=int(t.numel()),
                    library_ms=_graph_ms(lambda: torch.sparse.mm(csr, xf)))
    return out


if __name__ == "__main__":
    sys.exit(main())
