"""Time rows 6 and 10 of one checkout of this package on the card.

    python gnn_bfs_rans_tpu_torch/kernels/rowtime.py [--root DIR] [--label L]

imports ``gnn_bfs_rans_tpu_torch`` from ``DIR`` (default: the checkout this
file lies in), builds its two CUDA sources and prints one JSON line of
device times per call (ten calls in one CUDA graph, replayed): row 6,
``fold_project_bwd``, at the main path's three shapes (the GAT form dz
[N, 1,024], the Transformer's wblk form dz [N, 16] against q read from its
q|k|v buffer, the bias form dz [N, 3,072]) in bf16 and f32, with the time of
the same products as ``torch.matmul`` calls beside them and its kernels'
device times by name (the products, the fold of dW's slices); and row 10,
``banded_transformer_bwd``, geo head-mean at dropout 0.1, with its
kernels' device times by name from ``torch.profiler``.  N 12,032 (the
400×30 box case), F 256, H 4, C 256: the flagship shape.  Run it once per
checkout inside one call on the card to compare two versions (parent,
change, change, parent), since cards and their power limits differ between
calls.
"""

from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("rowtime: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from gnn_bfs_rans_tpu_torch.foam import generate_box_case
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.kernels import banded_bwd as bb

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    n, f, heads, c = 12032, 256, 4, 256
    hc = heads * c
    res = {"root": str(Path(bb.__file__).resolve().parents[2]),
           "label": args.label, "card": torch.cuda.get_device_name(0)}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
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
            got = bb.fold_project_bwd(dz, xx, w, with_bias=bias)
            ref = bb.fold_project_bwd_plain(dz, xx, w, with_bias=bias)
            err = max(((a.float() - b.float()).abs().max()
                       / b.float().abs().max()).item()
                      for a, b in zip(got, ref))
            wt = w.t()
            lib = ((lambda: (dz @ wt, xx.t() @ dz, dz.sum(0))) if bias
                   else (lambda: (dz @ wt, xx.t() @ dz)))

            def call():
                return bb.fold_project_bwd(dz, xx, w, with_bias=bias)

            res[f"row6_{form}_{name}"] = dict(
                ms=_graph_ms(call), library_ms=_graph_ms(lib), rel_err=err,
                kernels_us=_kernel_us(call))
    with tempfile.TemporaryDirectory() as tmp:
        generate_box_case(Path(tmp) / "box", 400, 30, 1)
        band = load_graph(Path(tmp) / "box", "Transformer").band.to(dev)
    dt = torch.bfloat16
    q, k, v = (torch.randn(n, hc, generator=gen).to(dev, dt) for _ in range(3))
    qw = torch.randn(n, heads * 4, generator=gen).to(dev, dt)
    g = torch.randn(n, c, generator=gen).to(dev, dt)
    gs = torch.randn(n, heads * 4, generator=gen).to(dev)
    seed = torch.tensor([2025], dtype=torch.int32, device=dev)
    a10 = (band.bias_noself, q, k, v, g, heads)
    kw = dict(geo=band.geo, pos=band.pos, qw=qw, gs=gs, mean_expand=True,
              dropout_rate=0.1, seed=seed)
    got = bb.banded_transformer_bwd(*a10, **kw)
    ref = bb.banded_transformer_bwd_plain(*a10, **kw)
    err = max(((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item() for a, b in zip(got, ref))
    res["row10_geo_mean_bf16"] = dict(
        ms=_graph_ms(lambda: bb.banded_transformer_bwd(*a10, **kw)),
        kernels_us=_kernel_us(lambda: bb.banded_transformer_bwd(*a10, **kw)),
        rel_err=err)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
