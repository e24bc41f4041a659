#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (gnn_bfs_rans_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. build every CUDA kernel from ``gnn_bfs_rans_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and print the card's name and power limit;
2. kernel 1, ``banded_gat_mean_fused`` (CUDA), against its plain PyTorch
   version at the flagship width (F 256, H 4, C 256) on the bands of two
   generated cases — 400×30 cells (Wcols 256, the BFS mesh's shape class)
   and 163×75 (Wcols 384) — in f32 and bf16;
3. kernel 2, ``fused_epilogue_fwd`` (Triton), against its plain version at
   [12,032, 256] in f32, bf16 and mixed;
4. serving: a seeded 4-layer, hidden-256, 4-head bf16 GAT checkpoint served
   through ``python -m gnn_bfs_rans_tpu_torch infer`` (in process, through
   ``main(argv)``) with ``--bn_exact off`` and ``--bn_exact on``; the launch
   counters must show the kernels carried both runs, the outputs must be
   finite and written, and the fields must agree with the same predictor
   run through the plain versions on the card; then the forward's host-clock
   time, its device time (replayed as a CUDA graph) and a torch.profiler
   breakdown by kernel with the card's idle share;
5. print the kernel table as one JSON line, then the result line.

Kernel times (``ms``, ``plain_ms``) are device times per call: ten calls
captured in one CUDA graph and replayed, so host launch overhead does not
enter them; the eager per-call time is printed beside them.

Needs no network; builds into ``gnn_bfs_rans_tpu_torch/build`` and writes
scratch files only under the temporary directory.
"""

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12   # dense tensor-core bf16 (NVIDIA data sheet, SXM)
H100_FP32_FLOPS = 67e12    # FP32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
HIDDEN, HEADS, LAYERS = 256, 4, 4
GAT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}    # × max |plain output|
EPI_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "mixed": 1e-5}
SERVE_TOL = 5e-2                                  # × max |plain field|


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    """Per-call time of ``fn`` as launched eagerly (host overhead included
    when the host is slower than the card)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, calls=10, replays=5):
    """Device time per call: ``calls`` calls captured in one CUDA graph and
    replayed, so no host launch overhead enters the time."""
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


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_gat(graph, dtype_name, gen):
    """Kernel 1 vs plain on one band; returns the measured row."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded import (
        banded_gat_mean_fused, banded_gat_mean_fused_plain)

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name)
    n, f, hc = graph.n_pad, HIDDEN, HEADS * HIDDEN
    x = torch.randn(n, f, generator=gen).to(dev, dt)
    w = (torch.randn(f, hc, generator=gen) * f ** -0.5).to(dev, dt)
    wa = (torch.randn(f, 2 * HEADS, generator=gen) * f ** -0.5).to(dev, dt)
    alphas = (x.float() @ wa.float()).contiguous()
    mask = graph.band.bias_self
    got = banded_gat_mean_fused(mask, w, alphas, x, HEADS)
    ref = banded_gat_mean_fused_plain(mask, w, alphas, x, HEADS)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not (torch.isfinite(got).all() and err <= GAT_TOL[dtype_name] * scale):
        raise AssertionError(f"banded_gat_mean_fused {dtype_name} Wcols "
                             f"{mask.shape[-1]}: max err {err} > "
                             f"{GAT_TOL[dtype_name]} × {scale}")
    ms = graph_time_ms(lambda: banded_gat_mean_fused(mask, w, alphas, x, HEADS))
    eager_ms = cuda_time_ms(
        lambda: banded_gat_mean_fused(mask, w, alphas, x, HEADS))
    plain_ms = graph_time_ms(
        lambda: banded_gat_mean_fused_plain(mask, w, alphas, x, HEADS), 3, 2)
    # the work this data needs: the dense projection plus the nonzero
    # (in-range) band entries of the aggregation
    nnz = int(mask.sum().item())
    isz = x.element_size()
    nbytes = (mask.numel() + f * hc * isz + alphas.numel() * 4
              + n * f * isz + n * HIDDEN * isz)
    flops = 2 * n * f * hc + 2 * nnz * hc
    peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_FP32_FLOPS
    bound_ms, bound_by = bound(nbytes, flops, peak)
    log(f"kernel1 banded_gat_mean_fused {dtype_name} N {n} Wcols "
        f"{mask.shape[-1]} nnz {nnz}: max_abs_err {err:.3e} (tol "
        f"{GAT_TOL[dtype_name]} x {scale:.3e}) ms {ms:.4f} (eager "
        f"{eager_ms:.4f}) plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} "
        f"({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def check_epilogue(mode, n_pad, n_valid, gen):
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.epilogue import (
        fused_epilogue_fwd, fused_epilogue_fwd_plain)

    dev = torch.device("cuda")
    dx, dxn = {"float32": ("float32", "float32"),
               "bfloat16": ("bfloat16", "bfloat16"),
               "mixed": ("float32", "bfloat16")}[mode]
    x = (torch.randn(n_pad, HIDDEN, generator=gen)
         + torch.randn(HIDDEN, generator=gen)).to(dev, getattr(torch, dx))
    xn = torch.randn(n_pad, HIDDEN, generator=gen).to(dev, getattr(torch, dxn))
    scale = (1 + 0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
    args = (x, xn, scale, bias, n_valid, 1e-5)
    got, _, _ = fused_epilogue_fwd(*args)
    ref, _, _ = fused_epilogue_fwd_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    if not (torch.isfinite(got).all() and err <= EPI_TOL[mode]
            * max(ref.float().abs().max().item(), 1.0)):
        raise AssertionError(f"fused_epilogue_fwd {mode}: max err {err}")
    ms = graph_time_ms(lambda: fused_epilogue_fwd(*args))
    eager_ms = cuda_time_ms(lambda: fused_epilogue_fwd(*args))
    plain_ms = graph_time_ms(lambda: fused_epilogue_fwd_plain(*args))
    # each input read once (x, x_new, scale, bias), y written once
    nbytes = (x.numel() * x.element_size() + xn.numel() * xn.element_size()
              + 2 * HIDDEN * 4 + got.numel() * got.element_size())
    flops = 8 * x.numel()   # add, square, 2 accumulates, sub, mul, add, max
    bound_ms, bound_by = bound(nbytes, flops, H100_FP32_FLOPS)
    log(f"kernel2 fused_epilogue_fwd {mode} [{n_pad}, {HIDDEN}]: max_abs_err "
        f"{err:.3e} ms {ms:.4f} (eager {eager_ms:.4f}) plain_ms "
        f"{plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain versions (on the card)."""
    from gnn_bfs_rans_tpu_torch.kernels import banded, epilogue
    from gnn_bfs_rans_tpu_torch.models import convs, norm

    saved = convs.banded_gat_mean_fused, norm.fused_epilogue_fwd
    convs.banded_gat_mean_fused = banded.banded_gat_mean_fused_plain
    norm.fused_epilogue_fwd = epilogue.fused_epilogue_fwd_plain
    try:
        yield
    finally:
        convs.banded_gat_mean_fused, norm.fused_epilogue_fwd = saved


def serve(tmp, gen):
    """Phase 4; returns the launch counts of the main path."""
    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
    from gnn_bfs_rans_tpu_torch.foam import box_fields, generate_box_case
    from gnn_bfs_rans_tpu_torch.infer import Predictor, load_graph
    from gnn_bfs_rans_tpu_torch.kernels import _build
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
    from gnn_bfs_rans_tpu_torch.train.checkpoint import save_checkpoint
    from gnn_bfs_rans_tpu_torch.train.normalization import FieldNormalizer

    case = tmp / "case"
    info = generate_box_case(case, 400, 30, 1)
    cfg = ModelConfig(hidden_dim=HIDDEN, num_layers=LAYERS, layer_type="GAT",
                      heads=HEADS, backend="pallas", compute_dtype="bfloat16")
    model = FlowGNN(cfg, generator=gen)
    norm = FieldNormalizer().fit(box_fields(info["cell_centers"]))
    save_checkpoint(tmp / "ckpt", "best", model.state_dict(),
                    model_config=cfg, normalizer=norm)

    runs = {"off": {"banded_gat_mean_fused": LAYERS},
            "on": {"banded_gat_mean_fused": LAYERS,
                   "fused_epilogue_fwd": 2 * LAYERS}}
    totals = {}
    _build.reset_launches()           # main path starts here
    for bn in ("off", "on"):
        before = dict(_build.LAUNCHES)
        out = tmp / f"pred_{bn}"
        rc = cli_main(["infer", "--checkpoint", str(tmp / "ckpt"),
                       "--case_path", str(case), "--output_dir", str(out),
                       "--save_format", "both", "--reference_time", "100",
                       "--bn_exact", bn, "--device", "cuda"])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"infer --bn_exact {bn} returned {rc}")
        moved = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
        moved = {k: v for k, v in moved.items() if v}
        if moved != runs[bn]:
            raise AssertionError(f"--bn_exact {bn}: launches {moved}, "
                                 f"expected {runs[bn]}")
        for name in ("predicted/U", "predicted/nut", "comparison.json"):
            if not (out / name).is_file():
                raise AssertionError(f"{out / name} missing")
        pred = dict(np.load(out / "predictions.npz"))
        if pred["U"].shape != (info["n_cells"], 3) or not all(
                np.isfinite(v).all() for v in pred.values()):
            raise AssertionError(f"bad predictions for --bn_exact {bn}")
        # the same predictor through the plain versions, on the card
        predictor = Predictor.from_checkpoint(tmp / "ckpt", exact_bn=bn == "on")
        graph = load_graph(case).to("cuda")
        with plain_versions():
            plain = predictor.predict_fields(graph)
        for k, v in plain.items():
            err = float(np.abs(pred[k] - v).max())
            tol = SERVE_TOL * max(float(np.abs(v).max()), 1e-6)
            log(f"serve --bn_exact {bn} {k}: max_abs_err vs plain {err:.3e} "
                f"(tol {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"--bn_exact {bn} field {k} off by {err}")
        totals = dict(_build.LAUNCHES)
    # forward time and where it goes (after the main path's counts were read)
    for bn in ("off", "on"):
        predictor = Predictor.from_checkpoint(tmp / "ckpt", exact_bn=bn == "on")
        graph = load_graph(case).to("cuda")
        with torch.inference_mode():
            def fwd():
                return predictor.model(graph, exact_bn=predictor.exact_bn)
            host = host_time_ms(fwd)
            device_ms = graph_time_ms(fwd, calls=5, replays=4)
            profile_forward(fwd, f"--bn_exact {bn}")
        log(f"serve forward bf16 {LAYERS}x{HIDDEN}x{HEADS}h N "
            f"{graph.n_nodes} --bn_exact {bn}: host clock median "
            f"{host[1]:.4f} ms (quartiles {host[0]:.4f}, {host[2]:.4f}; "
            f"20 forwards), device time in a CUDA graph {device_ms:.4f} ms")
    return totals


def host_time_ms(fn, reps=20, warmup=3):
    """Quartiles of the host-clock time of ``fn`` ending in a synchronize."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.quantiles(times, n=4)


def profile_forward(fwd, label, steps=5):
    """Device time by kernel over ``steps`` forwards (torch.profiler), and
    the card's busy share of the host-clock window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            fwd()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    busy = sum(by_name.values())
    if busy == 0:
        log(f"profile {label}: the profiler recorded no device time")
        return
    log(f"profile {label}: {busy / steps:.1f} us device per forward, "
        f"{wall_us / steps:.1f} us wall, idle share {1 - busy / wall_us:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {us / steps:9.1f} us  {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (REPO / "gnn_bfs_rans_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.foam import generate_box_case
    from gnn_bfs_rans_tpu_torch.kernels import _build

    t0 = time.time()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.time() - t0:.1f} s")
    for name in libs:
        ptxas = (_build.BUILD_DIR / f"lib{name}.log").read_text()
        log("\n".join(ln for ln in ptxas.splitlines()
                      if "registers" in ln or "spill" in ln))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")

    gen = torch.Generator().manual_seed(0)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for nx, ny in ((163, 75), (400, 30)):
            generate_box_case(tmp / f"box{nx}", nx, ny, 1)
            graph = load_graph(tmp / f"box{nx}").to("cuda")
            for dt in ("float32", "bfloat16"):
                rows[("gat", nx, dt)] = check_gat(graph, dt, gen)
        n_pad, n_valid = graph.n_pad, graph.n_nodes
        for mode in ("float32", "mixed", "bfloat16"):
            rows[("epi", mode)] = check_epilogue(mode, n_pad, n_valid, gen)
        t1 = time.time()
        launches = serve(tmp, gen)
        log(f"serving phase: {time.time() - t1:.1f} s")

    kernels = [
        dict(name="banded_gat_mean_fused", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/banded_gat.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded.py:991",
             launches=launches.get("banded_gat_mean_fused", 0),
             library_ms=None, **rows[("gat", 400, "bfloat16")]),
        dict(name="fused_epilogue_fwd", route="triton",
             source="gnn_bfs_rans_tpu_torch/kernels/epilogue.py",
             replaces="gnn_bfs_rans_tpu/kernels/epilogue.py:217",
             launches=launches.get("fused_epilogue_fwd", 0),
             library_ms=None, **rows[("epi", "bfloat16")]),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    log(f"total: {time.time() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
