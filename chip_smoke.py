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
3. kernel 2, ``fused_epilogue_fwd`` (CUDA, one cooperative launch),
   against its plain version at [12,032, 256] in f32, bf16 and mixed;
4. serving: a seeded 4-layer, hidden-256, 4-head bf16 GAT checkpoint served
   through ``python -m gnn_bfs_rans_tpu_torch infer`` (in process, through
   ``main(argv)``) with ``--bn_exact off`` and ``--bn_exact on``; the launch
   counters must show the kernels carried both runs, the outputs must be
   finite and written, and the fields must agree with the same predictor
   run through the plain versions on the card; then the forward's host-clock
   time, its device time (replayed as a CUDA graph) and a torch.profiler
   breakdown by kernel with the card's idle share;
5. kernel 1 in its training form (attention dropout 0.1, z emitted) against
   its plain version on both bands, in f32 and bf16, timed beside one
   ``torch.matmul(x, W)``, its projection's yardstick;
6. the GAT backward, rows 5 and 6 (``banded_gat_bwd``, ``fold_project_bwd``)
   through the autograd op at the flagship width (F 256, H 4, C 256) on both
   bands, f32 and bf16, dropout 0 and 0.1: (dW, dWa, dx) against the op run
   through the plain versions;
7. the BN epilogue backward, row 3 (``fused_epilogue_bwd``, one
   cooperative CUDA launch), and the forward at rate 0.1, at [12,032, 256]
   in f32, bf16 and mixed; rows 3 and 2 at 40,000 and 60,000 rows (their
   read-back branches) in each mode, and three calls of each captured in a
   CUDA graph whose replays must agree byte for byte with each other and
   an eager call;
8. one train step of the 4×256 GAT from the same seeded parameters through
   the kernels and through the plain versions, in f32, bf16 and mixed: the
   loss and each parameter group's gradient (f32: the largest relative gap
   held to 3e-2; bf16 and mixed: the distance from the plain versions' f32
   step on the same masks held to 1.5 × the plain bf16 step's own); the f32
   step again at dropout 0, through every kernel and through row 6 alone
   (the plain versions for the rest); row 6 against its plain version at
   the main path's three shapes (the GAT form, the Transformer's wblk form
   on the row-strided q block, the bias form), f32 and bf16, at N 12,032
   and a ragged 12,000, each timed beside its torch.matmul calls and bound;
9. row 8, ``banded_spmm`` (CUDA), forward and backward (through the autograd
   op, on the transposed band) against the plain versions at F 256: the
   ``gcn`` (f32) and ``adj`` (bf16) planes, x in f32 and bf16, on the
   400×30 box (W 3) and a 200×150 box (W 5), with cuSPARSE's time of the
   same product beside the kernel's; row 4, ``banded_gat_mean`` (CUDA),
   against its plain version and its op's (dW, dWa, dx) against the plain
   versions, rate 0 and 0.1, f32 and bf16, on both GAT bands;
10. GCN and GIN serving at 6×256 through ``infer`` (``--bn_exact off|on``):
    the default ``ModelConfig`` (GCN, f32) and its bf16 form, and GIN in
    bf16, each as in phase 4;
11. one train step through the kernels vs the plain versions, as in phase
    8, for GCN 6×256 (f32, bf16, mixed), GIN 6×256 (f32) and the unfused
    GAT 4×256 (``fuse_train=False``, bf16);
12. training, each path with the launch counters set to 0 just before and
    read just after: ``python -m gnn_bfs_rans_tpu_torch train`` (in process)
    on the 12,000-cell box case with three snapshots, (a) the flagship GAT
    (``--layer_type GAT``, bf16, dropout 0.1, 6 epochs) and (b) the CLI's
    default model (GCN, 6×256, f32, 4 epochs): every kernel of the path
    launched, the loss finite and lower in the last epoch than in the first,
    and the checkpoint then served by ``infer``; (c) the unfused GAT
    (bf16) for 2 epochs through the ``Trainer``.  On the card the
    ``Trainer`` replays CUDA graphs of its steps, and the counters count
    each replay's launches;
13. row 9, ``banded_transformer_fwd`` (CUDA), against its plain version on
    the Transformer bands of both boxes (Wcols 256 and 384) at F 256, H 4,
    C 256, f32 and bf16: no conditioning, the geo form (the boxes' own
    geometric features) and the generic edge form (a band built from
    random features), each with the head mean and concat; row 11,
    ``banded_transformer_geo_mean_fused`` (CUDA), against its plain version
    in f32 and bf16; SDPA on pre-windowed k/v timed beside row 9;
14. Transformer serving through ``infer`` as in phase 4: 4×256 bf16 (geo,
    ``--bn_exact off|on``), f32, ``fuse_eval`` (row 11 in eval, row 9 under
    ``--bn_exact on``), without edge features, and 8×256 bf16 (the depth of
    ``BASELINE.json`` config 4);
15. Transformer training (before phase 12, which it shares a case
    with): row 9 in its dropout form (rate 0.1) and row 10,
    ``banded_transformer_bwd`` (CUDA), against their plain versions on
    both Transformer bands, every form (no conditioning, edge, geo; head
    mean and concat; row 10 with the cotangent of s, rate 0 and 0.1), f32
    and bf16; row 7, ``fold_partials`` (CUDA), on row 10's partials, with
    ``index_add_``'s time beside it; row 6's bias form at the projgrad
    backward's shape and the projection ``transformer_project`` (on
    ``gemm_sm90.cuh``, timed beside ``torch.addmm`` + ``torch.matmul``); the
    projgrad op (projection, rows 9, 10, 7, 6) through the kernels vs the
    plain versions, f32 and bf16, rate 0 and 0.1; one train step of the
    4×256 Transformer, kernels vs plain versions, in f32, bf16 and mixed
    (row 10's two passes timed by kernel name in torch.profiler);
    ``python -m gnn_bfs_rans_tpu_torch train --layer_type Transformer``
    (4×256, bf16, dropout 0.1, geo, 4 epochs): every kernel of the path
    launched, the loss lower in the last epoch than in the first, the
    checkpoint served by ``infer``; the no-edge path through the
    ``Trainer`` (rows 9, 10, 7 launched);
16. rows 4 (concat) and 5 (per-head): ``banded_gat`` and
    ``banded_gat_bwd(..., mean_expand=False)`` (CUDA) against their plain
    versions on both GAT bands at the flagship width, f32 and bf16, rate 0
    and 0.1, timed beside their bounds; one forward and backward of
    ``GATConv(256, heads=4, concat=True)`` through the kernels vs the plain
    versions, f32 and bf16, its launch counts showing rows 4 and 5; the
    three backends on the card: every conv at hidden 256 (GAT and the
    Transformer also concat), its ``dense`` and ``segment`` outputs and
    gradients against the banded path's on the same weights; the GAT
    4×256 bf16 served through ``infer`` (as in phase 4) on a 24×24×24 hex
    box, which has no band (the dense branches); ``train --backend dense``
    (the JAX CLI's default backend: GCN 6×256 f32, 4 epochs) and
    ``--backend dense --norm_type layer`` (2 epochs), each lowering the
    loss and served by ``infer``; their train steps' times;
17. the CUDA graphs (after phase 12, on its case): for
    gat4x256-bf16-train, gcn6x256-f32-train, transformer4x256-bf16-train
    and transformer8x256-bf16-train, three replays of the ``Trainer``'s
    train-step graph against three eager steps from the same parameters,
    Adam state and generator state, bit for bit, at dropout 0 and 0.1, and
    two replays from one state that must draw different masks; then the
    host-clock quartiles of 20 steps, eager and replayed, each with its
    device time (the profiler's kernel sum; for the replays also the span
    of 20 back-to-back replays between CUDA events) and idle share, and
    (GAT) an eager step's device time with each Adam form (foreach;
    foreach and capturable; the port's fused and capturable);
    ``python -m gnn_bfs_rans_tpu_torch train --epoch_block 3`` of the
    flagship GAT (bf16, dropout 0.1, 6 epochs, checkpoints every 3; the
    counters set to 0 just before and read just after): rows 1, 2, 3, 5
    and 6 launched under the replays, the loss lower in the last epoch,
    the checkpoint served by ``infer``; one block of 6 epochs replayed,
    its host wall, card span and idle share; the GAT 4×256 bf16
    ``Predictor`` replayed against its eager forward (bit for bit; host
    quartiles each way), ``exact_bn`` off and on;
18. the bench harness (``gnn_bfs_rans_tpu_torch/utils/``), in process, each
    run with the launch counters set to 0 just before and read just after,
    and its JSON printed on a line of its own: (a) the headline entry
    ``gnn_bfs_rans_tpu_torch.bench`` (GAT 4×256 bf16 forward on the 400×30
    box; row 1; MFU against the card's peaks; its chained marginal time
    within 15% of the replayed ``Predictor``'s span), (b) ``bench --mode
    train --trace`` (GAT 4×256 bf16; rows 1, 2, 3, 5, 6; the trace's
    device total above 0; parameters finite), (c) the Transformer 8×256
    bf16 forward (row 9), (d) GCN 6×256 f32 (row 8), (e) ``bench
    --synthetic 1000000`` (GAT 4×256 bf16 on a 96 × 10,416 grid, row 1)
    and ``run_scale_benchmark(mode="train")`` there (rows 1, 2, 3, 5, 6),
    with the grid's host build time; then the 12,000-cell case's serving
    wall time by stage (checkpoint load, case read, graph build with RCM
    and band, forward, OpenFOAM writeback);
19. reference checkpoints: five models of the reference's own
    architecture (``compat/torch_ref.py::RefFlowGNN``, PyG semantics) at
    its defaults (hidden 256, 6 layers, 4 heads, dropout 0.1, BatchNorm;
    PyTorch's own initialization under a fixed seed) — GCN, GAT, GIN, Transformer without edges (as the reference
    builds it) and with ``lin_edge`` — each with its BatchNorm statistics
    warmed by three train-mode forwards on the card and saved with
    ``torch.save`` in the reference's ``.pt`` format; each loaded by
    ``Predictor.from_torch_checkpoint`` and served on the 400×30 box
    through the kernels (rows 8, 1, 9; the counters set to 0 just before
    and read just after), eager and replayed (bit for bit), its normalized
    output within rtol 1e-3, atol 5e-4 of RefFlowGNN's eval forward on the
    card (the mesh's own cell order, no reordering) and its denormalized
    fields within rtol 1e-3, atol 1e-3·max|field| + 1e-3·std of the field
    (the JAX package's parity bound, ``tests/test_parity_torch.py``), and
    within SERVE_TOL of the plain versions; its replayed forward's device
    span, host times and idle share; the GAT again with ``exact_bn`` (row
    2) against RefFlowGNN in train mode with dropout off; ``export-torch``
    of a seeded GAT 4×256 bf16 port checkpoint (every bias and BatchNorm
    tensor drawn away from its initial value), reloaded by RefFlowGNN
    with ``strict=True`` (every tensor on the CPU), its f32 forward within
    the f32 tolerance (rtol 1e-5, atol 1e-5·max|output|) of the port's f32
    forward; the mixed hex/prism case
    (``generate_mixed_prism_case(16, 16, 7)``: SpMM window 5) through
    ``predict_case`` with a GCN and a GAT 6×256 f32 checkpoint, rows 8 and
    1 against their plain versions on its band; ``check-data`` and
    ``check-coordinates`` on the box (exit code 0);
20. scale-out (``parallel/``, ``models/partitioned.py``,
    ``train/streaming.py``, ``utils/dp_bench.py``): rows 1 (GAT eval), 4 +
    5 + 6 (the unfused GAT's training, dropout 0.1), 8 (GCN f32) and 9 (the
    Transformer's geo head mean) on shards 0, 1 and 3 of a 4-shard
    partition of a 96 × 64 grid (halo 128: the slices of the band, their
    all-zero outer halo tiles and patched ``bias_self`` diagonal), each
    against its plain version on the shard and its owned rows against the
    same conv on the whole grid; then, in a NCCL group of
    ``torch.cuda.device_count()`` ranks (1 on a one-card machine: the
    multi-rank exchange needs a card a rank), the partitioned GAT 4×256
    forward (f32, bf16) against ``FlowGNN``'s and its train step against
    ``train_step`` with ``fuse_epilogue=False, fuse_train=False`` (and on
    more cards the same on spawned NCCL ranks); the DP step (4 snapshots)
    against ``train_step``, the multi-case step on 4 perturbed boxes and
    its forward's case order, ``train_multicase_streamed`` (2 epochs,
    ``Prefetcher(depth=2)``; these steps replay their CUDA graphs); one
    125,000-cell shard of a 1M-cell grid (``run_partition_shard_benchmark``,
    hidden 256); and a step with and without ``remat`` (GAT 4×256 unfused
    and Transformer 4×256, bf16, dropout 0.1) from one state and generator,
    bit for bit, with peak memory and step time on the box and a
    250,080-cell grid; each reading beside the card's name and power
    limit.  ``python3 chip_smoke.py --phase 20`` runs this phase alone
    (no kernel table, no result line);
21. the last modules: ``FlowGNNSurrogate`` on the 400×30 box with a
    boundary embedding, GCN 6×256 f32 (row 8) and GAT 4×256 bf16 under
    ``exact_bn`` (rows 1, 2), its launches, the kernels against the plain
    versions and its replayed forward against the eager one, with span,
    host time and idle; ``train-multitopo`` through the CLI on three boxes
    in two buckets (12,000 and 12,090 cells share one, 6,000 cells have
    their own), then one step graph a bucket replayed case by case against
    eager steps bit for bit (on the cases' GCN bands) and each bucket's
    replayed step against the eager one in time; in a NCCL group of one
    rank the DP, multi-case and partitioned steps (GAT 4×256 bf16, dropout
    0.1) and the partitioned forward replayed against their eager forms bit
    for bit, with host, device, span and idle both ways, the streamed
    multi-case loop (8 cases in chunks of 3: the short last chunk on its
    own graph) against eager steps on the same chunks, and ``bench --mode
    dp --devices 1`` (``timing: chained_replay``); the native and numpy
    walks of the 100,000-cell mixed prism case's faces, equal, with their
    host times.  ``python3 chip_smoke.py --phase 21`` runs this phase alone;
22. MeshGraphNets (``kernels/mgn.py``, ``csrc/mgn_edge.cu``): the edge
    block over the benchmark grid's 994,918 receiver-sorted edges and the
    node block over its 250,112 rows, latent 128, bf16, with the launch
    counts set to 0 just before: each launch counted by kernel
    (``mgn_edge_fwd``, ``mgn_edge_fixup`` in each direction,
    ``mgn_edge_bwd``, ``mgn_edge_senders``; ``mgn_node_fwd``,
    ``mgn_node_bwd``), every output and cotangent against
    ``mgn_edge_plain`` / ``mgn_node_plain`` (``MGN_TOL_RATIO``: a limit the
    same block in 8-bit floats fails), the training forward and the
    backward timed beside the plain versions and their bounds; then one
    train step of the 15 × 128 bf16 model on the 400×30 box, whose launch
    counts the kernel table gives.  ``python3 chip_smoke.py --phase 22``
    runs this phase alone and prints its rows of the kernel table;
23. print the kernel table as one JSON line, then the result line.

Kernel times (``ms``, ``plain_ms``, ``library_ms``) are device times per
call: ten calls captured in one CUDA graph and replayed, so host launch
overhead does not enter them (MeshGraphNets' blocks: five calls; their
plain versions' times are eager, between CUDA events); the eager per-call
time is printed beside them.  ``launches`` counts each wrapper's launches on its training path
(phase 12: the flagship GAT's for rows 1, 2, 3, 5, 6; the GCN run's for
row 8; the unfused GAT run's for row 4; phase 15's Transformer run for
rows 10 and 7 and ``transformer_project``, which is no TPU kernel but the
hand-written form of the JAX op's XLA products; phase 16's concat conv,
bf16, for row 4's concat form and
row 5's per-head form); rows 9 and 11 count theirs on the Transformer
serving path (the 4×256 bf16 ``--bn_exact off`` run and the ``fuse_eval``
run); MeshGraphNets' two rows count each kernel's launches in one train
step of the 15 × 128 model (phase 22).

Needs no network; builds into ``gnn_bfs_rans_tpu_torch/build`` and writes
scratch files only under the temporary directory.
"""

import contextlib
import dataclasses
import functools
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# dense tensor-core bf16 FLOP/s and HBM bytes/s: the card's entry in
# gnn_bfs_rans_tpu_torch/utils/roofline.py::DEVICE_PEAKS, set by main()
H100_BF16_FLOPS = H100_BYTES_PER_S = None
H100_FP32_FLOPS = 67e12    # FP32 outside the tensor cores (NVIDIA data sheet)
HIDDEN, HEADS, LAYERS = 256, 4, 4
GAT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}    # × max |plain output|
EPI_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "mixed": 1e-5}
SERVE_TOL = 5e-2                                  # × max |plain field|
# or, for the bf16 Transformer cells, whose roundings compound with depth
# (a field of a random 8-layer model may sit near 0: p reads max 0.008,
# where 5e-2 of its own size is 4e-4): the kernels' fields no further (max
# abs) from the plain versions' f32 forward of the same weights than this
# multiple of the plain bf16 forward's own distance
SERVE_F32_RATIO = 1.5
# × max |plain cotangent|: f32 summation order; bf16 one rounding of dz or
# an output may flip (2^-8 relative) and dx, dW sum such values
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# One train step, kernels vs plain versions.  The f32 loss: summation
# order only (bf16, mixed: bf16 roundings).  The f32 gradients: a ReLU
# whose input lies within rounding of 0
# takes the other branch on one side, and each such element moves a weight
# gradient (a sum over N = 12,000 rows that largely cancels) by about
# 1/√N ≈ 1% of its largest entry; a wrong kernel moves it by O(1).
STEP_LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3, "mixed": 1e-3}  # × |loss|
# × max |plain gradient| per parameter group; or, where the plain versions
# themselves move further on an input moved by one f32 ulp (the rounding
# floor of that step: one ReLU flip in the last block moves a cancelling
# group by 3.25e-2 in the Transformer 4×256 without edges on the H100),
# STEP_F32_RATIO times their worst gap
STEP_TOL_F32 = 3e-2
# bf16 and mixed: each group's gradient through the kernels lies no further
# from the plain versions' f32 gradient (norms) than this multiple of the
# plain versions' own bf16 (mixed) gradient does, plus 1e-4 of the group's
# norm: the kernel path is as accurate as the plain path it mirrors, which
# rounds at the same points
STEP_F32_RATIO = 1.5
# a conv bias that feeds the BatchNorm has a zero gradient in exact
# arithmetic: both paths give rounding noise, whose two sizes a ratio cannot
# compare; it is held to zero up to one bf16 rounding (2^-8) of the largest
# group's norm (measured ≤ 8.2e-4 of it)
ZERO_GRAD_TOL = 2.0 ** -8
TRAIN_EPOCHS = 6
TRAIN_TIMES = ("100", "200", "282")
DROPOUT = 0.1
# the GCN / GIN model: the JAX CLI's default (6 layers, hidden 256)
GCN_LAYERS = 6
GCN_EPOCHS = 4
# row 8 vs its plain version: f32 exact products summed in another order;
# bf16 x: the f32 sum rounds once to bf16 on both sides, an order change
# may flip it (2^-8 relative)
SPMM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}      # × max |plain output|
# the conv kernel a layer type launches once per layer and forward
CONV_KERNEL = {"GAT": "banded_gat_mean_fused", "GCN": "banded_spmm",
               "GIN": "banded_spmm", "Transformer": "banded_transformer_fwd"}
# the Transformer of BASELINE.json config 4 (8 layers, hidden 256)
TR_DEEP_LAYERS = 8
TR_EPOCHS = 4
# rows 9 and 11's s, by column group: both dtypes compute it in f32 from
# the same inputs, so each group is held to S_TOL of its own max (row 11 in
# bf16 to GAT_TOL: its q and k come from two different bf16 products).  The
# geo form's direction columns (0-2 of each head) also cancel terms of size
# max|pos|·max(1/dist) (400 on the 400×30 box) into values ≤ 1: plus
# S_CANCEL_TOL of that size (measured f32 gap ≤ 2.5e-7 of it)
S_TOL = 1e-4
S_CANCEL_TOL = 1e-6
# the dense and segment branches vs the banded path (f32, × max |banded|):
# the same functions by other summation orders, the Transformer's edge term
# factorised through the geo planes on the banded side; a wrong branch
# moves a value by O(1)
BACKEND_TOL = 1e-3


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
    # each input read once (x, x_new, scale, bias), y and the residual xr
    # (kept for the backward) written once
    nbytes = (x.numel() * x.element_size() + xn.numel() * xn.element_size()
              + 2 * HIDDEN * 4 + 2 * got.numel() * got.element_size())
    flops = 8 * x.numel()   # add, square, 2 accumulates, sub, mul, add, max
    bound_ms, bound_by = bound(nbytes, flops, H100_FP32_FLOPS)
    log(f"kernel2 fused_epilogue_fwd {mode} [{n_pad}, {HIDDEN}]: max_abs_err "
        f"{err:.3e} ms {ms:.4f} (eager {eager_ms:.4f}) plain_ms "
        f"{plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


@contextlib.contextmanager
def plain_versions(keep=()):
    """Route every kernel call of the model, forward and backward, to the
    plain versions (on the card), but the kernels named in ``keep``."""
    from gnn_bfs_rans_tpu_torch.kernels import banded, banded_bwd, epilogue
    from gnn_bfs_rans_tpu_torch.models import convs, norm

    swaps = [
        (convs, "banded_gat_mean_fused", banded.banded_gat_mean_fused_plain),
        (banded, "banded_gat_mean_fused", banded.banded_gat_mean_fused_plain),
        (banded, "_gat_attention", banded._attention_plain),
        (banded, "banded_spmm_fwd", banded.banded_spmm_plain),
        (banded, "_transformer_fwd", banded.banded_transformer_fwd_plain),
        (banded, "transformer_project", banded.transformer_project_plain),
        (convs, "banded_transformer_geo_mean_fused",
         banded.banded_transformer_geo_mean_fused_plain),
        # the plain version reads no transposed mask
        (banded_bwd, "banded_gat_bwd",
         lambda *a, mask_t, **k: banded_bwd.banded_gat_bwd_plain(*a, **k)),
        (banded_bwd, "fold_project_bwd", banded_bwd.fold_project_bwd_plain),
        (banded_bwd, "banded_transformer_bwd",
         banded_bwd.banded_transformer_bwd_plain),
        (banded_bwd, "fold_partials", banded_bwd.fold_partials_plain),
        (norm, "fused_epilogue_fwd", epilogue.fused_epilogue_fwd_plain),
        (epilogue, "_forward", epilogue._forward_plain),
        (epilogue, "fused_epilogue_bwd", epilogue.fused_epilogue_bwd_plain),
    ]
    swaps = [sw for sw in swaps if sw[1] not in keep]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def serve(tmp, case, info, cfg, label, gen, runs=None, f32_ratio=False):
    """Serve a seeded checkpoint of ``cfg`` through ``infer`` with
    ``--bn_exact off`` and ``on``: launches (``runs``: the counts each run
    must show, by default the conv kernel once per layer and, ``on``, the
    epilogue twice per layer), outputs, fields against the plain versions
    (``f32_ratio``: or by SERVE_F32_RATIO), then the forward's times.
    Returns the launch counts of each ``infer`` run (the serving path), by
    ``off`` / ``on``."""
    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
    from gnn_bfs_rans_tpu_torch.foam import box_fields
    from gnn_bfs_rans_tpu_torch.infer import Predictor, load_graph
    from gnn_bfs_rans_tpu_torch.kernels import _build
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN
    from gnn_bfs_rans_tpu_torch.train.checkpoint import save_checkpoint
    from gnn_bfs_rans_tpu_torch.train.normalization import FieldNormalizer

    ckpt = tmp / f"ckpt_{label}"
    model = FlowGNN(cfg, generator=gen)
    norm = FieldNormalizer().fit(box_fields(info["cell_centers"]))
    save_checkpoint(ckpt, "best", model.state_dict(), model_config=cfg,
                    normalizer=norm)
    conv = CONV_KERNEL[cfg.layer_type]
    layers = cfg.num_layers
    runs = runs or {"off": {conv: layers},
                    "on": {conv: layers, "fused_epilogue_fwd": 2 * layers}}
    counts = {}
    for bn in ("off", "on"):
        _build.reset_launches()       # each serving run starts here
        out = tmp / f"pred_{label}_{bn}"
        rc = cli_main(["infer", "--checkpoint", str(ckpt),
                       "--case_path", str(case), "--output_dir", str(out),
                       "--save_format", "both", "--reference_time", "100",
                       "--bn_exact", bn, "--device", "cuda"])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"{label} infer --bn_exact {bn} returned {rc}")
        moved = {k: v for k, v in _build.LAUNCHES.items() if v}
        if moved != runs[bn]:
            raise AssertionError(f"{label} --bn_exact {bn}: launches {moved}, "
                                 f"expected {runs[bn]}")
        for name in ("predicted/U", "predicted/nut", "comparison.json"):
            if not (out / name).is_file():
                raise AssertionError(f"{out / name} missing")
        pred = dict(np.load(out / "predictions.npz"))
        if pred["U"].shape != (info["n_cells"], 3) or not all(
                np.isfinite(v).all() for v in pred.values()):
            raise AssertionError(f"bad {label} predictions, --bn_exact {bn}")
        counts[bn] = moved            # ... and ends here
        # the same predictor through the plain versions, on the card
        predictor = Predictor.from_checkpoint(ckpt, exact_bn=bn == "on")
        graph = load_graph(case, cfg.layer_type).to("cuda")
        with plain_versions():
            plain = predictor.predict_fields(graph)
            plain32 = None
            if f32_ratio:
                # the same weights through the plain versions in f32
                f32 = FlowGNN(dataclasses.replace(cfg,
                                                  compute_dtype="float32"))
                f32.load_state_dict(predictor.model.state_dict())
                predictor.model = f32.eval().to("cuda")
                plain32 = predictor.predict_fields(graph)
        for k, v in plain.items():
            err = float(np.abs(pred[k] - v).max())
            tol = SERVE_TOL * max(float(np.abs(v).max()), 1e-6)
            msg = (f"serve {label} --bn_exact {bn} {k}: max_abs_err vs plain "
                   f"{err:.3e} (tol {tol:.3e})")
            ok = err <= tol
            if plain32 is not None:
                own = float(np.abs(v - plain32[k]).max())
                dist = float(np.abs(pred[k] - plain32[k]).max())
                msg += (f"; max abs from the plain f32 forward: kernels "
                        f"{dist:.3e}, plain {own:.3e} (ratio "
                        f"{dist / max(own, 1e-30):.2f})")
                ok = ok or dist <= SERVE_F32_RATIO * own
            log(msg)
            if not ok:
                raise AssertionError(f"{label} --bn_exact {bn} field {k} off "
                                     f"by {err}")
    # forward time and where it goes (after the serving path's counts)
    for bn in ("off", "on"):
        predictor = Predictor.from_checkpoint(ckpt, exact_bn=bn == "on")
        graph = load_graph(case, cfg.layer_type).to("cuda")
        with torch.inference_mode():
            def fwd():
                return predictor.model(graph, exact_bn=predictor.exact_bn)
            host = host_time_ms(fwd)
            device_ms = graph_time_ms(fwd, calls=5, replays=4)
            profile_forward(fwd, f"{label} --bn_exact {bn}")
        log(f"serve forward {label} N {graph.n_nodes} --bn_exact {bn}: host "
            f"clock median {host[1]:.4f} ms (quartiles {host[0]:.4f}, "
            f"{host[2]:.4f}; 20 forwards), device time in a CUDA graph "
            f"{device_ms:.4f} ms")
    return counts


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


def profile_forward(fwd, label, steps=5, with_idle=False, top=12):
    """Device time by kernel over ``steps`` calls of ``fwd``
    (torch.profiler), and the card's busy share of the host-clock window;
    returns the device µs per call (None when nothing was recorded), and
    with ``with_idle`` the idle share beside it."""
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
    # device events, less the annotation ranges (Adam's step shows as one)
    # that span kernels already counted
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    busy = sum(by_name.values())
    if busy == 0:
        log(f"profile {label}: the profiler recorded no device time")
        return (None, None) if with_idle else None
    idle = 1 - busy / wall_us
    log(f"profile {label}: {busy / steps:.1f} us device per call, "
        f"{wall_us / steps:.1f} us wall, idle share {idle:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {us / steps:9.1f} us  {name[:90]}")
    return (busy / steps, idle) if with_idle else busy / steps


def event_time_ms(fn, calls=20):
    """Device time per call of ``fn`` called ``calls`` times back to back,
    between two CUDA events: the span of the card's work when the host
    keeps ahead of it (replayed graphs)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls




def _rel_err(got, ref):
    """(max abs error, max |ref|) of two tensors, in f32."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, ref.float().abs().max().item()


def _gat_inputs(n, dt, gen):
    import torch

    dev = torch.device("cuda")
    f, hc = HIDDEN, HEADS * HIDDEN
    x = torch.randn(n, f, generator=gen).to(dev, dt)
    w = (torch.randn(f, hc, generator=gen) * f ** -0.5).to(dev, dt)
    wa = (torch.randn(f, 2 * HEADS, generator=gen) * f ** -0.5).to(dev, dt)
    g = torch.randn(n, HIDDEN, generator=gen).to(dev, dt)
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    return x, w, wa, g, seed


def check_gat_train(graph, dtype_name, gen):
    """Phase 5: kernel 1's training form (dropout, z emitted) vs plain."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded import (
        banded_gat_mean_fused, banded_gat_mean_fused_plain)

    dt = getattr(torch, dtype_name)
    n = graph.n_pad
    x, w, wa, _, seed = _gat_inputs(n, dt, gen)
    alphas = (x.float() @ wa.float()).contiguous()
    mask = graph.band.bias_self
    args = (mask, w, alphas, x, HEADS, 0.2, DROPOUT, seed)
    got, z = banded_gat_mean_fused(*args, emit_z=True)
    ref, ref_z = banded_gat_mean_fused_plain(*args, emit_z=True)
    torch.cuda.synchronize()
    err, scale = _rel_err(got, ref)
    z_err, z_scale = _rel_err(z, ref_z)
    if not (torch.isfinite(got).all() and err <= GAT_TOL[dtype_name] * scale
            and z_err <= GAT_TOL[dtype_name] * z_scale):
        raise AssertionError(f"banded_gat_mean_fused training form "
                             f"{dtype_name}: max err {err} (z {z_err})")
    ms = graph_time_ms(lambda: banded_gat_mean_fused(*args, emit_z=True))
    plain_ms = graph_time_ms(
        lambda: banded_gat_mean_fused_plain(*args, emit_z=True), 3, 2)
    nnz = int(mask.sum().item())
    isz = x.element_size()
    f, hc = HIDDEN, HEADS * HIDDEN
    # inputs read once; out and the z residual written once
    nbytes = (mask.numel() + f * hc * isz + alphas.numel() * 4 + n * f * isz
              + n * HIDDEN * isz + n * hc * isz)
    flops = 2 * n * f * hc + 2 * nnz * hc
    peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_FP32_FLOPS
    bound_ms, bound_by = bound(nbytes, flops, peak)
    # the projection's yardstick: one torch.matmul of x by W (the
    # attention has no single PyTorch call)
    library_ms = graph_time_ms(lambda: torch.matmul(x, w))
    log(f"kernel1 training form {dtype_name} dropout {DROPOUT} Wcols "
        f"{mask.shape[-1]}: max_abs_err {err:.3e} (z {z_err:.3e}) ms "
        f"{ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} "
        f"({bound_by}) library_ms (torch.matmul(x, W)) {library_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_gat_bwd(graph, dtype_name, rate, gen, measure):
    """Phase 6: rows 5 and 6 through the autograd op vs the plain versions;
    with ``measure``, times of both kernels (returned as two rows)."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded import banded_gat_mean_fused_wa
    from gnn_bfs_rans_tpu_torch.kernels.banded_bwd import (
        banded_gat_bwd, banded_gat_bwd_plain, fold_project_bwd,
        fold_project_bwd_plain)

    dt = getattr(torch, dtype_name)
    n = graph.n_pad
    mask = graph.band.bias_self
    mask_t = graph.band.transposed("bias_self")
    x, w, wa, g, seed = _gat_inputs(n, dt, gen)
    seed = seed if rate else None
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (w, wa, x)]
        with plain_versions() if plain else contextlib.nullcontext():
            y = banded_gat_mean_fused_wa(mask, *leaves, HEADS, 0.2, rate, seed,
                                         mask_t)
            y.backward(g)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    for name, got, ref in zip(("dW", "dWa", "dx"), *grads):
        err, scale = _rel_err(got, ref)
        log(f"rows 5+6 {dtype_name} rate {rate} Wcols {mask.shape[-1]} {name}: "
            f"max_abs_err {err:.3e} (tol {BWD_TOL[dtype_name]} x {scale:.3e})")
        if not (torch.isfinite(got).all()
                and err <= BWD_TOL[dtype_name] * scale):
            raise AssertionError(f"GAT backward {name} {dtype_name} rate "
                                 f"{rate}: max err {err} vs {scale}")
    # row 5 alone on the op's own inputs, then row 6
    alphas = (x.float() @ wa.float()).contiguous()
    z = (x.float() @ w.float()).to(dt)
    a5 = (mask, z, alphas, g, HEADS, 0.2, rate, seed)
    kw5 = dict(mask_t=mask_t)
    dz, da = banded_gat_bwd(*a5, **kw5)
    ref_dz, ref_da = banded_gat_bwd_plain(*a5)
    dx, dw = fold_project_bwd(dz, x, w)
    ref_dx, ref_dw = fold_project_bwd_plain(dz, x, w)
    torch.cuda.synchronize()
    err5, scale5 = _rel_err(dz, ref_dz)
    err6, scale6 = _rel_err(dx, ref_dx)
    for what, err, scale in (("dz", err5, scale5), ("da", *_rel_err(da, ref_da)),
                             ("dx", err6, scale6), ("dW", *_rel_err(dw, ref_dw))):
        log(f"row {5 if what in ('dz', 'da') else 6} alone {dtype_name} rate "
            f"{rate} Wcols {mask.shape[-1]} {what}: max_abs_err {err:.3e} "
            f"(tol {BWD_TOL[dtype_name]} x {scale:.3e})")
        if not (torch.isfinite(dz).all()
                and err <= BWD_TOL[dtype_name] * scale):
            raise AssertionError(f"{what}: max err {err} vs {scale}")
    if not measure:
        return None
    ms5 = graph_time_ms(lambda: banded_gat_bwd(*a5, **kw5))
    plain5 = graph_time_ms(lambda: banded_gat_bwd_plain(*a5), 3, 2)
    ms6 = graph_time_ms(lambda: fold_project_bwd(dz, x, w))
    plain6 = graph_time_ms(lambda: fold_project_bwd_plain(dz, x, w), 3, 2)
    wt = w.t()
    lib6 = graph_time_ms(lambda: (dz @ wt, x.t() @ dz))
    isz = x.element_size()
    f, hc = HIDDEN, HEADS * HIDDEN
    nnz = int(mask.sum().item())
    # row 5: mask, z, α, g read once; dz and dα written once; its
    # arithmetic (f32, on the SIMT units) is the sparse products: dp and
    # dz, 2·C operations each per nonzero entry and head
    b5 = bound(mask.numel() + n * hc * isz + n * 2 * HEADS * 4
               + n * HIDDEN * isz + n * hc * isz + n * 2 * HEADS * 4,
               4 * nnz * hc, H100_FP32_FLOPS)
    # row 6: dz, x, W read once; dx and the f32 dW written once
    b6 = bound(n * hc * isz + n * f * isz + f * hc * isz + n * f * isz
               + f * hc * 4, 4 * n * f * hc,
               H100_BF16_FLOPS if dt == torch.bfloat16 else H100_FP32_FLOPS)
    log(f"row 5 banded_gat_bwd {dtype_name} rate {rate} N {n} nnz {nnz}: "
        f"max_abs_err {err5:.3e} ms {ms5:.4f} plain_ms {plain5:.4f} bound_ms "
        f"{b5[0]:.5f} ({b5[1]})")
    # its two passes by kernel name (the receiver pass, the sender pass)
    profile_forward(lambda: banded_gat_bwd(*a5, **kw5),
                    f"row 5 {dtype_name} by kernel", steps=10)
    log(f"row 6 fold_project_bwd {dtype_name}: max_abs_err {err6:.3e} ms "
        f"{ms6:.4f} plain_ms {plain6:.4f} library_ms (2 x torch.matmul) "
        f"{lib6:.4f} bound_ms {b6[0]:.5f} ({b6[1]})")
    return (dict(max_abs_err=err5, ms=ms5, plain_ms=plain5, bound_ms=b5[0],
                 bound_by=b5[1], library_ms=None),
            dict(max_abs_err=err6, ms=ms6, plain_ms=plain6, bound_ms=b6[0],
                 bound_by=b6[1], library_ms=lib6))


def check_epilogue_bwd(mode, n_pad, n_valid, gen):
    """Phase 7: kernel 2 at rate 0.1 and row 3 vs their plain versions."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.epilogue import (
        _forward, _forward_plain, fused_epilogue, fused_epilogue_bwd,
        fused_epilogue_bwd_plain)

    dev = torch.device("cuda")
    dx, dxn = {"float32": ("float32", "float32"),
               "bfloat16": ("bfloat16", "bfloat16"),
               "mixed": ("float32", "bfloat16")}[mode]
    x = (torch.randn(n_pad, HIDDEN, generator=gen)
         + torch.randn(HIDDEN, generator=gen)).to(dev, getattr(torch, dx))
    xn = torch.randn(n_pad, HIDDEN, generator=gen).to(dev, getattr(torch, dxn))
    scale = (1 + 0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    leaves = [t.clone().requires_grad_() for t in (x, xn, scale, bias)]
    y, _, _ = fused_epilogue(*leaves, seed, n_valid, DROPOUT, 1e-5)
    g = torch.randn(y.shape, generator=gen).to(dev, y.dtype)
    y.backward(g)
    fwd_args = (x, xn, scale, bias, n_valid, 1e-5, DROPOUT, seed)
    y_ref = _forward_plain(*fwd_args)[0]
    # the plain backward on the kernel forward's own residuals
    y_k, mean_k, _, xr_k, vec_k = _forward(*fwd_args)
    ref = fused_epilogue_bwd_plain(g, xr_k, vec_k, mean_k, n_valid, DROPOUT,
                                   seed, x.dtype, xn.dtype)
    torch.cuda.synchronize()
    err_y, scale_y = _rel_err(y, y_ref)
    tol_y = EPI_TOL[mode] * max(scale_y, 1.0)
    # identical dropout masks: nothing dropped on one side only (a bf16
    # rounding may move a value across the ReLU's 0, within the tolerance)
    if ((y == 0) & (y_ref.float().abs() > tol_y)).any() or (
            (y_ref == 0) & (y.float().abs() > tol_y)).any():
        raise AssertionError(f"fused epilogue {mode}: dropout masks differ")
    if not err_y <= tol_y:
        raise AssertionError(f"fused_epilogue_fwd {mode} rate {DROPOUT}: "
                             f"max err {err_y}")
    errs = []
    for name, t, r in zip(("dx", "dx_new", "dscale", "dbias"), leaves, ref):
        err, sc = _rel_err(t.grad, r)
        tol = 1e-4 if r.dtype == torch.float32 else 2e-2
        log(f"row 3 {mode} {name}: max_abs_err {err:.3e} (tol {tol} x "
            f"{sc:.3e})")
        if not (torch.isfinite(t.grad).all() and err <= tol * sc):
            raise AssertionError(f"fused_epilogue_bwd {mode} {name}: {err}")
        errs.append(err)
    fwd_ms = graph_time_ms(lambda: _forward(*fwd_args))
    fwd_plain = graph_time_ms(lambda: _forward_plain(*fwd_args))
    bwd_args = (g, xr_k, vec_k, mean_k, n_valid, DROPOUT, seed, x.dtype,
                xn.dtype)
    ms = graph_time_ms(lambda: fused_epilogue_bwd(*bwd_args))
    eager_ms = cuda_time_ms(lambda: fused_epilogue_bwd(*bwd_args))
    plain_ms = graph_time_ms(lambda: fused_epilogue_bwd_plain(*bwd_args))
    isz = xr_k.element_size()
    # g, xr, the [4, C] vectors and the mean read once; dx (and dx_new when
    # its dtype differs), dscale, dbias written once
    nbytes = (g.numel() * g.element_size() + xr_k.numel() * isz
              + 5 * HIDDEN * 4 + x.numel() * x.element_size()
              + (xn.numel() * xn.element_size() if xn.dtype != x.dtype else 0)
              + 2 * HIDDEN * 4)
    flops = 16 * xr_k.numel()   # affine recompute, mask, x̂, 2 sums, dx
    bound_ms, bound_by = bound(nbytes, flops, H100_FP32_FLOPS)
    f_bytes = (x.numel() * x.element_size() + xn.numel() * xn.element_size()
               + 2 * HIDDEN * 4 + 2 * y_k.numel() * y_k.element_size())
    f_bound, f_by = bound(f_bytes, 10 * x.numel(), H100_FP32_FLOPS)
    log(f"kernel2 fused_epilogue_fwd {mode} rate {DROPOUT}: max_abs_err "
        f"{err_y:.3e} ms {fwd_ms:.4f} plain_ms {fwd_plain:.4f} bound_ms "
        f"{f_bound:.5f} ({f_by})")
    log(f"row 3 fused_epilogue_bwd {mode} rate {DROPOUT} [{n_pad}, {HIDDEN}]: "
        f"ms {ms:.4f} (eager {eager_ms:.4f}) plain_ms {plain_ms:.4f} "
        f"bound_ms {bound_ms:.5f} ({bound_by})")
    return (dict(max_abs_err=err_y, ms=fwd_ms, plain_ms=fwd_plain,
                 bound_ms=f_bound, bound_by=f_by, library_ms=None),
            dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None))


def check_row3_branches(gen):
    """Row 3 where a block's rows do not fit in shared memory (40,000 rows
    at C 256: phase 3 reads g and xr again), f32, bf16 and mixed, against
    the plain version (f32 1e-4, bf16 one rounding: 2^-7 of the max; g
    with a per-column offset, so that the statistics terms are of the order
    of g in dx); and three calls captured in one CUDA graph, two replays
    identical in every byte to each other and to an eager call.  Then row
    2 the same way at 60,000 rows (its read-back branch) and 12,032."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.epilogue import (
        _forward, _forward_plain, fused_epilogue_bwd, fused_epilogue_bwd_plain)

    dev = torch.device("cuda")
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    for mode, (dx, dxn), n in (
            ("float32", ("float32", "float32"), 40000),
            ("bfloat16", ("bfloat16", "bfloat16"), 40000),
            ("mixed", ("float32", "bfloat16"), 40000),
            ("bfloat16", ("bfloat16", "bfloat16"), 12032)):
        x = (torch.randn(n, HIDDEN, generator=gen) + 1).to(
            dev, getattr(torch, dx))
        xn = torch.randn(n, HIDDEN, generator=gen).to(dev, getattr(torch, dxn))
        scale = (1 + 0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
        bias = (0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
        n_valid = n - 32
        _, mean, _, xr, vec = _forward(x, xn, scale, bias, n_valid, 1e-5,
                                       DROPOUT, seed)
        g = (torch.randn(n, HIDDEN, generator=gen)
             + torch.randn(HIDDEN, generator=gen)).to(dev, xr.dtype)
        args = (g, xr, vec, mean, n_valid, DROPOUT, seed, x.dtype, xn.dtype)
        got = [t.clone() for t in fused_epilogue_bwd(*args)]
        ref = fused_epilogue_bwd_plain(*args)
        errs = []
        for name, a, r in zip(("dx", "dx_new", "dscale", "dbias"), got, ref):
            err, sc = _rel_err(a, r)
            tol = 1e-4 if r.dtype == torch.float32 else 2.0 ** -7
            if not (a.dtype == r.dtype and torch.isfinite(a).all()
                    and err <= tol * sc):
                raise AssertionError(f"row 3 {mode} N {n} {name}: {err} "
                                     f"(tol {tol} x {sc})")
            errs.append(f"{name} {err:.2e}")
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
        if not all(torch.equal(a, b) and torch.equal(a, e)
                   for a, b, e in zip(outs, first, got)):
            raise AssertionError(f"row 3 {mode} N {n}: graph replays differ")
        ms = graph_time_ms(lambda: fused_epilogue_bwd(*args))
        log(f"row 3 {mode} N {n} rate {DROPOUT}: {', '.join(errs)}; graph "
            f"replays identical; ms {ms:.4f}")
    # row 2 past its held-tile limit (60,000 rows: xr read back), and in a
    # graph: y within EPI_TOL, xr equal, replays byte for byte
    for mode, (dx, dxn) in (("float32", ("float32", "float32")),
                            ("bfloat16", ("bfloat16", "bfloat16")),
                            ("mixed", ("float32", "bfloat16"))):
        for n in (60000, 12032):
            x = (torch.randn(n, HIDDEN, generator=gen) + 1).to(
                dev, getattr(torch, dx))
            xn = torch.randn(n, HIDDEN, generator=gen).to(
                dev, getattr(torch, dxn))
            scale = (1 + 0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
            bias = (0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
            args = (x, xn, scale, bias, n - 32, 1e-5, DROPOUT, seed)
            got = [t.clone() for t in _forward(*args)]
            ref = _forward_plain(*args)
            err, sc = _rel_err(got[0], ref[0])
            if not (torch.equal(got[3], ref[3]) and torch.isfinite(got[0]).all()
                    and err <= EPI_TOL[mode] * max(sc, 1.0)):
                raise AssertionError(f"row 2 {mode} N {n}: y err {err}")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _forward(*args)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(3):
                    outs = _forward(*args)
            graph.replay()
            torch.cuda.synchronize()
            first = [t.clone() for t in outs]
            graph.replay()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) and torch.equal(a, e)
                       for a, b, e in zip(outs, first, got)):
                raise AssertionError(f"row 2 {mode} N {n}: graph replays "
                                     "differ")
            log(f"row 2 {mode} N {n} rate {DROPOUT}: y err {err:.2e}; graph "
                f"replays identical; ms "
                f"{graph_time_ms(lambda: _forward(*args)):.4f}")


@contextlib.contextmanager
def epilogue_dropout_keys(itemsize):
    """Key the plain epilogue's dropout stream as for ``itemsize``-byte
    rows (the JAX package's ``_pick_block`` depends on it), so an f32 run
    draws the masks of a bf16 run."""
    from gnn_bfs_rans_tpu_torch.kernels import epilogue

    pick = epilogue.pick_block
    epilogue.pick_block = lambda n, c, _: pick(n, c, itemsize)
    try:
        yield
    finally:
        epilogue.pick_block = pick


def compare_train_step(graph, dtype_name, label="gat4x256", model_seed=1,
                       keep=None, **overrides):
    """One step's loss and gradients, kernels vs plain versions, from the
    same seeded parameters and dropout masks; bf16 and mixed are also held
    against the plain versions' f32 step on those masks.  ``overrides``:
    ModelConfig fields over the flagship GAT's.  In f32 it also reads what
    the gap is made of: each block's output (the epilogue's
    dropout(relu(BN(·)))) through kernels and plain versions, how far apart
    they lie and how many of their ReLUs take the other branch (the
    dropout masks are the same), and the same gaps between the plain
    versions on the input and on the input moved by one f32 ulp (no kernel
    on either side: what rounding alone does to this step).  ``keep``: the
    kernels the kernel side launches (by wrapper name; the plain versions
    for the rest), to see what one kernel adds to the gap; default all."""
    import torch
    from gnn_bfs_rans_tpu_torch.models.convs import dense
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
    from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig, batch_loss

    targets = torch.randn(1, graph.n_pad, 7,
                          generator=torch.Generator().manual_seed(9)).cuda()

    def step(dt, plain, itemsize=None, g=graph):
        cfg = ModelConfig(**{**dict(
            hidden_dim=HIDDEN, num_layers=LAYERS, layer_type="GAT",
            heads=HEADS, backend="pallas", dropout=DROPOUT,
            compute_dtype=dt), **overrides})
        model = FlowGNN(cfg, generator=torch.Generator().manual_seed(
            model_seed)).cuda()
        gen = torch.Generator(device="cuda").manual_seed(5)
        taps = []
        for norm in model.norms:
            def tap(*a, _fwd=norm.train_forward, **k):
                y = _fwd(*a, **k)
                taps.append(y.detach().float())
                return y
            norm.train_forward = tap
        with contextlib.ExitStack() as ctx:
            if plain:
                ctx.enter_context(plain_versions())
            elif keep is not None:
                ctx.enter_context(plain_versions(keep=keep))
            if itemsize:
                ctx.enter_context(epilogue_dropout_keys(itemsize))
            loss = batch_loss(model(g, train=True, generator=gen),
                              targets, g, TrainConfig())
            loss.backward()
            with torch.no_grad():    # out_0's input to its ReLU
                taps.append(dense(model.out_0, taps[-1]).float())
        return loss.item(), {k: p.grad.float() for k, p in
                             model.named_parameters()}, taps

    loss_k, g_k, taps_k = step(dtype_name, False)
    loss_p, g_p, taps_p = step(dtype_name, True)
    log(f"train step {label} {dtype_name}: loss kernels {loss_k:.7f} plain "
        f"{loss_p:.7f}")
    if not (abs(loss_k - loss_p) <= STEP_LOSS_TOL[dtype_name] * abs(loss_p)
            and all(torch.isfinite(v).all() for v in g_k.values())):
        raise AssertionError(f"train step {label} {dtype_name}: loss "
                             f"{loss_k} vs {loss_p}")
    if dtype_name == "float32":
        feat = graph.node_feat
        sign = torch.randint(0, 2, feat.shape, generator=torch.Generator()
                             .manual_seed(11)).to(feat.device) * 2 - 1
        moved = dataclasses.replace(graph,
                                    node_feat=feat * (1 + sign * 2.0 ** -23))
        _, g_e, taps_e = step(dtype_name, True, g=moved)
        for i, (yk, yp, ye) in enumerate(zip(taps_k, taps_p, taps_e)):
            where = f"block {i}" if i < len(taps_p) - 1 else "out_0"
            log(f"  {where} forward: max gap kernels "
                f"{(yk - yp).abs().max().item() / yp.abs().max().item():.3e} "
                f"plain on the moved input "
                f"{(ye - yp).abs().max().item() / yp.abs().max().item():.3e} "
                f"(× max |y|); ReLUs on the other branch: kernels "
                f"{int(((yk > 0) != (yp > 0)).sum())}, plain on the moved "
                f"input {int(((ye > 0) != (yp > 0)).sum())} of {yp.numel()}")
        g_max = max(v.abs().max().item() for v in g_p.values())
        worst = worst_e = 0.0
        for name in g_p:
            err, scale = _rel_err(g_k[name], g_p[name])
            err_e, _ = _rel_err(g_e[name], g_p[name])
            log(f"  grad {name}: max relative gap "
                f"{err / max(scale, 1e-30):.3e} (max |g| {scale:.3e}; plain "
                f"on the moved input {err_e / max(scale, 1e-30):.3e})")
            # a conv bias feeds BatchNorm: its gradient is zero in exact
            # arithmetic, rounding noise on both sides; groups whose
            # gradient nearly cancels are measured against 1e-3 of the
            # largest gradient
            floor = g_max if _zero_grad(name) else 1e-3 * g_max
            worst = max(worst, err / max(scale, floor))
            worst_e = max(worst_e, err_e / max(scale, floor))
        limit = max(STEP_TOL_F32, STEP_F32_RATIO * worst_e)
        log(f"train step {label} f32: worst gradient gap kernels {worst:.3e}, "
            f"plain on the moved input {worst_e:.3e} (limit {limit:.3e})")
        if worst > limit:
            raise AssertionError(f"train step {label} f32: gradient gap "
                                 f"{worst} > {limit}")
        return worst
    # the f32 step on the same masks: the mixed residual stream is f32, so
    # only bf16 rows key the epilogue's stream otherwise
    _, g_f, _ = step("float32", True, 2 if dtype_name == "bfloat16" else None)
    g_norm = max(v.norm().item() for v in g_f.values())
    worst = 0.0
    for name in g_p:
        ref = g_f[name]
        own = (g_p[name] - ref).norm().item()
        dist = (g_k[name] - ref).norm().item()
        gap = (g_k[name] - g_p[name]).norm().item()
        scale = g_norm if _zero_grad(name) else ref.norm().item()
        rel = 1.0 / max(scale, 1e-30)
        log(f"  grad {name}: |kernels - plain| "
            f"{gap / max(g_p[name].norm().item(), 1e-30):.3e}, from f32: "
            f"plain {own * rel:.3e} kernels {dist * rel:.3e} (ratio "
            f"{dist / max(own, 1e-30):.2f}; relative to |g| {scale:.3e})")
        if _zero_grad(name):
            if not dist <= ZERO_GRAD_TOL * scale:
                raise AssertionError(
                    f"train step {label} {dtype_name} {name}: |g| {dist} > "
                    f"{ZERO_GRAD_TOL} x {scale}")
            continue
        if not dist <= STEP_F32_RATIO * own + 1e-4 * scale:
            raise AssertionError(
                f"train step {label} {dtype_name} {name}: kernels {dist} "
                f"from the f32 step > {STEP_F32_RATIO} x plain {own}")
        worst = max(worst, dist / max(own, 1e-30))
    log(f"train step {label} {dtype_name}: largest ratio {worst:.3f} (limit "
        f"{STEP_F32_RATIO})")
    return worst


def _zero_grad(name):
    """A conv bias whose gradient is zero in exact arithmetic and rounding
    noise in any other: one that feeds the BatchNorm (GCN and GAT ``bias``,
    GIN's last MLP layer, the Transformer's ``lin_skip``), and the
    Transformer's key bias, which shifts every logit of a row alike (the
    value bias is real under attention dropout, where the kept
    probabilities do not sum to 1)."""
    return re.fullmatch(r"convs\.\d+\.((nn\.2\.)?bias|lin_(key|skip)\.bias)",
                        name) is not None


def train(tmp, case, info):
    """``train`` of the flagship GAT (bf16, dropout); returns the launch
    counts of the training path."""
    import json as _json

    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
    from gnn_bfs_rans_tpu_torch.kernels import _build

    out = tmp / "train_run"
    argv = ["train", "--case_path", str(case), "--time_dirs", *TRAIN_TIMES,
            "--output_dir", str(out), "--hidden_dim", str(HIDDEN),
            "--num_layers", str(LAYERS), "--epochs", str(TRAIN_EPOCHS),
            "--save_every", str(TRAIN_EPOCHS), "--lr", "1e-3",
            "--dropout", str(DROPOUT), "--compute_dtype", "bfloat16",
            "--layer_type", "GAT", "--device", "cuda"]
    t = time.time()
    _build.reset_launches()           # the training path starts here
    rc = cli_main(argv)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)  # ... and ends here
    log(f"train: {TRAIN_EPOCHS} epochs in {time.time() - t:.1f} s, launches "
        f"{launches}")
    if rc != 0:
        raise RuntimeError(f"train returned {rc}")
    hist = _json.loads((out / "training_history.json").read_text())
    losses = hist["train_loss"]
    log(f"train losses {losses}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"training did not lower the loss: {losses}")
    meta = _json.loads((out / f"epoch_{TRAIN_EPOCHS}.meta.json").read_text())
    if not meta.get("bn_recalibrated"):
        raise AssertionError("bf16 checkpoint not saved recalibrated")
    pred = tmp / "train_pred"
    rc = cli_main(["infer", "--checkpoint", str(out), "--case_path", str(case),
                   "--output_dir", str(pred), "--reference_time", "100",
                   "--device", "cuda"])
    if rc != 0:
        raise RuntimeError(f"infer of the trained checkpoint returned {rc}")
    fields = dict(np.load(pred / "predictions.npz"))
    if fields["U"].shape != (info["n_cells"], 3) or not all(
            np.isfinite(v).all() for v in fields.values()):
        raise AssertionError("bad predictions from the trained checkpoint")
    comp = _json.loads((pred / "comparison.json").read_text())
    log(f"served the trained checkpoint: U mae {comp['U']['mae']:.4e}, "
        f"p mae {comp['p']['mae']:.4e}")
    return launches


def check_spmm(graph, plane, dtype_name, gen, measure=False):
    """Row 8 forward and backward (through the autograd op, on the
    transposed band) vs the plain versions at F 256; with ``measure`` its
    times, bound and the cuSPARSE time of the same product."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded import (
        banded_spmm, banded_spmm_fwd, banded_spmm_plain, transpose_band)

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name)
    a = getattr(graph.band, plane)
    n, window = graph.n_pad, a.shape[1]
    x = torch.randn(n, HIDDEN, generator=gen).to(dev, dt)
    g = torch.randn(n, HIDDEN, generator=gen).to(dev, dt)
    got = banded_spmm_fwd(a, x)
    ref = banded_spmm_plain(a, x)
    grads = []
    for plain in (False, True):
        xl = x.clone().requires_grad_()
        with plain_versions() if plain else contextlib.nullcontext():
            banded_spmm(a, xl).backward(g)
        grads.append(xl.grad)
    torch.cuda.synchronize()
    err, scale = _rel_err(got, ref)
    gerr, gscale = _rel_err(*grads)
    tol = SPMM_TOL[dtype_name]
    log(f"row 8 banded_spmm {plane} ({a.dtype}) x {dtype_name} W {window} "
        f"N {n}: max_abs_err {err:.3e} (tol {tol} x {scale:.3e}), dx "
        f"{gerr:.3e} (x {gscale:.3e})")
    if not (torch.isfinite(got).all() and torch.isfinite(grads[0]).all()
            and err <= tol * scale and gerr <= tol * gscale):
        raise AssertionError(f"banded_spmm {plane} {dtype_name} W {window}: "
                             f"max err {err} / dx {gerr}")
    if not measure:
        return None
    at = transpose_band(a)
    ms = graph_time_ms(lambda: banded_spmm_fwd(a, x))
    eager_ms = cuda_time_ms(lambda: banded_spmm_fwd(a, x))
    bwd_ms = graph_time_ms(lambda: banded_spmm_fwd(at, g))
    tr_ms = graph_time_ms(lambda: transpose_band(a))
    plain_ms = graph_time_ms(lambda: banded_spmm_plain(a, x), 3, 2)
    # cuSPARSE: a CSR copy of the same band times x, in f32 (it takes no
    # mixed dtypes); timed here only, never on the port's path
    t, k, i, j = (a != 0).nonzero(as_tuple=True)
    tile = a.shape[2]
    rows = t * tile + i
    cols = (t - window // 2 + k) * tile + j
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), a[t, k, i, j].float(), (n, n)
    ).coalesce().to_sparse_csr()
    xf = x.float()
    lib = torch.sparse.mm(csr, xf)
    lib_err, _ = _rel_err(lib, banded_spmm_plain(a, xf))
    library_ms = graph_time_ms(lambda: torch.sparse.mm(csr, xf))
    library_eager = cuda_time_ms(lambda: torch.sparse.mm(csr, xf))
    nnz = int(rows.numel())
    # the plane, x and out once; the products the nonzeros need, exact f32
    # on the SIMT units
    nbytes = (a.numel() * a.element_size() + 2 * x.numel() * x.element_size())
    bound_ms, bound_by = bound(nbytes, 2 * nnz * HIDDEN, H100_FP32_FLOPS)
    log(f"row 8 banded_spmm {plane} x {dtype_name} W {window} nnz {nnz}: ms "
        f"{ms:.4f} (eager {eager_ms:.4f}; backward on the transposed band "
        f"{bwd_ms:.4f}, transpose_band {tr_ms:.4f}) plain_ms {plain_ms:.4f} "
        f"library_ms (torch.sparse.mm, CSR f32) {library_ms:.4f} (eager "
        f"{library_eager:.4f}) "
        f"(max err vs plain {lib_err:.3e}) bound_ms {bound_ms:.5f} "
        f"({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_gat_mean(graph, dtype_name, rate, gen, measure=False):
    """Row 4 vs its plain version, and its op's (dW, dWa, dx) through
    z = x·W and α = x·wa, kernels (rows 4, 5) vs plain versions."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded import (
        banded_gat_mean, banded_gat_mean_packed, banded_gat_mean_plain)

    dt = getattr(torch, dtype_name)
    n = graph.n_pad
    mask = graph.band.bias_self
    x, w, wa, g, seed = _gat_inputs(n, dt, gen)
    seed = seed if rate else None
    z = (x.float() @ w.float()).to(dt)
    alphas = (x.float() @ wa.float()).contiguous()
    args = (mask, z, alphas, HEADS, 0.2, rate, seed)
    got = banded_gat_mean(*args)
    ref = banded_gat_mean_plain(*args)
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (w, wa, x)]
        with plain_versions() if plain else contextlib.nullcontext():
            w_, wa_, x_ = leaves
            y = banded_gat_mean_packed(mask, x_ @ w_,
                                       x_.float() @ wa_.float(), HEADS, 0.2,
                                       rate, seed)
            y.backward(g)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    err, scale = _rel_err(got, ref)
    log(f"row 4 banded_gat_mean {dtype_name} rate {rate} Wcols "
        f"{mask.shape[-1]}: max_abs_err {err:.3e} (tol {GAT_TOL[dtype_name]} "
        f"x {scale:.3e})")
    if not (torch.isfinite(got).all() and err <= GAT_TOL[dtype_name] * scale):
        raise AssertionError(f"banded_gat_mean {dtype_name} rate {rate}: "
                             f"max err {err}")
    for name, gk, gp in zip(("dW", "dWa", "dx"), *grads):
        gerr, gscale = _rel_err(gk, gp)
        log(f"  op {name}: max_abs_err {gerr:.3e} (tol {BWD_TOL[dtype_name]} "
            f"x {gscale:.3e})")
        if not (torch.isfinite(gk).all()
                and gerr <= BWD_TOL[dtype_name] * gscale):
            raise AssertionError(f"banded_gat_mean_packed {name} "
                                 f"{dtype_name} rate {rate}: {gerr}")
    if not measure:
        return None
    ms = graph_time_ms(lambda: banded_gat_mean(*args))
    eager_ms = cuda_time_ms(lambda: banded_gat_mean(*args))
    plain_ms = graph_time_ms(lambda: banded_gat_mean_plain(*args), 3, 2)
    nnz = int(mask.sum().item())
    isz = z.element_size()
    hc = HEADS * HIDDEN
    # mask, z and α read once, out written once; the f32 SIMT work is the
    # sparse product, 2·C operations per nonzero entry and head
    nbytes = mask.numel() + n * hc * isz + alphas.numel() * 4 + n * HIDDEN * isz
    bound_ms, bound_by = bound(nbytes, 2 * nnz * hc, H100_FP32_FLOPS)
    log(f"row 4 banded_gat_mean {dtype_name} rate {rate} N {n} nnz {nnz}: ms "
        f"{ms:.4f} (eager {eager_ms:.4f}) plain_ms {plain_ms:.4f} bound_ms "
        f"{bound_ms:.5f} ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def train_default(tmp, case, info):
    """``train`` with the CLI's default model (GCN, 6 layers, hidden 256,
    f32; ``train_cli``).  Returns the launch counts of the run."""
    import json as _json

    launches = train_cli(tmp, case, info, "gcn", GCN_EPOCHS)
    meta = _json.loads((tmp / "train_gcn" / f"epoch_{GCN_EPOCHS}.meta.json")
                       .read_text())
    mcfg = meta["model_config"]
    if (mcfg["layer_type"], mcfg["num_layers"], mcfg["hidden_dim"]) != (
            "GCN", GCN_LAYERS, HIDDEN):
        raise AssertionError(f"the default model is not GCN 6x256: {mcfg}")
    return launches


def train_gat_unfused(tmp, case):
    """The unfused GAT training path (``fuse_train=False``, bf16) through
    the ``Trainer``: two epochs, the loss finite.  Returns the launch
    counts of the run."""
    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.kernels import _build
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig
    from gnn_bfs_rans_tpu_torch.train.data import load_dataset
    from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig
    from gnn_bfs_rans_tpu_torch.train.trainer import Trainer

    dataset = load_dataset(case, list(TRAIN_TIMES), with_band=True,
                           band_components=("bias_self",))
    mcfg = ModelConfig(hidden_dim=HIDDEN, num_layers=LAYERS, layer_type="GAT",
                       heads=HEADS, backend="pallas", dropout=DROPOUT,
                       compute_dtype="bfloat16", fuse_train=False)
    t = time.time()
    _build.reset_launches()     # the unfused GAT training path starts here
    tr = Trainer(dataset, mcfg, TrainConfig(lr=1e-3, epochs=2, save_every=2),
                 output_dir=tmp / "train_gat_unfused",
                 log_fn=lambda *a: None, device="cuda")
    tr.initialize()
    hist = tr.train()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)  # ... and ends here
    log(f"train GAT fuse_train=False bf16: 2 epochs in {time.time() - t:.1f} "
        f"s, losses {hist['train_loss']}, launches {launches}")
    if not np.isfinite(hist["train_loss"]).all():
        raise AssertionError("unfused GAT training gave a non-finite loss")
    return launches


def step_times(tmp, case, label, **model):
    """Host-clock and profiler times of one train step (batch 1)."""
    from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig
    from gnn_bfs_rans_tpu_torch.train.data import load_dataset
    from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig, train_step
    from gnn_bfs_rans_tpu_torch.train.trainer import Trainer

    mcfg = ModelConfig(**{**dict(hidden_dim=HIDDEN, heads=HEADS,
                                 backend="pallas", dropout=DROPOUT), **model})
    dataset = load_dataset(case, list(TRAIN_TIMES),
                           with_band=mcfg.backend == "pallas",
                           band_components=LAYER_COMPONENTS[mcfg.layer_type])
    tcfg = TrainConfig(lr=1e-3)
    tr = Trainer(dataset, mcfg, tcfg, output_dir=tmp / f"timing_{label}",
                 log_fn=lambda *a: None, device="cuda")
    batch = tr.targets[:1]

    def step():
        return train_step(tr.model, tr.optimizer, tr.graph, batch, 1e-3,
                          tcfg, tr.generator)

    host = host_time_ms(step)
    device_us = profile_forward(step, f"train step {label}")
    log(f"train step {label} N {tr.graph.n_nodes} dropout {DROPOUT}: host "
        f"clock median {host[1]:.4f} ms (quartiles {host[0]:.4f}, "
        f"{host[2]:.4f}; 20 steps), device time (profiler sum) "
        f"{'not measured' if device_us is None else f'{device_us / 1e3:.4f} ms'}")


def _transformer_inputs(n, dt, gen, extra_qw):
    import torch

    dev = torch.device("cuda")
    hc = HEADS * HIDDEN
    q, k, v = (torch.randn(n, hc, generator=gen).to(dev, dt) for _ in range(3))
    qw = (torch.randn(n, HEADS * 4, generator=gen).to(dev, dt)
          if extra_qw else None)
    return q, k, v, qw


def _s_check(band, s, s_ref, rel):
    """s's max error and limit by column group: the geo form's direction
    columns (0-2 of each head) against ``rel`` × their max plus
    S_CANCEL_TOL × max|pos|·max(1/dist), its dist column (3) against
    ``rel`` × its max; the generic edge form's columns against ``rel`` ×
    their max.  Returns (ok, text)."""
    import torch

    d = (s - s_ref).abs()
    if band.geo is None:
        groups = [("s", d, s_ref.abs(), 0.0)]
    else:
        d4, r4 = d.view(d.shape[0], -1, 4), s_ref.abs().view(d.shape[0], -1, 4)
        cancel = band.pos.abs().max().item() * band.geo[:, 1].max().item()
        groups = [("s dir", d4[..., :3], r4[..., :3], S_CANCEL_TOL * cancel),
                  ("s dist", d4[..., 3], r4[..., 3], 0.0)]
    ok, text = bool(torch.isfinite(s).all()), []
    for name, err, ref, extra in groups:
        err, tol = err.max().item(), rel * ref.max().item() + extra
        ok = ok and err <= tol
        text.append(f"{name} {err:.3e} (tol {tol:.3e})")
    return ok, ", ".join(text)


def check_transformer(band, form, mean, dtype_name, gen, measure=False,
                      rate=0.0):
    """Row 9 vs its plain version on one band (``form``: plain, edge or
    geo), at attention dropout ``rate``; with ``measure`` its times, bound
    and, for the plain form at rate 0, the time of SDPA on pre-windowed
    k/v."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded import (
        _windows, banded_transformer_fwd, banded_transformer_fwd_plain)

    dt = getattr(torch, dtype_name)
    mask = band.bias_noself
    n_tiles, tile, width = mask.shape
    n, hc = n_tiles * tile, HEADS * HIDDEN
    q, k, v, qw = _transformer_inputs(n, dt, gen, form != "plain")
    extra = {}
    if form == "edge":
        extra = dict(edge=band.edge, qw=qw)
    elif form == "geo":
        extra = dict(geo=band.geo, pos=band.pos, qw=qw)
    args = (mask, q, k, v, HEADS)
    if rate:
        extra.update(dropout_rate=rate, seed=torch.tensor(
            [2024], dtype=torch.int32, device=q.device))

    def run(fn):
        return fn(*args, mean_heads=mean, **extra)

    got = run(banded_transformer_fwd)
    ref = run(banded_transformer_fwd_plain)
    torch.cuda.synchronize()
    got, ref = (got, ref) if form != "plain" else ((got,), (ref,))
    err, scale = _rel_err(got[0], ref[0])
    ok = (torch.isfinite(got[0]).all() and err <= GAT_TOL[dtype_name] * scale
          and got[0].dtype == dt)
    s_text = ""
    if form != "plain":
        s_ok, s_text = _s_check(band, got[1], ref[1], S_TOL)
        ok = ok and s_ok
        s_text = ", " + s_text
    label = (f"row 9 {form} {'mean' if mean else 'concat'} {dtype_name} "
             f"rate {rate} Wcols {width}")
    log(f"{label}: max_abs_err {err:.3e} (tol {GAT_TOL[dtype_name]} x "
        f"{scale:.3e}){s_text}")
    if not ok:
        raise AssertionError(f"{label}: out err {err}{s_text}")
    if not measure:
        return None
    ms = graph_time_ms(lambda: run(banded_transformer_fwd))
    eager_ms = cuda_time_ms(lambda: run(banded_transformer_fwd))
    plain_ms = graph_time_ms(lambda: run(banded_transformer_fwd_plain), 3, 2)
    nnz = int(mask.sum().item())
    isz = q.element_size()
    # mask, q, k, v, pos and qw read once, the conditioning planes only at
    # the mask's nonzeros (the kernel reads no other entry of them); out and
    # s written once; the SIMT work is 2·C operations per sender and head
    # for the logit and 2·C for the value
    nbytes = mask.numel() + 3 * n * hc * isz + got[0].numel() * isz
    if form != "plain":
        feat = extra.get("geo", extra.get("edge"))
        nbytes += (nnz * feat.shape[1] * 4 + qw.numel() * isz
                   + got[1].numel() * 4 + (n * 16 if form == "geo" else 0))
    bound_ms, bound_by = bound(nbytes, 4 * nnz * hc, H100_FP32_FLOPS)
    library_ms = None
    lib_note = ""
    if form == "plain" and not rate:
        # SDPA over each receiver tile's window: q [nt, H, T, C] against
        # the windowed k/v [nt, H, Wcols, C] with the boolean band mask; the
        # windowing is not timed.  It gives the concat form; fully masked
        # (padding) rows are NaN there and are left out of the comparison.
        qh = q.view(n_tiles, tile, HEADS, HIDDEN).permute(0, 2, 1, 3).contiguous()
        kw, vw = (_windows(t, tile, width).reshape(n_tiles, width, HEADS,
                                                   HIDDEN).permute(0, 2, 1, 3)
                  .contiguous() for t in (k, v))
        am = mask.bool()[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def lib():
            return sdpa(qh, kw, vw, attn_mask=am)

        out_lib = lib().permute(0, 2, 1, 3).reshape(n, hc)
        ref_concat = banded_transformer_fwd_plain(*args)
        real = mask.reshape(n, width).sum(1) > 0
        lib_err, _ = _rel_err(out_lib[real], ref_concat[real])
        library_ms = graph_time_ms(lib)
        lib_note = (f" library_ms (SDPA, concat form, windows pre-built) "
                    f"{library_ms:.4f} (max err vs plain on real rows "
                    f"{lib_err:.3e})")
    log(f"{label} N {n} nnz {nnz}: ms {ms:.4f} (eager {eager_ms:.4f}) "
        f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})"
        + lib_note)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_transformer_fused(band, dtype_name, gen, measure=False):
    """Row 11 vs its plain version; with ``measure`` its times and bound."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded import (
        banded_transformer_geo_mean_fused,
        banded_transformer_geo_mean_fused_plain)

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name)
    mask = band.bias_noself
    n_tiles, tile, width = mask.shape
    n, f, hc = n_tiles * tile, HIDDEN, HEADS * HIDDEN
    x = torch.randn(n, f, generator=gen).to(dev, dt)
    ws = [(torch.randn(f, hc, generator=gen) * f ** -0.5).to(dev, dt)
          for _ in range(3)]
    bs = [(0.1 * torch.randn(hc, generator=gen)).to(dev, dt)
          for _ in range(3)]
    w_e = torch.rand(4, HEADS, HIDDEN, generator=gen) - 0.5
    wblk = (torch.eye(HEADS)[:, None, :, None]
            * w_e.permute(1, 2, 0)[:, :, None, :]).reshape(hc, HEADS * 4)
    wblk = wblk.to(dev, dt)
    args = (mask, band.geo, band.pos, x, *ws, *bs, wblk, HEADS)
    out, s = banded_transformer_geo_mean_fused(*args)
    ref, ref_s = banded_transformer_geo_mean_fused_plain(*args)
    torch.cuda.synchronize()
    err, scale = _rel_err(out, ref)
    s_rel = S_TOL if dt == torch.float32 else GAT_TOL[dtype_name]
    s_ok, s_text = _s_check(band, s, ref_s, s_rel)
    label = f"row 11 {dtype_name} Wcols {width}"
    log(f"{label}: max_abs_err {err:.3e} (tol {GAT_TOL[dtype_name]} x "
        f"{scale:.3e}), {s_text}")
    if not (torch.isfinite(out).all() and s_ok
            and err <= GAT_TOL[dtype_name] * scale):
        raise AssertionError(f"{label}: out err {err}, {s_text}")
    if not measure:
        return None
    ms = graph_time_ms(lambda: banded_transformer_geo_mean_fused(*args))
    eager_ms = cuda_time_ms(lambda: banded_transformer_geo_mean_fused(*args))
    plain_ms = graph_time_ms(
        lambda: banded_transformer_geo_mean_fused_plain(*args), 3, 2)
    nnz = int(mask.sum().item())
    isz = x.element_size()
    # x, the weights, biases, wblk, mask and pos read once, the geo planes
    # at the mask's nonzeros; out and s written once.  Operations: the
    # three projections on the tensor cores (bf16) or the SIMT units (f32),
    # the sparse attention on the SIMT units; the least time is their sum
    # at each unit's peak
    nbytes = (n * f * isz + 3 * f * hc * isz + 3 * hc * isz
              + wblk.numel() * isz + mask.numel() + nnz * 2 * 4
              + n * 16 + out.numel() * isz + s.numel() * 4)
    proj_peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_FP32_FLOPS
    t_ops = (6 * n * f * hc / proj_peak + 4 * nnz * hc / H100_FP32_FLOPS) * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    log(f"{label} N {n}: ms {ms:.4f} (eager {eager_ms:.4f}) plain_ms "
        f"{plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
    # the projection and the attention by kernel name, and one torch.addmm
    # of x by [Wq | Wk | Wv] beside them as the projection's yardstick
    profile_forward(lambda: banded_transformer_geo_mean_fused(*args),
                    f"{label} by kernel", steps=10)
    wcat, bcat = torch.cat(ws, 1), torch.cat(bs)
    log(f"{label}: torch.addmm projection ms "
        f"{graph_time_ms(lambda: torch.addmm(bcat, x, wcat)):.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def transformer_phase(tmp, case, info, gen):
    """Rows 9 and 11 on both boxes, then Transformer serving through
    ``infer``.  Returns (rows, launch counts by serving run, the generic
    edge bands by box)."""
    import numpy as np
    from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS, build_band
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig

    rows, edge_bands = {}, {}
    for nx in (163, 400):
        g = load_graph(tmp / f"box{nx}", "Transformer")
        if g.band.geo is None:
            raise AssertionError(f"box {nx}: no geo planes")
        # the generic edge form: the same edges with random features
        feat = np.random.default_rng(nx).normal(
            size=(g.n_edges, 4)).astype(np.float32)
        edge_band = build_band(
            g.senders.numpy()[: g.n_edges], g.receivers.numpy()[: g.n_edges],
            g.n_pad, g.node_mask.numpy(), g.in_degree.numpy(),
            components=LAYER_COMPONENTS["Transformer"], edge_feat=feat,
            node_pos=g.node_feat.numpy())
        if edge_band.edge is None or edge_band.geo is not None:
            raise AssertionError("random features did not take the edge form")
        geo_band, edge_band = g.band.to("cuda"), edge_band.to("cuda")
        edge_bands[nx] = edge_band
        for form in ("plain", "edge", "geo"):
            band = edge_band if form == "edge" else geo_band
            for mean in (True, False):
                for dt in ("float32", "bfloat16"):
                    rows[("tr", nx, form, mean, dt)] = check_transformer(
                        band, form, mean, dt, gen,
                        measure=(nx == 400 and mean
                                 and form in ("plain", "geo")))
        for dt in ("float32", "bfloat16"):
            rows[("trf", nx, dt)] = check_transformer_fused(
                geo_band, dt, gen, measure=nx == 400)
    base = dict(hidden_dim=HIDDEN, num_layers=LAYERS, layer_type="Transformer",
                heads=HEADS, backend="pallas", compute_dtype="bfloat16")
    launches = {}
    for label, cfg in (
            ("bf16", base), ("f32", {**base, "compute_dtype": "float32"}),
            ("bf16-fuse-eval", {**base, "fuse_eval": True}),
            ("bf16-noedge", {**base, "use_edge_attr": False})):
        runs = None
        if cfg.get("fuse_eval"):
            # row 11 in eval; exact_bn runs in train mode: row 9
            runs = {"off": {"banded_transformer_geo_mean_fused": LAYERS},
                    "on": {"banded_transformer_fwd": LAYERS,
                           "fused_epilogue_fwd": 2 * LAYERS}}
        launches[label] = serve(tmp, case, info, ModelConfig(**cfg),
                                f"transformer{LAYERS}x{HIDDEN}-{label}", gen,
                                runs, f32_ratio=label != "f32")
    launches["deep"] = serve(
        tmp, case, info, ModelConfig(**{**base, "num_layers": TR_DEEP_LAYERS}),
        f"transformer{TR_DEEP_LAYERS}x{HIDDEN}-bf16", gen, f32_ratio=True)
    return rows, launches, edge_bands


def check_transformer_bwd(band, form, mean, dtype_name, rate, gen,
                          measure=False):
    """Row 10 vs its plain version on one band, with the cotangent of s
    when conditioned, at dropout ``rate``; with ``measure`` its times and
    bound, and row 7's on its dk partials.  Returns (row 10, row 7) rows
    (None when not measured)."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded_bwd import (
        banded_transformer_bwd, banded_transformer_bwd_plain)

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name)
    mask = band.bias_noself
    n_tiles, tile, width = mask.shape
    n, hc = n_tiles * tile, HEADS * HIDDEN
    q, k, v, qw = _transformer_inputs(n, dt, gen, form != "plain")
    extra = {}
    if form == "edge":
        extra = dict(edge=band.edge, qw=qw)
    elif form == "geo":
        extra = dict(geo=band.geo, pos=band.pos, qw=qw)
    if form != "plain":
        extra["gs"] = torch.randn(n, HEADS * 4, generator=gen).to(dev)
    g = torch.randn(n, HIDDEN if mean else hc, generator=gen).to(dev, dt)
    seed = torch.tensor([2025], dtype=torch.int32, device=dev)
    args = (mask, q, k, v, g, HEADS)
    kw = dict(mean_expand=mean, dropout_rate=rate,
              seed=seed if rate else None, **extra)
    got = banded_transformer_bwd(*args, **kw)
    ref = banded_transformer_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    label = (f"row 10 {form} {'mean' if mean else 'concat'} {dtype_name} "
             f"rate {rate} Wcols {width}")
    texts, ok, errs = [], True, []
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err, scale = _rel_err(a, b)
        errs.append(err)
        ok = ok and bool(torch.isfinite(a).all()) and a.dtype == dt \
            and err <= BWD_TOL[dtype_name] * scale
        texts.append(f"{name} {err:.3e} (tol {BWD_TOL[dtype_name]} x "
                     f"{scale:.3e})")
    if form != "plain":
        # dqw is f32 from the same inputs, in the layout of s
        s_ok, s_text = _s_check(band, got[3], ref[3],
                                S_TOL if dt == torch.float32 else 1e-3)
        ok = ok and s_ok
        texts.append("dqw: " + s_text)
    log(f"{label}: " + ", ".join(texts))
    if not ok:
        raise AssertionError(f"{label}: " + ", ".join(texts))
    if not measure:
        return None, None
    ms = graph_time_ms(lambda: banded_transformer_bwd(*args, **kw))
    eager_ms = cuda_time_ms(lambda: banded_transformer_bwd(*args, **kw))
    plain_ms = graph_time_ms(lambda: banded_transformer_bwd_plain(*args, **kw),
                             3, 2)
    nnz = int(mask.sum().item())
    isz = q.element_size()
    # inputs read once (mask, q, k, v, g, qw, gs, pos, the planes at the
    # nonzeros); dq, the two partial arrays and dqw written once.  The f32
    # SIMT work per nonzero and head: the logit, dp, dq, dk and dv products,
    # 2·C operations each
    nbytes = (mask.numel() + 3 * n * hc * isz + g.numel() * isz
              + n * hc * isz + 2 * got[1].numel() * isz)
    if form != "plain":
        feat = extra.get("geo", extra.get("edge"))
        nbytes += (nnz * feat.shape[1] * 4 + qw.numel() * isz
                   + 2 * extra["gs"].numel() * 4
                   + (n * 16 if form == "geo" else 0))
    bound_ms, bound_by = bound(nbytes, 10 * nnz * hc, H100_FP32_FLOPS)
    log(f"{label} N {n} nnz {nnz}: ms {ms:.4f} (eager {eager_ms:.4f}) "
        f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
    # its two passes by kernel name (the receiver pass, the partials pass)
    profile_forward(lambda: banded_transformer_bwd(*args, **kw),
                    f"{label} by kernel", steps=10)
    row10 = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return row10, check_fold(got[1], tile)


def check_fold(part, tile):
    """Row 7 vs its plain version on row 10's dk partials, its times and
    bound, and the time of one ``index_add_`` of the flattened partials
    onto their sender rows (in the partials' dtype: it accumulates there,
    where row 7 sums in f32 and rounds once)."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded_bwd import (
        fold_partials, fold_partials_plain)

    n_tiles, w_sub, sub, feat = part.shape
    n = n_tiles * tile
    got = fold_partials(part, tile)
    ref = fold_partials_plain(part, tile)
    torch.cuda.synchronize()
    err, scale = _rel_err(got, ref)
    # the same f32 sums in the same order, one rounding: equal in f32, one
    # bf16 rounding may flip
    tol = 0.0 if part.dtype == torch.float32 else 2.0 ** -8
    if not (torch.isfinite(got).all() and err <= tol * scale):
        raise AssertionError(f"row 7 fold_partials: max err {err} vs "
                             f"{tol} x {scale}")
    ms = graph_time_ms(lambda: fold_partials(part, tile))
    plain_ms = graph_time_ms(lambda: fold_partials_plain(part, tile), 3, 2)
    pad = (w_sub * sub - tile) // 2
    rows = (torch.arange(n_tiles, device=part.device)[:, None] * tile - pad
            + torch.arange(w_sub * sub, device=part.device)[None, :]).reshape(-1)
    rows = torch.where((rows >= 0) & (rows < n), rows, n)
    flat = part.reshape(-1, feat)
    dest = torch.zeros(n + 1, feat, dtype=part.dtype, device=part.device)

    def lib():
        return dest.zero_().index_add_(0, rows, flat)

    lib_err, _ = _rel_err(lib()[:n], ref)
    library_ms = graph_time_ms(lib)
    # the partials read once, the rows written once; one add per element
    nbytes = part.numel() * part.element_size() + n * feat * got.element_size()
    bound_ms, bound_by = bound(nbytes, part.numel(), H100_FP32_FLOPS)
    log(f"row 7 fold_partials {tuple(part.shape)} {part.dtype}: "
        f"max_abs_err {err:.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms (zero_ + index_add_) {library_ms:.4f} (max err vs plain "
        f"{lib_err:.3e}) bound_ms {bound_ms:.5f} ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_project_bias(n, dtype_name, gen):
    """Row 6's bias form at the projgrad backward's shape (dz [N, 3·H·C]
    against [Wq | Wk | Wv], x [N, F]) and the projection (q|k|v = x·W + b,
    qw = q·wblk on ``gemm_sm90.cuh``) against their plain versions; the
    projection's time beside ``torch.addmm`` + ``torch.matmul`` and its
    bound.  Returns the projection's kernel-table entry."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded import (
        transformer_project, transformer_project_plain)
    from gnn_bfs_rans_tpu_torch.kernels.banded_bwd import (
        fold_project_bwd, fold_project_bwd_plain)

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name)
    f, hc = HIDDEN, HEADS * HIDDEN
    x = torch.randn(n, f, generator=gen).to(dev, dt)
    ws = [(torch.randn(f, hc, generator=gen) * f ** -0.5).to(dev, dt)
          for _ in range(3)]
    bs = [(0.1 * torch.randn(hc, generator=gen)).to(dev, dt) for _ in range(3)]
    w_e = torch.rand(4, HEADS, HIDDEN, generator=gen) - 0.5
    wblk = (torch.eye(HEADS)[:, None, :, None]
            * w_e.permute(1, 2, 0)[:, :, None, :]).reshape(hc, HEADS * 4)
    wblk = wblk.to(dev, dt)
    args = (x, *ws, *bs, wblk)
    qkv, qw = transformer_project(*args)
    ref_qkv, _ = transformer_project_plain(*args)
    ref_qw = (qkv[:, :hc].float() @ wblk.float()).to(dt)
    w = torch.cat(ws, 1)
    dz = torch.randn(n, 3 * hc, generator=gen).to(dev, dt)
    got = fold_project_bwd(dz, x, w, with_bias=True)
    ref = fold_project_bwd_plain(dz, x, w, with_bias=True)
    torch.cuda.synchronize()
    # the projection: f32 summation order, or one bf16 rounding (2^-8)
    ptol = 1e-5 if dt == torch.float32 else 2.0 ** -7
    texts, ok, errs = [], True, []
    for name, a, r, tol in (("qkv", qkv, ref_qkv, ptol), ("qw", qw, ref_qw, ptol),
                            ("dx", got[0], ref[0], BWD_TOL[dtype_name]),
                            ("dW", got[1], ref[1], BWD_TOL["float32"]),
                            ("db", got[2], ref[2], 1e-5)):
        err, scale = _rel_err(a, r)
        ok = ok and bool(torch.isfinite(a).all()) and err <= tol * scale
        texts.append(f"{name} {err:.3e} (tol {tol} x {scale:.3e})")
        errs.append(err)
    label = f"row 6 bias form and the projection {dtype_name} N {n}"
    log(f"{label}: " + ", ".join(texts))
    if not ok:
        raise AssertionError(f"{label}: " + ", ".join(texts))
    ms = graph_time_ms(lambda: transformer_project(*args))
    plain_ms = graph_time_ms(lambda: transformer_project_plain(*args))
    bcat, q = torch.cat(bs), qkv[:, :hc]
    library_ms = graph_time_ms(lambda: (torch.addmm(bcat, x, w),
                                        torch.matmul(q, wblk)))
    isz = x.element_size()
    # x, the weights, biases and wblk read once; qkv and qw written once
    nbytes = isz * (x.numel() + w.numel() + bcat.numel() + wblk.numel()
                    + qkv.numel() + qw.numel())
    flops = 2 * n * f * 3 * hc + 2 * n * hc * 4
    bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOPS
                               if dt == torch.bfloat16 else H100_FP32_FLOPS)
    log(f"projection transformer_project {dtype_name} N {n}: ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms (addmm + matmul) "
        f"{library_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
    return dict(max_abs_err=max(errs[:2]), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


# row 6 at the main path's three shapes: (label, dz width, F, x's row
# stride, bias form) — the GAT form (dz [N, H·C] against W [F, H·C]), the
# Transformer's wblk form (dqw [N, H·4] against wblk [H·C, H·4], x the q
# column block of the [N, 3·H·C] q|k|v buffer) and the bias form (dz
# [N, 3·H·C] against [Wq | Wk | Wv])
ROW6_SHAPES = (("GAT", HEADS * HIDDEN, HIDDEN, HIDDEN, False),
               ("wblk", HEADS * 4, HEADS * HIDDEN, 3 * HEADS * HIDDEN, False),
               ("bias", 3 * HEADS * HIDDEN, HIDDEN, HIDDEN, True))


def check_row6_shapes(n, gen):
    """Row 6 against its plain version at ROW6_SHAPES in f32 and bf16, at
    the flagship's N (timed, with the two torch.matmul calls (+ sum) of the
    same products and the bound) and at a ragged N − 32 (not a multiple of
    128); dx within BWD_TOL, dW within f32 summation order (bf16 operands'
    products are exact in f32), db 1e-5.  Returns the timed rows by
    (label, dtype)."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded_bwd import (
        fold_project_bwd, fold_project_bwd_plain)

    dev = torch.device("cuda")
    rows = {}
    for label, hc, f, ldx, bias in ROW6_SHAPES:
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            dz = torch.randn(n, hc, generator=gen).to(dev, dt)
            wide = torch.randn(n, ldx, generator=gen).to(dev, dt)
            x = wide[:, :f]
            w = (torch.randn(f, hc, generator=gen) * f ** -0.5).to(dev, dt)
            for m in (n, n - 32):
                got = fold_project_bwd(dz[:m], x[:m], w, with_bias=bias)
                ref = fold_project_bwd_plain(dz[:m], x[:m], w, with_bias=bias)
                torch.cuda.synchronize()
                texts, ok = [], True
                for name, a, r, tol in zip(
                        ("dx", "dW", "db"), got, ref,
                        (BWD_TOL[dtype_name], BWD_TOL["float32"], 1e-5)):
                    err, scale = _rel_err(a, r)
                    ok = ok and bool(torch.isfinite(a).all()) \
                        and err <= tol * scale
                    texts.append(f"{name} {err:.3e} (tol {tol} x {scale:.3e})")
                what = (f"row 6 {label} form {dtype_name} dz [{m}, {hc}] x "
                        f"[{m}, {f}] (row stride {ldx})")
                log(f"{what}: " + ", ".join(texts))
                if not ok:
                    raise AssertionError(f"{what}: " + ", ".join(texts))
                if m == n:
                    err6 = max(_rel_err(a, r)[0] for a, r in zip(got, ref))
            wt = w.t()
            ms = graph_time_ms(lambda: fold_project_bwd(dz, x, w,
                                                        with_bias=bias))
            plain_ms = graph_time_ms(
                lambda: fold_project_bwd_plain(dz, x, w, with_bias=bias), 3, 2)
            lib_ms = graph_time_ms(
                (lambda: (dz @ wt, x.t() @ dz, dz.sum(0))) if bias
                else (lambda: (dz @ wt, x.t() @ dz)))
            isz = x.element_size()
            # dz, x, W read once; dx and the f32 dW (and db) written once
            b6 = bound(dz.numel() * isz + 2 * n * f * isz + w.numel() * isz
                       + (f + int(bias)) * hc * 4, 4 * n * f * hc,
                       H100_BF16_FLOPS if dt == torch.bfloat16
                       else H100_FP32_FLOPS)
            log(f"row 6 fold_project_bwd {label} form {dtype_name} dz [{n}, "
                f"{hc}]: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                f"(2 x torch.matmul{' + sum' if bias else ''}) {lib_ms:.4f} "
                f"bound_ms {b6[0]:.5f} ({b6[1]})")
            rows[(label, dtype_name)] = dict(
                max_abs_err=err6, ms=ms, plain_ms=plain_ms, bound_ms=b6[0],
                bound_by=b6[1], library_ms=lib_ms)
    return rows


def check_projgrad(band, dtype_name, rate, gen):
    """The projgrad op (projection, rows 9, 10, 7 and 6) at the flagship
    width through the kernels and through the plain versions on the card:
    out, s and every cotangent within BWD_TOL of each one's max (dbk, zero
    in exact arithmetic, of the largest cotangent's)."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded import (
        banded_transformer_geo_mean_projgrad)

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name)
    mask = band.bias_noself
    n, f, hc = mask.shape[0] * mask.shape[1], HIDDEN, HEADS * HIDDEN
    x = torch.randn(n, f, generator=gen).to(dev, dt)
    ws = [(torch.randn(f, hc, generator=gen) * f ** -0.5).to(dev, dt)
          for _ in range(3)]
    bs = [(0.1 * torch.randn(hc, generator=gen)).to(dev, dt) for _ in range(3)]
    w_e = torch.rand(4, HEADS, HIDDEN, generator=gen) - 0.5
    wblk = (torch.eye(HEADS)[:, None, :, None]
            * w_e.permute(1, 2, 0)[:, :, None, :]).reshape(hc, HEADS * 4)
    wblk = wblk.to(dev, dt)
    g = torch.randn(n, HIDDEN, generator=gen).to(dev, dt)
    gs = torch.randn(n, HEADS * 4, generator=gen).to(dev)
    seed = torch.tensor([99], dtype=torch.int32, device=dev) if rate else None
    results = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_()
                  for t in (x, *ws, *bs, wblk)]
        with plain_versions() if plain else contextlib.nullcontext():
            out, s = banded_transformer_geo_mean_projgrad(
                mask, band.geo, band.pos, *leaves, HEADS, rate, seed)
            torch.autograd.backward((out, s), (g, gs))
        results.append(([out.detach(), s.detach()],
                        [t.grad for t in leaves]))
    torch.cuda.synchronize()
    (fwd_k, g_k), (fwd_p, g_p) = results
    top = max(t.float().abs().max().item() for t in g_p)
    texts, ok = [], True
    names = ("out", "dx", "dWq", "dWk", "dWv", "dbq", "dbk", "dbv", "dwblk")
    for name, a, b in zip(names, [fwd_k[0], *g_k], [fwd_p[0], *g_p]):
        err, scale = _rel_err(a, b)
        scale = top if name == "dbk" else scale
        ok = ok and bool(torch.isfinite(a).all()) \
            and err <= BWD_TOL[dtype_name] * scale
        texts.append(f"{name} {err:.2e}/{scale:.2e}")
    label = f"projgrad op {dtype_name} rate {rate} Wcols {mask.shape[-1]}"
    log(f"{label}, max_abs_err/scale: " + ", ".join(texts))
    if not ok:
        raise AssertionError(f"{label}: " + ", ".join(texts))


def train_transformer(tmp, case, info):
    """``train --layer_type Transformer`` (4×256, bf16, dropout 0.1,
    geo edge-conditioned), the loss must fall and the checkpoint serve;
    then the no-edge path through the ``Trainer``.  Returns the launch
    counts of both runs."""
    import json as _json

    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
    from gnn_bfs_rans_tpu_torch.kernels import _build
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig
    from gnn_bfs_rans_tpu_torch.train.data import load_dataset
    from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig
    from gnn_bfs_rans_tpu_torch.train.trainer import Trainer

    out = tmp / "train_transformer"
    argv = ["train", "--case_path", str(case), "--time_dirs", *TRAIN_TIMES,
            "--output_dir", str(out), "--layer_type", "Transformer",
            "--hidden_dim", str(HIDDEN), "--num_layers", str(LAYERS),
            "--epochs", str(TR_EPOCHS), "--save_every", str(TR_EPOCHS),
            "--lr", "1e-3", "--dropout", str(DROPOUT), "--compute_dtype",
            "bfloat16", "--device", "cuda"]
    t = time.time()
    _build.reset_launches()    # the Transformer training path starts here
    rc = cli_main(argv)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)  # ... and ends here
    log(f"train (Transformer 4x256 bf16, geo): {TR_EPOCHS} epochs in "
        f"{time.time() - t:.1f} s, launches {launches}")
    if rc != 0:
        raise RuntimeError(f"train returned {rc}")
    losses = _json.loads((out / "training_history.json").read_text())[
        "train_loss"]
    log(f"train losses (Transformer) {losses}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"Transformer training did not lower the loss: "
                             f"{losses}")
    meta = _json.loads((out / f"epoch_{TR_EPOCHS}.meta.json").read_text())
    if not (meta["model_config"]["layer_type"] == "Transformer"
            and meta.get("bn_recalibrated")):
        raise AssertionError(f"bad Transformer checkpoint meta: {meta}")
    pred = tmp / "train_transformer_pred"
    rc = cli_main(["infer", "--checkpoint", str(out), "--case_path",
                   str(case), "--output_dir", str(pred), "--reference_time",
                   "100", "--device", "cuda"])
    if rc != 0:
        raise RuntimeError(f"infer of the Transformer checkpoint returned {rc}")
    fields = dict(np.load(pred / "predictions.npz"))
    if fields["U"].shape != (info["n_cells"], 3) or not all(
            np.isfinite(v).all() for v in fields.values()):
        raise AssertionError("bad predictions from the Transformer checkpoint")
    comp = _json.loads((pred / "comparison.json").read_text())
    log(f"served the trained Transformer: U mae {comp['U']['mae']:.4e}, "
        f"p mae {comp['p']['mae']:.4e}")
    # the no-edge path: rows 9, 10 and 7 (the projections stay dense)
    dataset = load_dataset(case, list(TRAIN_TIMES), with_band=True,
                           band_components=("bias_noself",))
    mcfg = ModelConfig(hidden_dim=HIDDEN, num_layers=LAYERS,
                       layer_type="Transformer", heads=HEADS,
                       backend="pallas", dropout=DROPOUT,
                       compute_dtype="bfloat16", use_edge_attr=False)
    t = time.time()
    _build.reset_launches()    # the no-edge training path starts here
    tr = Trainer(dataset, mcfg, TrainConfig(lr=1e-3, epochs=2, save_every=2),
                 output_dir=tmp / "train_transformer_noedge",
                 log_fn=lambda *a: None, device="cuda")
    tr.initialize()
    hist = tr.train()
    torch.cuda.synchronize()
    noedge = dict(_build.LAUNCHES)    # ... and ends here
    log(f"train Transformer without edges bf16: 2 epochs in "
        f"{time.time() - t:.1f} s, losses {hist['train_loss']}, launches "
        f"{noedge}")
    if not np.isfinite(hist["train_loss"]).all():
        raise AssertionError("no-edge Transformer training: non-finite loss")
    for what, counts, names in (
            ("geo", launches, ("transformer_project", "banded_transformer_fwd",
                               "banded_transformer_bwd", "fold_partials",
                               "fold_project_bwd", "fused_epilogue_fwd",
                               "fused_epilogue_bwd")),
            ("no-edge", noedge, ("banded_transformer_fwd",
                                 "banded_transformer_bwd", "fold_partials"))):
        missing = [k for k in names if counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"the {what} Transformer training path never "
                                 f"launched {missing}")
    return launches, noedge


def transformer_train_phase(tmp, case, train_info, edge_bands, gen):
    """Rows 9 (dropout form), 10, 7 and 6 (bias form) and the projgrad op
    against their plain versions on both Transformer boxes; one train step
    kernels vs plain; then training.  Returns (rows, launch counts)."""
    from gnn_bfs_rans_tpu_torch.infer import load_graph

    rows = {}
    for nx in (163, 400):
        band = load_graph(tmp / f"box{nx}", "Transformer").band.to("cuda")
        edge_band = edge_bands[nx]
        for form in ("plain", "edge", "geo"):
            b = edge_band if form == "edge" else band
            for mean in (True, False):
                for dt in ("float32", "bfloat16"):
                    # f32 too: its times and bounds; the kernels line
                    # takes bf16
                    measure = nx == 400 and form == "geo" and mean
                    row = check_transformer(b, form, mean, dt, gen,
                                            measure=measure, rate=DROPOUT)
                    if measure and dt == "bfloat16":
                        rows["tr_drop"] = row
                    for rate in (0.0, DROPOUT):
                        r10, r7 = check_transformer_bwd(
                            b, form, mean, dt, rate, gen,
                            measure=measure and rate == DROPOUT)
                        if r10 and dt == "bfloat16":
                            rows["row10"], rows["row7"] = r10, r7
        for dt in ("float32", "bfloat16"):
            for rate in (0.0, DROPOUT):
                check_projgrad(band, dt, rate, gen)
    for dt in ("float32", "bfloat16"):
        rows[("project", dt)] = check_project_bias(
            band.bias_noself.shape[0] * band.tile, dt, gen)
    graph = load_graph(case, "Transformer").to("cuda")
    for dt in ("float32", "bfloat16", "mixed"):
        compare_train_step(graph, dt, "transformer4x256",
                           layer_type="Transformer")
    # what the step's gaps are made of: f32 without dropout and without the
    # geo term, and the mixed step's ratios from a second seeded init
    compare_train_step(graph, "float32", "transformer4x256-dropout0",
                       layer_type="Transformer", dropout=0.0)
    compare_train_step(graph, "float32", "transformer4x256-noedge",
                       layer_type="Transformer", use_edge_attr=False)
    compare_train_step(graph, "mixed", "transformer4x256-init2",
                       model_seed=2, layer_type="Transformer")
    launches, noedge = train_transformer(tmp, tmp / "train_case", train_info)
    return rows, launches, noedge


# ------------------------------------------------------------ phase 16
def check_gat_concat(graph, dtype_name, rate, gen, measure=False):
    """Row 4's concat form and row 5's per-head cotangent, each kernel
    alone vs its plain version at the flagship width (H 4, C 256); with
    ``measure`` their times (returned as two rows)."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded import (banded_gat,
                                                       banded_gat_plain)
    from gnn_bfs_rans_tpu_torch.kernels.banded_bwd import (
        banded_gat_bwd, banded_gat_bwd_plain)

    dt = getattr(torch, dtype_name)
    n = graph.n_pad
    mask = graph.band.bias_self
    x, w, wa, _, seed = _gat_inputs(n, dt, gen)
    seed = seed if rate else None
    hc = HEADS * HIDDEN
    g = torch.randn(n, hc, generator=gen).to("cuda", dt)
    z = (x.float() @ w.float()).to(dt)
    alphas = (x.float() @ wa.float()).contiguous()
    a4 = (mask, z, alphas, HEADS, 0.2, rate, seed)
    a5 = (mask, z, alphas, g, HEADS, 0.2, rate, seed, False)
    kw5 = dict(mask_t=graph.band.transposed("bias_self"))
    out = banded_gat(*a4)
    dz, da = banded_gat_bwd(*a5, **kw5)
    ref = banded_gat_plain(*a4)
    ref_dz, ref_da = banded_gat_bwd_plain(*a5)
    torch.cuda.synchronize()
    err4, scale4 = _rel_err(out, ref)
    err5, scale5 = _rel_err(dz, ref_dz)
    errs = (("row 4 concat out", err4, scale4, GAT_TOL[dtype_name]),
            ("row 5 per-head dz", err5, scale5, BWD_TOL[dtype_name]),
            ("row 5 per-head dalpha", *_rel_err(da, ref_da),
             BWD_TOL[dtype_name]))
    for what, err, scale, tol in errs:
        log(f"{what} {dtype_name} rate {rate} Wcols {mask.shape[-1]}: "
            f"max_abs_err {err:.3e} (tol {tol} x {scale:.3e})")
        if not err <= tol * scale:
            raise AssertionError(f"{what} {dtype_name} rate {rate}: {err}")
    if out.shape != (n, hc) or not (torch.isfinite(out).all()
                                    and torch.isfinite(dz).all()):
        raise AssertionError(f"row 4 concat / row 5 per-head: shape "
                             f"{tuple(out.shape)} or non-finite values")
    if not measure:
        return None
    ms4 = graph_time_ms(lambda: banded_gat(*a4))
    eager4 = cuda_time_ms(lambda: banded_gat(*a4))
    plain4 = graph_time_ms(lambda: banded_gat_plain(*a4), 3, 2)
    ms5 = graph_time_ms(lambda: banded_gat_bwd(*a5, **kw5))
    plain5 = graph_time_ms(lambda: banded_gat_bwd_plain(*a5), 3, 2)
    profile_forward(lambda: banded_gat_bwd(*a5, **kw5),
                    f"row 5 per-head {dtype_name} by kernel", steps=10)
    nnz = int(mask.sum().item())
    isz = z.element_size()
    # row 4: mask, z and α read once, out [N, H·C] written once; row 5:
    # mask, z, α and g [N, H·C] read once, dz and dα written once.  The f32
    # SIMT work is the sparse products: 2·C operations per nonzero entry
    # and head (row 4), dp and dz (row 5)
    b4 = bound(mask.numel() + 2 * n * hc * isz + n * 2 * HEADS * 4,
               2 * nnz * hc, H100_FP32_FLOPS)
    b5 = bound(mask.numel() + 3 * n * hc * isz + 2 * n * 2 * HEADS * 4,
               4 * nnz * hc, H100_FP32_FLOPS)
    log(f"row 4 banded_gat (concat) {dtype_name} rate {rate} N {n} nnz "
        f"{nnz}: ms {ms4:.4f} (eager {eager4:.4f}) plain_ms {plain4:.4f} "
        f"bound_ms {b4[0]:.5f} ({b4[1]})")
    log(f"row 5 banded_gat_bwd (per-head) {dtype_name} rate {rate}: ms "
        f"{ms5:.4f} plain_ms {plain5:.4f} bound_ms {b5[0]:.5f} ({b5[1]})")
    return (dict(max_abs_err=err4, ms=ms4, plain_ms=plain4, bound_ms=b4[0],
                 bound_by=b4[1], library_ms=None),
            dict(max_abs_err=err5, ms=ms5, plain_ms=plain5, bound_ms=b5[0],
                 bound_by=b5[1], library_ms=None))


def concat_conv(graph, dtype_name, gen):
    """One forward and backward of ``GATConv(256, heads=4, concat=True)``
    (dropout 0.1) through the kernels, then through the plain versions on
    the same weights and masks: the output and every gradient.  Returns
    the launch counts of the kernel run (the concat conv's path)."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels import _build
    from gnn_bfs_rans_tpu_torch.models.convs import GATConv

    dt = getattr(torch, dtype_name)
    conv = GATConv(HIDDEN, heads=HEADS, concat=True, dropout=DROPOUT,
                   backend="pallas")
    conv.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        conv.bias.normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(4))
    conv = conv.cuda()
    x = torch.randn(graph.n_pad, HIDDEN, generator=gen).to("cuda", dt)
    g = torch.randn(graph.n_pad, HEADS * HIDDEN, generator=gen).to("cuda", dt)
    seed = torch.tensor([4321], dtype=torch.int32, device="cuda")
    runs = []
    for plain in (False, True):
        conv.zero_grad()
        xl = x.clone().requires_grad_()
        with plain_versions() if plain else contextlib.nullcontext():
            _build.reset_launches()     # the concat conv's path starts here
            out = conv(xl, graph, train=True, seed=seed)
            out.backward(g)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)    # ... and ends here
        runs.append((out.detach(), {"x": xl.grad, **{
            k: p.grad.clone() for k, p in conv.named_parameters()}},
            launches))
    (out_k, g_k, launches), (out_p, g_p, _) = runs
    log(f"GATConv concat {dtype_name}: launches {launches}")
    if not (launches.get("banded_gat", 0) == 1
            and launches.get("banded_gat_bwd", 0) == 1):
        raise AssertionError(f"the concat conv did not run rows 4 (concat) "
                             f"and 5 (per-head): {launches}")
    err, scale = _rel_err(out_k, out_p)
    log(f"  out: max_abs_err {err:.3e} (tol {GAT_TOL[dtype_name]} x "
        f"{scale:.3e})")
    if out_k.shape != (graph.n_pad, HEADS * HIDDEN) or not (
            err <= GAT_TOL[dtype_name] * scale):
        raise AssertionError(f"concat conv {dtype_name} output: {err}")
    for name in g_p:
        err, scale = _rel_err(g_k[name], g_p[name])
        log(f"  grad {name}: max_abs_err {err:.3e} (tol "
            f"{BWD_TOL[dtype_name]} x {scale:.3e})")
        if not (torch.isfinite(g_k[name]).all()
                and err <= BWD_TOL[dtype_name] * scale):
            raise AssertionError(f"concat conv {dtype_name} grad {name}: "
                                 f"{err}")
    return launches


def backends_agree(graph, gen):
    """The three backends on the card: each conv at hidden 256 (GAT and the
    Transformer also concat) on the flagship case, f32, in its training
    form without dropout, its dense and segment outputs and gradients (in
    x and every parameter) against the banded path's on the same
    weights."""
    import torch
    from gnn_bfs_rans_tpu_torch.models import convs

    makers = {
        "GCN": lambda b: convs.GCNConv(HIDDEN, backend=b),
        "GIN": lambda b: convs.GINConv(HIDDEN, backend=b),
        "GAT": lambda b: convs.GATConv(HIDDEN, heads=HEADS, backend=b),
        "GAT-concat": lambda b: convs.GATConv(HIDDEN, heads=HEADS,
                                              concat=True, backend=b),
        "Transformer": lambda b: convs.TransformerConv(
            HIDDEN, heads=HEADS, edge_dim=4, backend=b),
        "Transformer-concat": lambda b: convs.TransformerConv(
            HIDDEN, heads=HEADS, edge_dim=4, concat=True, backend=b),
    }
    x = torch.randn(graph.n_pad, HIDDEN, generator=gen).cuda()
    worst = {}
    for name, make in makers.items():
        runs = {}
        for backend in ("pallas", "dense", "segment"):
            conv = make(backend)
            conv.reset_parameters(torch.Generator().manual_seed(7))
            with torch.no_grad():
                for k, p in conv.named_parameters():
                    if k.endswith("bias"):
                        p.normal_(0.0, 0.1, generator=torch.Generator()
                                  .manual_seed(8))
            conv = conv.cuda()
            xl = x.clone().requires_grad_()
            # the differentiable forms (training, no dropout): kernel 1's
            # eval form has no gradient
            kw = {} if name in ("GCN", "GIN") else dict(train=True)
            out = conv(xl, graph, **kw)
            gout = torch.randn(out.shape, generator=torch.Generator()
                               .manual_seed(9)).cuda()
            out.backward(gout)
            runs[backend] = {"out": out.detach(), "x": xl.grad, **{
                k: p.grad for k, p in conv.named_parameters()}}
        ref = runs["pallas"]
        # the key bias shifts every logit of a row alike: its gradient is
        # zero in exact arithmetic, held against the largest gradient
        g_max = max(v.abs().max().item() for k, v in ref.items()
                    if k != "out")
        for backend in ("dense", "segment"):
            for k, v in runs[backend].items():
                err, scale = _rel_err(v, ref[k])
                if k == "lin_key.bias":
                    scale = g_max
                worst[(name, backend)] = max(worst.get((name, backend), 0.0),
                                             err / max(scale, 1e-30))
                if not (torch.isfinite(v).all()
                        and err <= BACKEND_TOL * max(scale, 1e-30)):
                    raise AssertionError(f"{name} {backend} {k}: {err} vs "
                                         f"the banded path ({scale})")
    for (name, backend), rel in worst.items():
        log(f"backends agree: {name} {backend} vs pallas: worst relative "
            f"gap {rel:.3e} (out and gradients; tol {BACKEND_TOL})")


def train_cli(tmp, case, info, label, epochs, *extra):
    """``python -m gnn_bfs_rans_tpu_torch train`` (in process) with the
    CLI's default model and ``extra`` flags: the loss must fall and the
    checkpoint serve.  Returns the launch counts of the training run."""
    import json as _json

    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
    from gnn_bfs_rans_tpu_torch.kernels import _build

    out = tmp / f"train_{label}"
    argv = ["train", "--case_path", str(case), "--time_dirs", *TRAIN_TIMES,
            "--output_dir", str(out), "--epochs", str(epochs),
            "--save_every", str(epochs), "--lr", "1e-3", "--device", "cuda",
            *extra]
    t = time.time()
    _build.reset_launches()           # the training path starts here
    rc = cli_main(argv)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)  # ... and ends here
    log(f"train {label} ({' '.join(extra)}): {epochs} epochs in "
        f"{time.time() - t:.1f} s, launches {launches}")
    if rc != 0:
        raise RuntimeError(f"train {label} returned {rc}")
    losses = _json.loads((out / "training_history.json").read_text())[
        "train_loss"]
    log(f"train losses ({label}) {losses}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{label} training did not lower the loss: "
                             f"{losses}")
    pred = tmp / f"train_{label}_pred"
    rc = cli_main(["infer", "--checkpoint", str(out), "--case_path",
                   str(case), "--output_dir", str(pred), "--reference_time",
                   "100", "--device", "cuda"])
    if rc != 0:
        raise RuntimeError(f"infer of the {label} checkpoint returned {rc}")
    fields = dict(np.load(pred / "predictions.npz"))
    if fields["U"].shape != (info["n_cells"], 3) or not all(
            np.isfinite(v).all() for v in fields.values()):
        raise AssertionError(f"bad predictions from the {label} checkpoint")
    return launches


def pr6_phase(tmp, case, graphs, train_case, train_info, gen):
    """Phase 16: rows 4 (concat) and 5 (per-head) vs their plain versions,
    the concat conv, the three backends, serving on a mesh without a band,
    ``train --backend dense`` and LayerNorm training, and their times.
    Returns (kernel rows, the concat conv's launch counts)."""
    from gnn_bfs_rans_tpu_torch.foam import FoamCase, generate_box_case
    from gnn_bfs_rans_tpu_torch.graph.band import ALL_COMPONENTS
    from gnn_bfs_rans_tpu_torch.graph.build import build_graph
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig

    rows = {}
    t1 = time.time()
    for nx in (163, 400):
        for dt in ("float32", "bfloat16"):
            for rate in (0.0, DROPOUT):
                got = check_gat_concat(graphs[nx], dt, rate, gen,
                                       measure=nx == 400 and rate == DROPOUT)
                if got:
                    rows[("row4c", dt)], rows[("row5h", dt)] = got
    launches = {dt: concat_conv(graphs[400], dt, gen)
                for dt in ("float32", "bfloat16")}
    log(f"rows 4 (concat) and 5 (per-head), the concat conv: "
        f"{time.time() - t1:.1f} s")

    t1 = time.time()
    full = build_graph(FoamCase(case).load_mesh(), with_band=True,
                       band_components=ALL_COMPONENTS).to("cuda")
    backends_agree(full, gen)
    log(f"backends agree: {time.time() - t1:.1f} s")

    # the GAT 4x256 bf16 served on a 24^3 hex box, whose band would be
    # wider than 5 tiles: the dense branches, the epilogue under exact_bn
    t1 = time.time()
    hex_case = tmp / "hex24"
    hex_info = generate_box_case(hex_case, 24, 24, 24)
    if load_graph(hex_case, "GAT").band is not None:
        raise AssertionError("the 24^3 box was expected to have no band")
    gat_cfg = ModelConfig(hidden_dim=HIDDEN, num_layers=LAYERS,
                          layer_type="GAT", heads=HEADS, backend="pallas",
                          compute_dtype="bfloat16")
    serve(tmp, hex_case, hex_info, gat_cfg, f"gat{LAYERS}x{HIDDEN}-bf16-hex24",
          gen, runs={"off": {},
                     "on": {"fused_epilogue_fwd": 2 * LAYERS}})
    log(f"serving without a band: {time.time() - t1:.1f} s")

    # the JAX CLI's default training run (--backend dense), and LayerNorm
    t1 = time.time()
    train_cli(tmp, train_case, train_info, "gcn-dense", GCN_EPOCHS,
              "--backend", "dense")
    train_cli(tmp, train_case, train_info, "gcn-dense-layer", 2,
              "--backend", "dense", "--norm_type", "layer")
    step_times(tmp, train_case, "gcn6x256-f32-dense", layer_type="GCN",
               num_layers=GCN_LAYERS, backend="dense",
               compute_dtype="float32")
    step_times(tmp, train_case, "gcn6x256-f32-dense-layer", layer_type="GCN",
               num_layers=GCN_LAYERS, backend="dense", norm_type="layer",
               compute_dtype="float32")
    log(f"dense training: {time.time() - t1:.1f} s")
    return rows, launches


# ------------------------------------------------------------ phase 17
# the four training cells whose steps are timed eager and replayed
GRAPH_CELLS = (
    ("gat4x256-bf16-train", dict(layer_type="GAT", num_layers=LAYERS,
                                 compute_dtype="bfloat16")),
    ("gcn6x256-f32-train", dict(layer_type="GCN", num_layers=GCN_LAYERS,
                                compute_dtype="float32")),
    ("transformer4x256-bf16-train", dict(layer_type="Transformer",
                                         num_layers=LAYERS,
                                         compute_dtype="bfloat16")),
    ("transformer8x256-bf16-train", dict(layer_type="Transformer",
                                         num_layers=TR_DEEP_LAYERS,
                                         compute_dtype="bfloat16")),
)
# replays held against eager steps from one state.  Both run the same
# kernels on the same inputs in the same order, and the replays draw the
# eager stream's seeds and masks (the generator is registered with the
# graph): the losses and parameters must be bit-identical, at dropout 0
# and 0.1
GRAPH_STEPS = 3
BLOCK_EPOCHS = 6
ADAM_CELLS = ("gat4x256-bf16-train",)
ADAM_FORMS = (("foreach", dict(foreach=True)),
              ("foreach-capturable", dict(foreach=True, capturable=True)),
              ("fused-capturable", dict(fused=True, capturable=True)))


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


def _graph_trainer(tmp, dataset, label, dropout, **model):
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig
    from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig
    from gnn_bfs_rans_tpu_torch.train.trainer import Trainer

    mcfg = ModelConfig(hidden_dim=HIDDEN, heads=HEADS, backend="pallas",
                       dropout=dropout, **model)
    return Trainer(dataset, mcfg, TrainConfig(lr=1e-3),
                   output_dir=tmp / f"graphs_{label}_{dropout}",
                   log_fn=lambda *a: None, device="cuda")


def replays_vs_eager(tr, label):
    """``GRAPH_STEPS`` replays of the train step's graph and as many eager
    steps from one state must agree bit for bit; at dropout > 0 two
    replays from the same parameters and Adam state, the generator going
    on, must differ (fresh seeds and masks each replay)."""
    import torch
    from gnn_bfs_rans_tpu_torch.train.loop import train_step

    idx = torch.zeros(1, dtype=torch.int64, device="cuda")
    step = tr._step(False, 1)
    step(idx, 1e-3)                     # warm-up
    step(idx, 1e-3)                     # capture and replay
    snap = _snapshot(tr)
    runs = []
    for replay in (True, False):
        _restore(tr, snap)
        losses = [(step(idx, 1e-3) if replay else train_step(
            tr.model, tr.optimizer, tr.graph, tr.targets[idx], 1e-3,
            tr.config, tr.generator)).clone() for _ in range(GRAPH_STEPS)]
        runs.append((torch.stack(losses),
                     [p.detach().clone() for p in tr.model.parameters()]))
    (l_r, p_r), (l_e, p_e) = runs
    worst = max(float((a.float() - b.float()).abs().max()) for a, b in
                zip(p_r, p_e))
    same = torch.equal(l_r, l_e) and all(
        torch.equal(a, b) for a, b in zip(p_r, p_e))
    rate = tr.model_config.dropout
    msg = (f"graph {label} dropout {rate}: {GRAPH_STEPS} replays vs eager "
           f"steps: losses {l_r.tolist()} vs {l_e.tolist()}, largest "
           f"parameter gap {worst:.3e}")
    if rate:
        model, opt, _ = snap
        fresh = []
        for _ in range(2):
            _restore(tr, (model, opt, tr.generator.get_state()))
            fresh.append(step(idx, 1e-3).item())
        msg += f"; two replays from one state, the stream going on: {fresh}"
        if fresh[0] == fresh[1]:
            raise AssertionError(f"graph {label}: replays reuse their masks")
    log(msg)
    if not same:
        raise AssertionError(f"graph {label}: replays differ from eager "
                             f"steps (largest parameter gap {worst})")


def step_times_graphed(tr, label):
    """Host-clock quartiles of 20 train steps each ending in a synchronize,
    eager and replayed; the device time (the profiler's kernel sum, and
    for the replays the span of 20 back-to-back replays between CUDA
    events) and the idle share of each."""
    import torch
    from gnn_bfs_rans_tpu_torch.train.loop import train_step

    idx = torch.zeros(1, dtype=torch.int64, device="cuda")
    batch = tr.targets[idx]
    step = tr._step(False, 1)

    def eager():
        return train_step(tr.model, tr.optimizer, tr.graph, batch, 1e-3,
                          tr.config, tr.generator)

    def replay():
        return step(idx, 1e-3)

    # the device time of an eager step with each Adam form (the flagship
    # cell): the one the port ran before its steps were
    # captured (foreach, not capturable), the capturable foreach form, and
    # the port's (capturable, fused)
    adam = {}
    for form, kw in ADAM_FORMS if label in ADAM_CELLS else ():
        lr = (torch.tensor(1e-3, device="cuda") if "capturable" in kw
              else 1e-3)
        opt = torch.optim.Adam(tr.model.parameters(), lr=lr,
                               betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=tr.config.weight_decay, **kw)
        adam[form] = profile_forward(
            lambda: train_step(tr.model, opt, tr.graph, batch, 1e-3,
                               tr.config, tr.generator),
            f"train step {label} eager, Adam {form}", top=0)
    if adam:
        log(f"train step {label}: eager device time (profiler sum, ms) by "
            f"Adam form: " + ", ".join(f"{k} {v / 1e3:.4f}"
                                       for k, v in adam.items()))
    out = {}
    for name, fn in (("eager", eager), ("replayed", replay)):
        host = host_time_ms(fn)
        busy, idle = profile_forward(fn, f"train step {label} {name}",
                                     with_idle=True)
        # eager steps are host-bound: their span would be the host's
        span = event_time_ms(fn) if name == "replayed" else None
        out[name] = dict(host=host, busy=busy, idle=idle, span=span)
        log(f"train step {label} {name} N {tr.graph.n_nodes} dropout "
            f"{tr.model_config.dropout}: host clock median {host[1]:.4f} ms "
            f"(quartiles {host[0]:.4f}, {host[2]:.4f}; 20 steps), device "
            f"time (profiler sum) "
            f"{'not measured' if busy is None else f'{busy / 1e3:.4f} ms'}, "
            f"idle share "
            f"{'not measured' if idle is None else f'{idle:.3f}'} (1 - device "
            f"time / host median: "
            f"{'not measured' if busy is None else f'{1 - busy / 1e3 / host[1]:.3f}'})"
            + ("" if span is None else f"; 20 back-to-back steps span "
               f"{span:.4f} ms each on the card"))
    return out


def train_blocked(tmp, case, info):
    """``train --epoch_block 3`` of the flagship GAT (bf16, dropout 0.1, 6
    epochs, checkpoints every 3): rows 1, 2, 3, 5 and 6 launched (counted
    through the replays), the loss lower in the last epoch than in the
    first, the checkpoint served by ``infer``.  Returns the launch
    counts."""
    import json as _json

    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
    from gnn_bfs_rans_tpu_torch.kernels import _build

    out = tmp / "train_blocked"
    argv = ["train", "--case_path", str(case), "--time_dirs", *TRAIN_TIMES,
            "--output_dir", str(out), "--hidden_dim", str(HIDDEN),
            "--num_layers", str(LAYERS), "--layer_type", "GAT",
            "--compute_dtype", "bfloat16", "--dropout", str(DROPOUT),
            "--epochs", str(TRAIN_EPOCHS), "--save_every", "3",
            "--epoch_block", "3", "--lr", "1e-3", "--device", "cuda"]
    t = time.time()
    _build.reset_launches()           # the blocked training path starts here
    rc = cli_main(argv)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)  # ... and ends here
    log(f"train --epoch_block 3: {TRAIN_EPOCHS} epochs in "
        f"{time.time() - t:.1f} s, launches {launches}")
    if rc != 0:
        raise RuntimeError(f"train --epoch_block 3 returned {rc}")
    missing = [k for k in ("banded_gat_mean_fused", "fused_epilogue_fwd",
                           "fused_epilogue_bwd", "banded_gat_bwd",
                           "fold_project_bwd") if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"the blocked GAT training never launched "
                             f"{missing}")
    rows = [_json.loads(ln) for ln in
            (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in rows]
    log(f"blocked train losses {losses}; seconds an epoch "
        f"{[round(r['epoch_seconds'], 4) for r in rows]}")
    if [r["epoch"] for r in rows] != list(range(1, TRAIN_EPOCHS + 1)):
        raise AssertionError(f"blocked training epochs {rows}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"blocked training did not lower the loss: "
                             f"{losses}")
    for name in ("epoch_3", f"epoch_{TRAIN_EPOCHS}", "best"):
        if not (out / f"{name}.pt").is_file():
            raise AssertionError(f"blocked training saved no {name}")
    pred = tmp / "train_blocked_pred"
    rc = cli_main(["infer", "--checkpoint", str(out), "--case_path",
                   str(case), "--output_dir", str(pred), "--reference_time",
                   "100", "--device", "cuda"])
    if rc != 0:
        raise RuntimeError(f"infer of the blocked checkpoint returned {rc}")
    fields = dict(np.load(pred / "predictions.npz"))
    if fields["U"].shape != (info["n_cells"], 3) or not all(
            np.isfinite(v).all() for v in fields.values()):
        raise AssertionError("bad predictions from the blocked checkpoint")
    return launches


def block_idle(tr, label):
    """One block of ``BLOCK_EPOCHS`` epochs replayed as the blocked trainer
    runs it (after the body's warm-up and capture): host-clock wall from
    the first replay to the block's one synchronize, the span of the
    card's work between CUDA events, and the idle share they leave."""
    import torch
    from gnn_bfs_rans_tpu_torch.train.loop import init_epoch_block_carry

    tr.carry = init_epoch_block_carry(tr.model, tr.scheduler.lr,
                                      BLOCK_EPOCHS)
    body = tr._epoch(False)
    body()                              # warm-up
    body()                              # capture and replay
    tr.carry.slot.zero_()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(BLOCK_EPOCHS):
        body()
    end.record()
    rows = tr.carry.outs.tolist()       # the block's one synchronize
    wall = (time.perf_counter() - t) * 1e3
    span = start.elapsed_time(end)
    log(f"epoch block {label}: {BLOCK_EPOCHS} epochs of "
        f"{tr.dataset.n_snapshots} steps + eval, host wall {wall:.4f} ms "
        f"({wall / BLOCK_EPOCHS:.4f} an epoch), card span {span:.4f} ms, "
        f"idle share {1 - span / wall:.3f}; train losses "
        f"{[r[0] for r in rows]}")


def serve_graphed(tmp, case):
    """The GAT 4×256 bf16 ``Predictor`` (phase 4's checkpoint): its replayed
    forward equal to the eager forward bit for bit, and the host-clock
    quartiles of 20 forwards each way (each ending in a synchronize), the
    replay's device span (CUDA events) and the idle share it leaves."""
    import torch
    from gnn_bfs_rans_tpu_torch.infer import Predictor, load_graph

    ckpt = tmp / f"ckpt_gat{LAYERS}x{HIDDEN}-bf16"
    graph = load_graph(case, "GAT")
    for exact_bn in (False, True):
        pred = Predictor.from_checkpoint(ckpt, exact_bn=exact_bn)
        dev_graph = graph.to("cuda")
        fwd = pred._forward(graph)
        with torch.inference_mode():
            def eager():
                return pred.model(dev_graph, exact_bn=exact_bn)
            fwd()                       # warm-up
            got = fwd().clone()         # capture and replay
            if not torch.equal(got, eager()):
                raise AssertionError("the replayed Predictor forward differs "
                                     f"from the eager one (exact_bn "
                                     f"{exact_bn})")
            host_e = host_time_ms(eager)
            host_r = host_time_ms(fwd)
            span = event_time_ms(fwd)
        log(f"serve gat{LAYERS}x{HIDDEN}-bf16 Predictor exact_bn {exact_bn}: "
            f"host clock median eager {host_e[1]:.4f} ms (quartiles "
            f"{host_e[0]:.4f}, {host_e[2]:.4f}) -> replayed "
            f"{host_r[1]:.4f} ms ({host_r[0]:.4f}, {host_r[2]:.4f}); 20 "
            f"back-to-back replays span {span:.4f} ms each, idle share "
            f"(1 - span / replayed host median) {1 - span / host_r[1]:.3f}; "
            f"outputs bit-identical")


def graphs_phase(tmp, case, train_case, train_info):
    """Phase 17: the CUDA graphs of the train step, the epoch body and the
    serving forward.  Returns the blocked training run's launch counts."""
    from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
    from gnn_bfs_rans_tpu_torch.train.data import load_dataset

    datasets = {}
    for label, model in GRAPH_CELLS:
        layer = model["layer_type"]
        if layer not in datasets:
            datasets[layer] = load_dataset(
                train_case, list(TRAIN_TIMES), with_band=True,
                band_components=LAYER_COMPONENTS[layer])
        for rate in (0.0, DROPOUT):
            tr = _graph_trainer(tmp, datasets[layer], label, rate, **model)
            replays_vs_eager(tr, label)
        step_times_graphed(tr, label)   # dropout 0.1, as the cells train
    launches = train_blocked(tmp, train_case, train_info)
    gat = dict(GRAPH_CELLS)["gat4x256-bf16-train"]
    block_idle(_graph_trainer(tmp, datasets["GAT"], "block", DROPOUT, **gat),
               "gat4x256-bf16-train")
    serve_graphed(tmp, case)
    return launches


# ------------------------------------------------------------ phase 18
# the bench runs: (label, argv of `python -m gnn_bfs_rans_tpu_torch bench`,
# the kernels each must launch)
GAT_TRAIN_ROWS = ("banded_gat_mean_fused", "fused_epilogue_fwd",
                  "fused_epilogue_bwd", "banded_gat_bwd", "fold_project_bwd")
BENCH_RUNS = (
    ("b: gat4x256-bf16-train-trace",
     ["--mode", "train", "--trace", "--compute_dtype", "bfloat16"],
     GAT_TRAIN_ROWS),
    ("c: transformer8x256-bf16-forward",
     ["--layer_type", "Transformer", "--num_layers", str(TR_DEEP_LAYERS),
      "--compute_dtype", "bfloat16"], ("banded_transformer_fwd",)),
    ("d: gcn6x256-f32-forward",
     ["--layer_type", "GCN", "--num_layers", str(GCN_LAYERS)],
     ("banded_spmm",)),
)
# the scale runs: a ~1M-cell grid, 96 cells wide (the JAX package's default)
SCALE_CELLS, SCALE_NX = 1_000_000, 96
# the headline forward's chained marginal time vs the replayed Predictor's
# span of the same model shape (both device-bound replays of one forward)
HEADLINE_SPAN_TOL = 0.15


def _run_json(label, fn, names):
    """Run ``fn`` (which prints one JSON line) with the launch counters set
    to 0 just before and read just after; check ``names`` launched; print
    the JSON on its own line; return the result."""
    import io

    import torch
    from gnn_bfs_rans_tpu_torch.kernels import _build

    buf = io.StringIO()
    t = time.time()
    _build.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    if rc not in (None, 0):
        raise RuntimeError(f"bench {label} returned {rc}")
    line = buf.getvalue().strip().splitlines()[-1]
    result = json.loads(line)
    for name in names:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"bench {label}: {name} never launched "
                                 f"({counts})")
    log(f"bench {label}: {time.time() - t:.1f} s, launches {counts}")
    print(line, flush=True)
    return result


def check_at_scale(grid, gen):
    """The kernels of the 1M-cell GAT path (bf16, dropout 0 as the scale
    runs train) against their plain versions on the grid's band, once
    each, untimed: rows 1 (eval, and the training form emitting z), 5
    and 6, and rows 2 and 3 at 999,936 rows (their read-back branches)."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels.banded import (
        banded_gat_mean_fused, banded_gat_mean_fused_plain)
    from gnn_bfs_rans_tpu_torch.kernels.banded_bwd import (
        banded_gat_bwd, banded_gat_bwd_plain, fold_project_bwd,
        fold_project_bwd_plain)
    from gnn_bfs_rans_tpu_torch.kernels.epilogue import (
        _forward, _forward_plain, fused_epilogue_bwd,
        fused_epilogue_bwd_plain)

    def hold(what, got, ref, tol):
        err, scale = _rel_err(got, ref)
        log(f"1M cells {what}: max_abs_err {err:.3e} (tol {tol} x "
            f"{scale:.3e})")
        if not (torch.isfinite(got).all() and err <= tol * scale):
            raise AssertionError(f"1M cells {what}: max err {err} vs {scale}")

    dt, n = torch.bfloat16, grid.n_pad
    mask = grid.band.bias_self
    x, w, wa, g, _ = _gat_inputs(n, dt, gen)
    alphas = (x.float() @ wa.float()).contiguous()
    tol = GAT_TOL["bfloat16"]
    hold("row 1 eval", banded_gat_mean_fused(mask, w, alphas, x, HEADS),
         banded_gat_mean_fused_plain(mask, w, alphas, x, HEADS), tol)
    args = (mask, w, alphas, x, HEADS, 0.2, 0.0, None)
    out, z = banded_gat_mean_fused(*args, emit_z=True)
    ref_out, ref_z = banded_gat_mean_fused_plain(*args, emit_z=True)
    hold("row 1 training form", out, ref_out, tol)
    hold("row 1 training form z", z, ref_z, tol)
    del out, ref_out, ref_z
    tol = BWD_TOL["bfloat16"]
    a5 = (mask, z, alphas, g, HEADS, 0.2, 0.0, None)
    dz, da = banded_gat_bwd(*a5, mask_t=grid.band.transposed("bias_self"))
    ref_dz, ref_da = banded_gat_bwd_plain(*a5)
    hold("row 5 dz", dz, ref_dz, tol)
    hold("row 5 dalpha", da, ref_da, tol)
    del ref_dz, ref_da, z
    for name, got, ref in zip(("dx", "dW"), fold_project_bwd(dz, x, w),
                              fold_project_bwd_plain(dz, x, w)):
        hold(f"row 6 {name}", got, ref, tol)
    del dz
    xn = torch.randn(n, HIDDEN, generator=gen).to("cuda", dt)
    scale = (1 + 0.1 * torch.randn(HIDDEN, generator=gen)).to("cuda")
    bias = (0.1 * torch.randn(HIDDEN, generator=gen)).to("cuda")
    fwd_args = (x, xn, scale, bias, grid.n_nodes, 1e-5, 0.0, None)
    y, mean, _, xr, vec = _forward(*fwd_args)
    hold("row 2", y, _forward_plain(*fwd_args)[0], EPI_TOL["bfloat16"])
    gy = torch.randn(n, HIDDEN, generator=gen).to("cuda", dt)
    bwd_args = (gy, xr, vec, mean, grid.n_nodes, 0.0, None, dt, dt)
    for name, got, ref in zip(("dx", "dx_new", "dscale", "dbias"),
                              fused_epilogue_bwd(*bwd_args),
                              fused_epilogue_bwd_plain(*bwd_args)):
        hold(f"row 3 {name}", got, ref,
             1e-4 if ref.dtype == torch.float32 else 2e-2)
    torch.cuda.synchronize()


def case_wall_time(tmp, case):
    """The 12,000-cell case served once, stage by stage, on the host clock
    (each stage ending in a synchronize): what one ``infer`` call pays."""
    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.foam import FoamCase
    from gnn_bfs_rans_tpu_torch.foam.writer import save_fields_openfoam_format
    from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
    from gnn_bfs_rans_tpu_torch.graph.build import build_graph
    from gnn_bfs_rans_tpu_torch.infer import Predictor, predict_case

    ckpt = tmp / f"ckpt_gat{LAYERS}x{HIDDEN}-bf16"
    stages = {}

    def stage(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t) * 1e3
        return out

    pred = stage("checkpoint_load", lambda: Predictor.from_checkpoint(ckpt))
    mesh = stage("case_read", lambda: FoamCase(case).load_mesh())
    graph = stage("graph_build_rcm_band", lambda: build_graph(
        mesh, with_band=True,
        band_components=LAYER_COMPONENTS["GAT"]).to("cuda"))
    # a served case's one forward runs eagerly (the graph's warm-up); the
    # second call captures its CUDA graph, later calls replay it
    fields = stage("forward_first_call", lambda: pred.predict_fields(graph))
    stage("forward_capture", lambda: pred.predict_fields(graph))
    stage("forward_replayed", lambda: pred.predict_fields(graph))
    stage("openfoam_writeback", lambda: save_fields_openfoam_format(
        fields, tmp / "wall_time_out", "predicted"))
    stage("predict_case_end_to_end", lambda: predict_case(ckpt, case))
    if fields["U"].shape != (graph.n_nodes, 3) or not all(
            np.isfinite(v).all() for v in fields.values()):
        raise AssertionError("bad fields in the case wall-time run")
    log(json.dumps({"case_wall_time_ms": {
        "case": "box 400x30x1 (12,000 cells)", "model": "gat4x256-bf16",
        **stages}}))


def bench_phase(tmp, case):
    """Phase 18: the bench harness on the card (see the module
    docstring)."""
    import torch
    from gnn_bfs_rans_tpu_torch import bench as headline
    from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
    from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
    from gnn_bfs_rans_tpu_torch.infer import Predictor, load_graph
    from gnn_bfs_rans_tpu_torch.utils import profiling, roofline
    from gnn_bfs_rans_tpu_torch.utils.synthetic import (build_grid_graph,
                                                        run_scale_benchmark)

    kind = roofline.device_peak("cuda").kind
    if "h100" not in kind:
        raise AssertionError(f"device kind {kind!r} does not name the H100")
    runs = {}
    # (a) the headline line
    line = _run_json("a: headline gat4x256-bf16-forward",
                        lambda: headline.main(["--case_path", str(case)]),
                        ("banded_gat_mean_fused",))
    d = line["detail"]
    if line["mfu"] is None or d["platform"] != "gpu":
        raise AssertionError(f"headline: no MFU on the card ({line})")
    if not d["cross_check"]["steady_available"]:
        raise AssertionError("headline: no steady-state cross-check")
    if d["roofline_min_s"] > 1.05 * d["step_median_s"]:
        raise AssertionError("headline: time below the roofline")
    runs["a"] = line
    # the replayed Predictor's span of the same model shape
    pred = Predictor.from_checkpoint(tmp / f"ckpt_gat{LAYERS}x{HIDDEN}-bf16")
    graph = load_graph(case, "GAT")
    with torch.inference_mode():
        fwd = pred._forward(graph)
        fwd()
        span = event_time_ms(fwd)
    ratio = d["step_median_s"] * 1e3 / span
    log(f"headline chained marginal {d['step_median_s'] * 1e3:.4f} ms vs the "
        f"replayed Predictor's span {span:.4f} ms: ratio {ratio:.3f}")
    if abs(ratio - 1) > HEADLINE_SPAN_TOL:
        raise AssertionError(f"the chained marginal time is {ratio:.3f}x the "
                             "Predictor's replayed span")
    # (b)-(d) through the CLI
    for label, argv, names in BENCH_RUNS:
        runs[label[0]] = _run_json(label, lambda: cli_main(
            ["bench", "--case_path", str(case), "--backend", "pallas",
             *argv]), names)
    tr = runs["b"]["trace"]
    if tr["device_total_s_per_step"] <= 0:
        raise AssertionError("bench --trace recorded no device time")
    log(f"bench b: trace device total {tr['device_total_ms_per_step']:.4f} "
        f"ms a step, trace_over_chained {tr['trace_over_chained']:.3f}; "
        "parameters finite after the chain")
    # (e) a million cells
    t = time.perf_counter()
    grid = build_grid_graph(SCALE_NX, SCALE_CELLS // SCALE_NX,
                            band_components=LAYER_COMPONENTS["GAT"])
    log(f"grid {SCALE_NX} x {SCALE_CELLS // SCALE_NX}: {grid.n_nodes} cells, "
        f"{grid.n_edges} edges, n_pad {grid.n_pad}, band "
        f"{tuple(grid.band.bias_self.shape)}, host build "
        f"{time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    check_at_scale(grid.to("cuda"), torch.Generator().manual_seed(18))
    graph_bytes = roofline.graph_static_bytes(grid)
    del grid
    torch.cuda.empty_cache()
    log(f"1M-cell kernel checks: {time.perf_counter() - t:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    scale = {"forward": _run_json(
        "e: gat4x256-bf16-1M-forward", lambda: cli_main(
            ["bench", "--synthetic", str(SCALE_CELLS), "--backend", "pallas",
             "--compute_dtype", "bfloat16"]), ("banded_gat_mean_fused",))}

    def scale_train():
        print(json.dumps(run_scale_benchmark(
            n_nodes=SCALE_CELLS, layer_type="GAT", num_layers=LAYERS,
            hidden_dim=HIDDEN, backend="pallas", compute_dtype="bfloat16",
            steps=16, nx=SCALE_NX, mode="train")))
    scale["train"] = _run_json("e: gat4x256-bf16-1M-train", scale_train,
                               GAT_TRAIN_ROWS)
    # the scale results carry no roofline (as the JAX package's): the
    # same report from their times, the GAT 4x256 model's parameters and
    # the grid's bytes, with the guard
    for mode, res in scale.items():
        roof = roofline.analyze(
            layer_type="GAT", num_layers=LAYERS, hidden_dim=HIDDEN,
            n_nodes=res["n_nodes"], n_edges=res["n_edges"],
            time_s=res["step_median_s"], mode=mode,
            param_count=runs["b"]["n_params"], graph_bytes=graph_bytes,
            device="cuda")
        roofline.check_roofline(roof["matmul_flops"], res["step_median_s"],
                                device="cuda")
        log(json.dumps({"scale_roofline": {"mode": mode, **{
            k: roof[k] for k in ("matmul_flops", "flops_per_sec", "mfu",
                                 "bound", "hbm_frac", "roofline_min_s")}}}))
    peak = profiling.device_memory_stats()["cuda:0"]["allocated_bytes.all.peak"]
    log(f"1M-cell runs: peak device memory allocated {peak / 2**30:.2f} GiB")
    case_wall_time(tmp, case)


# ------------------------------------------------------------ phase 19
# the reference's own models (train.py:268-300 defaults: hidden 256, 6
# layers, 4 heads, dropout 0.1, BatchNorm), served from its .pt format:
# (label, layer type, edge_dim; the reference builds TransformerConv
# without edge_dim, the last model carries lin_edge)
REF_MODELS = (("ref-gcn6x256-f32", "GCN", None),
              ("ref-gat6x256-f32", "GAT", None),
              ("ref-gin6x256-f32", "GIN", None),
              ("ref-transformer6x256-f32", "Transformer", None),
              ("ref-transformer6x256-f32-lin_edge", "Transformer", 4))
REF_LAYERS = 6


def _no_dropout_(model):
    """Dropout off in train mode: BatchNorm then normalizes with the batch
    statistics and nothing else is random (the ``exact_bn`` forward)."""
    from torch import nn

    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
        elif isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0


def _field_gaps(got, want, norm):
    """Per field, the denormalized max |got − want| / max |want|, and the
    JAX package's parity bound (``tests/test_parity_torch.py:116-139``):
    rtol 1e-3, atol 1e-3·max|field| + 1e-3·std_field, elementwise."""
    import numpy as np
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import split_fields

    ours = norm.inverse_transform(split_fields(got))
    theirs = norm.inverse_transform(split_fields(want))
    gaps, ok = {}, True
    for f, v in theirs.items():
        scale = float(np.abs(v).max()) + 1e-12
        std_f = float(np.max(np.asarray(norm.scalers[f]["std"])))
        diff = np.abs(ours[f] - v)
        ok &= bool((diff <= 1e-3 * np.abs(v) + 1e-3 * scale
                    + 1e-3 * std_f).all())
        gaps[f] = float(diff.max()) / scale
    return gaps, ok


def serve_reference(pt, graph, ref_out, label, conv, norm, exact_bn=False):
    """Phase 19's serving of one reference .pt: launches of the first
    (eager) forward, the replay bit for bit, RefFlowGNN's output held to
    the parity bound, the plain versions' to SERVE_TOL, then times."""
    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.infer import Predictor
    from gnn_bfs_rans_tpu_torch.kernels import _build

    pred = Predictor.from_torch_checkpoint(pt, exact_bn=exact_bn)
    if pred.model_config.backend != "pallas" or pred.exact_bn != exact_bn:
        raise AssertionError(f"{label}: served on {pred.model_config}")
    layers = pred.model_config.num_layers
    want = {conv: layers}
    if exact_bn:
        want["fused_epilogue_fwd"] = 2 * layers
    _build.reset_launches()
    got = pred.predict_packed(graph)          # eager: the graph's warm-up
    torch.cuda.synchronize()
    moved = {k: v for k, v in _build.LAUNCHES.items() if v}
    if moved != want:
        raise AssertionError(f"{label}: launches {moved}, expected {want}")
    if not np.array_equal(pred.predict_packed(graph), got):
        raise AssertionError(f"{label}: the replayed forward differs from "
                             "the eager one")
    if not np.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite output")
    gaps, ok = _field_gaps(got, ref_out, norm)
    norm_gap = float(np.abs(got - ref_out).max())
    ok &= bool(np.allclose(got, ref_out, rtol=1e-3, atol=5e-4))
    dev_graph = graph.to("cuda")
    with torch.inference_mode(), plain_versions():
        plain = pred.model(dev_graph, exact_bn=exact_bn)[: graph.n_nodes]
    perm = graph.perm.numpy()[: graph.n_nodes]
    plain_orig = np.empty_like(got)
    plain_orig[perm] = plain.float().cpu().numpy()
    plain_err = float(np.abs(got - plain_orig).max())
    plain_tol = SERVE_TOL * float(np.abs(plain_orig).max())
    log(f"{label}{' exact_bn' if exact_bn else ''}: launches {moved}; vs "
        f"RefFlowGNN max |normalized gap| {norm_gap:.3e} (bound rtol 1e-3, "
        f"atol 5e-4), denormalized max gap / max |field| "
        + ", ".join(f"{f} {g:.3e}" for f, g in gaps.items())
        + f"; vs the plain versions max abs {plain_err:.3e} (tol "
        f"{plain_tol:.3e})")
    if not ok or plain_err > plain_tol:
        raise AssertionError(f"{label}: outside the stated bounds")
    fwd = pred._forward(graph)
    with torch.inference_mode():
        def eager():
            return pred.model(dev_graph, exact_bn=exact_bn)
        host_e = host_time_ms(eager)
        host_r = host_time_ms(fwd)
        span = event_time_ms(fwd)
        profile_forward(eager, f"{label}{' exact_bn' if exact_bn else ''} "
                        "eager", top=8)
    log(f"serve {label}{' exact_bn' if exact_bn else ''} f32 N "
        f"{graph.n_nodes}: host clock median eager {host_e[1]:.4f} ms "
        f"(quartiles {host_e[0]:.4f}, {host_e[2]:.4f}) -> replayed "
        f"{host_r[1]:.4f} ms ({host_r[0]:.4f}, {host_r[2]:.4f}); 20 "
        f"back-to-back replays span {span:.4f} ms each (device), idle "
        f"share {1 - span / host_r[1]:.3f}")
    return gaps


def export_round_trip(tmp, case, ref_in, gen):
    """``export-torch`` of a seeded GAT 4×256 bf16 port checkpoint: the
    .pt's tensors on the CPU, loaded by RefFlowGNN with ``strict=True``,
    whose f32 eval forward matches the port's f32 forward of the same
    weights."""
    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
    from gnn_bfs_rans_tpu_torch.compat.torch_ref import RefFlowGNN
    from gnn_bfs_rans_tpu_torch.infer import Predictor, load_graph
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
    from gnn_bfs_rans_tpu_torch.train.checkpoint import save_checkpoint

    cfg = ModelConfig(hidden_dim=HIDDEN, num_layers=LAYERS, layer_type="GAT",
                      heads=HEADS, backend="pallas", compute_dtype="bfloat16")
    model = FlowGNN(cfg, generator=gen)
    state = model.state_dict()

    def uniform(like, lo, hi):
        return lo + (hi - lo) * torch.rand(like.shape, generator=gen)

    # every bias and BatchNorm tensor away from its initial value, so a
    # dropped or swapped key shows in the forward
    for k, v in state.items():
        if k.endswith("bias"):
            state[k] = uniform(v, -0.1, 0.1)
        elif k.startswith("norms."):
            lo, hi = {"weight": (0.8, 1.2), "running_mean": (-0.3, 0.3),
                      "running_var": (0.5, 2.0)}[k.split(".")[-1]]
            state[k] = uniform(v, lo, hi)
    ckpt, out = tmp / "ckpt_export", tmp / "exported.pt"
    save_checkpoint(ckpt, "best", state, model_config=cfg, normalizer=None)
    if cli_main(["export-torch", "--checkpoint", str(ckpt), "--output",
                 str(out)]) != 0:
        raise AssertionError("export-torch failed")
    raw = torch.load(out, map_location=None, weights_only=False)
    devices = {v.device.type for v in raw["model_state_dict"].values()}
    ref = RefFlowGNN(hidden_dim=HIDDEN, num_layers=LAYERS, layer_type="GAT",
                     heads=HEADS)
    ref.load_state_dict(raw["model_state_dict"], strict=True)
    with torch.no_grad():
        want = ref.eval().to("cuda")(*ref_in).cpu().numpy()
    pred = Predictor.from_checkpoint(ckpt)
    f32 = FlowGNN(dataclasses.replace(pred.model_config,
                                      compute_dtype="float32"))
    f32.load_state_dict(pred.model.state_dict())
    pred.model = f32.eval().to("cuda")
    got = pred.predict_packed(load_graph(case, "GAT"))
    gap = float(np.abs(got - want).max())
    peak = float(np.abs(want).max())
    log(f"export-torch gat{LAYERS}x{HIDDEN}-bf16 -> reference .pt: tensors "
        f"on {sorted(devices)}, RefFlowGNN strict load, f32 forward max "
        f"|gap| vs the port's f32 forward {gap:.3e} (bound the f32 "
        f"tolerance: rtol 1e-5, atol 1e-5 x max |output| {peak:.3e})")
    if devices != {"cpu"} or not np.allclose(got, want, rtol=1e-5,
                                             atol=1e-5 * peak):
        raise AssertionError("export-torch round trip failed")


def mixed_prism(tmp, gen):
    """``generate_mixed_prism_case(16, 16, 7)`` (2,560 cells, triangle and
    quad faces, degree 8) served through ``predict_case`` by a seeded GCN
    and GAT (6×256 f32) on its band (SpMM W 5), rows 8 and 1 held against
    their plain versions there and the fields against the plain versions'."""
    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.foam import generate_mixed_prism_case
    from gnn_bfs_rans_tpu_torch.infer import load_graph, predict_case
    from gnn_bfs_rans_tpu_torch.kernels import _build
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
    from gnn_bfs_rans_tpu_torch.train.checkpoint import save_checkpoint

    case = tmp / "mixed"
    info = generate_mixed_prism_case(case, 16, 16, 7)
    for layer in ("GCN", "GAT"):
        cfg = ModelConfig(layer_type=layer, heads=HEADS, backend="pallas")
        ckpt = tmp / f"ckpt_mixed_{layer}"
        save_checkpoint(ckpt, "best", FlowGNN(cfg, generator=gen).state_dict(),
                        model_config=cfg, normalizer=None)
        _build.reset_launches()
        pred, fields, graph = predict_case(ckpt, case)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        band = graph.band
        if layer == "GCN" and band.gcn.shape[1] != 5:
            raise AssertionError(f"mixed case: SpMM window "
                                 f"{band.gcn.shape[1]}, expected 5")
        if launches != {CONV_KERNEL[layer]: cfg.num_layers}:
            raise AssertionError(f"mixed {layer}: launches {launches}")
        with plain_versions():
            plain = pred.predict_fields(load_graph(case, layer).to("cuda"))
        errs = {k: float(np.abs(fields[k] - v).max()) for k, v in plain.items()}
        log(f"mixed prism 16x16x7 ({info['n_cells']} cells, max degree "
            f"{int(graph.in_degree.max())}) {layer} 6x256 f32 predict_case: "
            f"Wcols {band.width_cols}, launches {launches}; fields vs "
            f"the plain versions max abs "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
        for k, v in plain.items():
            if errs[k] > SERVE_TOL * max(float(np.abs(v).max()), 1e-6):
                raise AssertionError(f"mixed {layer} field {k} off by "
                                     f"{errs[k]}")
        if layer == "GCN":
            check_spmm(graph.to("cuda"), "gcn", "float32", gen)
        else:
            check_gat(graph.to("cuda"), "float32", gen)


def reference_phase(tmp, case, info):
    """Phase 19 (see the module docstring)."""
    import torch
    from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
    from gnn_bfs_rans_tpu_torch.compat.torch_ref import RefFlowGNN
    from gnn_bfs_rans_tpu_torch.foam import FoamCase, box_fields
    from gnn_bfs_rans_tpu_torch.graph.build import build_graph
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.train.normalization import FieldNormalizer

    gen = torch.Generator().manual_seed(19)
    # the reference reads the mesh's own cell order
    g = build_graph(FoamCase(case).load_mesh(), reorder="none")
    n, ne = g.n_nodes, g.n_edges
    ref_in = (g.node_feat[:n].cuda(),
              torch.stack([g.senders[:ne], g.receivers[:ne]]).long().cuda(),
              g.edge_feat[:ne].cuda())
    norm = FieldNormalizer().fit(box_fields(info["cell_centers"]))
    graphs, table = {}, {}
    for i, (label, layer, edge_dim) in enumerate(REF_MODELS):
        # PyTorch's own initialization, seeded
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(19 + i)
            ref = RefFlowGNN(hidden_dim=HIDDEN, num_layers=REF_LAYERS,
                             layer_type=layer, dropout=DROPOUT,
                             edge_dim=edge_dim, heads=HEADS).cuda()
        with torch.random.fork_rng(devices=[0]), torch.no_grad():
            torch.cuda.manual_seed(19)
            ref.train()
            for _ in range(3):          # warm the BatchNorm statistics
                ref(*ref_in)
        ref.eval()
        with torch.no_grad():
            ref_out = ref(*ref_in).cpu().numpy()
            ref_host = host_time_ms(lambda: ref(*ref_in))
        pt = tmp / f"{label}.pt"
        torch.save({"epoch": 100, "model_state_dict": ref.state_dict(),
                    "optimizer_state_dict": {}, "val_loss": 0.123,
                    "config": {"hidden_dim": HIDDEN,
                               "num_layers": REF_LAYERS, "layer_type": layer,
                               "dropout": DROPOUT, "lr": 3e-4},
                    "normalizer": {"field_stats": norm.field_stats,
                                   "scalers": norm.scalers}}, pt)
        log(f"{label}: RefFlowGNN eval forward on the card, host clock "
            f"median {ref_host[1]:.4f} ms (quartiles {ref_host[0]:.4f}, "
            f"{ref_host[2]:.4f})")
        if layer not in graphs:
            graphs[layer] = load_graph(case, layer)
        table[label] = serve_reference(pt, graphs[layer], ref_out, label,
                                       CONV_KERNEL[layer], norm)
        if layer == "GAT":
            # exact_bn: the batch statistics of the case, as the reference
            # model normalizes in train mode with dropout off
            _no_dropout_(ref.train())
            with torch.no_grad():
                ref_bn = ref(*ref_in).cpu().numpy()
            serve_reference(pt, graphs[layer], ref_bn, label,
                            CONV_KERNEL[layer], norm, exact_bn=True)
    log(json.dumps({"reference_checkpoints_max_rel_gap": table}))
    export_round_trip(tmp, case, ref_in, gen)
    mixed_prism(tmp, gen)
    for argv in (["check-data", "--case_path", str(case), "--time_dirs",
                  "100"], ["check-coordinates", "--case_path", str(case)]):
        if cli_main(argv) != 0:
            raise AssertionError(f"{argv[0]} returned non-zero")


# ------------------------------------------------------------ phase 20
# scale-out (parallel/, models/partitioned.py, train/streaming.py,
# utils/dp_bench.py): the flagship GAT 4×256 bf16, the Transformer 4×256
# bf16 for remat.  Sliced bands: a 96 × 64 grid (6,144 cells, RCM-free
# bandwidth 96) in 4 shards of 1,536 rows, halo 128; shards 0, 1 and 3
# (both boundary kinds and an inner one)
SHARD_GRID = (96, 64)
SHARDS, SHARD_HALO = 4, 128
# the owned rows of a conv on a shard vs the same conv on the whole graph
# (the same window rows; f32 summation order, and in bf16 one rounding of
# an output that may flip): × max |full|
SHARD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# remat: GAT 4×256 bf16 unfused and the Transformer 4×256 bf16, dropout
# 0.1, on the box and on a grid of ≥ 250,000 cells (96 × 2,605)
REMAT_GRID = (96, 2605)
STREAM_CASES = 8


def _owned(d, n_loc):
    return slice(d * n_loc, (d + 1) * n_loc)


def _conv_forms():
    """(label, the conv's constructor, its call, dtype, the plain-version
    kernel it is held against, needs a backward)."""
    from gnn_bfs_rans_tpu_torch.models.convs import (GATConv, GCNConv,
                                                     TransformerConv)

    bf16 = "bfloat16"
    return [
        ("row 1 GAT eval", lambda: GATConv(HIDDEN, heads=HEADS,
                                           backend="pallas",
                                           dtype=None),
         lambda c, x, g, s: c(x, g), bf16, False),
        ("rows 4+5+6 GAT train (unfused)",
         lambda: GATConv(HIDDEN, heads=HEADS, dropout=DROPOUT,
                         fuse_train=False, backend="pallas", dtype=None),
         lambda c, x, g, s: c(x, g, train=True, seed=s), bf16, True),
        ("row 8 GCN", lambda: GCNConv(HIDDEN, backend="pallas", dtype=None),
         lambda c, x, g, s: c(x, g), "float32", True),
        ("row 9 Transformer geo mean",
         lambda: TransformerConv(HIDDEN, heads=HEADS, edge_dim=4,
                                 backend="pallas", dtype=None),
         lambda c, x, g, s: c(x, g), bf16, False),
    ]


def sliced_band_checks(gen):
    """Rows 1, 4 + 5 + 6, 8 and 9 on the shards' slices of the band: each
    against its plain version on the shard (its owned rows; at dropout 0.1
    where the form has dropout: the same seed, the same masks), and the
    owned rows
    against the same conv on the whole graph (dropout 0: the masks are
    keyed by tile, which differs between a shard and the whole graph); in
    the backward forms dx on the owned rows and the weight gradients,
    with the cotangent on the shard's owned rows only."""
    import torch
    from gnn_bfs_rans_tpu_torch.parallel.partition import (
        _local_graph, build_partition, shard_partition)
    from gnn_bfs_rans_tpu_torch.utils.synthetic import build_grid_graph

    dev = torch.device("cuda")
    grid = build_grid_graph(*SHARD_GRID, with_band=True,
                            band_components=("gcn", "bias_self",
                                             "bias_noself", "geo"))
    pg = build_partition(grid, SHARDS, SHARD_HALO)
    if not pg.has_band:
        raise AssertionError("the grid's partition carries no band slices")
    full = grid.to(dev)
    n_loc, halo, n_pad = pg.n_loc, SHARD_HALO, grid.n_pad
    log(f"sliced bands: {SHARD_GRID[0]}x{SHARD_GRID[1]} grid, n_pad {n_pad}, "
        f"{SHARDS} shards of {n_loc} rows + 2 x {halo} halo, band tile "
        f"{pg.band_tile}, W {grid.band.gcn.shape[1]}, Wcols "
        f"{grid.band.bias_self.shape[-1]}")
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    for label, make, call, dt_name, bwd in _conv_forms():
        dt = getattr(torch, dt_name)
        conv = make()
        conv.reset_parameters(gen)
        conv = conv.to(dev)
        x_full = torch.randn(n_pad, HIDDEN, generator=gen).to(dev, dt)
        g_full = torch.randn(n_pad, HIDDEN, generator=gen).to(dev, dt)
        for d in (0, 1, SHARDS - 1):
            local = _local_graph(shard_partition(pg, d, dev))
            lo = d * n_loc - halo
            src = torch.arange(lo, lo + n_loc + 2 * halo, device=dev)
            inside = (src >= 0) & (src < n_pad)
            x = torch.where(inside[:, None],
                            x_full[src.clamp(0, n_pad - 1)], 0).to(dt)
            g = torch.zeros_like(x)
            g[halo:halo + n_loc] = g_full[_owned(d, n_loc)]
            g_mask = torch.zeros_like(g_full)
            g_mask[_owned(d, n_loc)] = g_full[_owned(d, n_loc)]

            def run(graph, xin, cot, s, plain):
                xin = xin.clone().requires_grad_(bwd)
                for p in conv.parameters():
                    p.grad = None
                with plain_versions() if plain else contextlib.nullcontext():
                    out = call(conv, xin, graph, s)
                    if bwd:
                        out.backward(cot)
                grads = ([xin.grad] + [p.grad.clone()
                                       for p in conv.parameters()]
                         if bwd else [])
                return out.detach(), grads

            rate_seed = seed if "train" in label else None
            got, g_got = run(local, x, g, rate_seed, False)
            ref, g_ref = run(local, x, g, rate_seed, True)
            torch.cuda.synchronize()
            # the forward on the owned rows: a halo row's window reaches
            # senders beyond the shard's rows, which the kernels drop and
            # the plain versions window as zero rows (its output is
            # replaced by the exchange, its cotangent is zero)
            own = slice(halo, halo + n_loc)
            err, scale = _rel_err(got[own], ref[own])
            halo_gap = _rel_err(got, ref)[0] / scale
            tol = GAT_TOL[dt_name] if dt_name == "bfloat16" else SPMM_TOL[
                dt_name]
            bwd_err = max((_rel_err(a, b)[0] / max(_rel_err(a, b)[1], 1e-30)
                           for a, b in zip(g_got, g_ref)), default=0.0)
            # the whole graph, dropout 0
            sh, g_sh = run(local, x, g, None, False)
            wh, g_wh = run(full, x_full, g_mask, None, False)
            f_err, f_scale = _rel_err(sh[own], wh[_owned(d, n_loc)])
            fb_err = 0.0
            if bwd:
                pairs = [(g_sh[0][own], g_wh[0][_owned(d, n_loc)])] + list(
                    zip(g_sh[1:], g_wh[1:]))
                fb_err = max(_rel_err(a, b)[0] / max(_rel_err(a, b)[1],
                                                     1e-30)
                             for a, b in pairs)
            log(f"{label} {dt_name} shard {d}: kernel vs plain on the "
                f"owned rows {err / scale:.3e} (tol {tol}; all rows "
                f"{halo_gap:.3e}), backward "
                f"{bwd_err:.3e} (tol {BWD_TOL[dt_name]}); owned rows vs the "
                f"whole graph {f_err / f_scale:.3e}, backward {fb_err:.3e} "
                f"(tol {SHARD_TOL[dt_name]})")
            if not (torch.isfinite(got).all() and err <= tol * scale
                    and bwd_err <= BWD_TOL[dt_name]
                    and f_err <= SHARD_TOL[dt_name] * f_scale
                    and fb_err <= max(SHARD_TOL[dt_name],
                                      BWD_TOL[dt_name])):
                raise AssertionError(f"{label} on shard {d}: kernel "
                                     f"{err}/{bwd_err}, whole graph "
                                     f"{f_err}/{fb_err}")


def _flagship(dt="bfloat16", layer_type="GAT", **kw):
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig

    return ModelConfig(**{**dict(hidden_dim=HIDDEN, num_layers=LAYERS,
                                 layer_type=layer_type, heads=HEADS,
                                 backend="pallas", dropout=0.0,
                                 compute_dtype=dt), **kw})


def _grads(model):
    return {k: p.grad.detach().float().clone()
            for k, p in model.named_parameters()}


def _step_gap(label, got, want, own=None, bf16=False):
    """A step's loss and gradients against a reference step's: f32 within
    the f32 step limits; bf16 (``own``: the reference's bf16 step and
    ``want`` its f32 step) no further from the f32 step than 1.5 × the
    reference bf16 step."""
    (l_g, g_g), (l_w, g_w) = got, want
    if not bf16:
        if abs(l_g - l_w) > STEP_LOSS_TOL["float32"] * abs(l_w):
            raise AssertionError(f"{label}: loss {l_g} vs {l_w}")
        g_max = max(v.abs().max().item() for v in g_w.values())
        worst = 0.0
        for k in g_w:
            err, scale = _rel_err(g_g[k], g_w[k])
            floor = g_max if _zero_grad(k) else 1e-3 * g_max
            worst = max(worst, err / max(scale, floor))
        log(f"{label} f32: loss {l_g:.7f} vs {l_w:.7f}, worst gradient gap "
            f"{worst:.3e} (limit {STEP_TOL_F32})")
        if worst > STEP_TOL_F32:
            raise AssertionError(f"{label}: gradient gap {worst}")
        return
    l_o, g_o = own
    if abs(l_g - l_o) > STEP_LOSS_TOL["bfloat16"] * abs(l_o):
        raise AssertionError(f"{label}: loss {l_g} vs {l_o}")
    g_norm = max(v.norm().item() for v in g_w.values())
    worst = 0.0
    for k in g_w:
        dist = (g_g[k] - g_w[k]).norm().item()
        ref = (g_o[k] - g_w[k]).norm().item()
        if _zero_grad(k):
            if dist > ZERO_GRAD_TOL * g_norm:
                raise AssertionError(f"{label} {k}: |g| {dist}")
            continue
        if dist > STEP_F32_RATIO * ref + 1e-4 * g_w[k].norm().item():
            raise AssertionError(f"{label} {k}: {dist} from the f32 step > "
                                 f"{STEP_F32_RATIO} x {ref}")
        worst = max(worst, dist / max(ref, 1e-30))
    log(f"{label} bf16: loss {l_g:.7f} vs {l_o:.7f}, largest ratio to the "
        f"reference bf16 step's distance from f32 {worst:.3f} (limit "
        f"{STEP_F32_RATIO})")


def partitioned_checks(case, smi):
    """The partitioned forward and train step at world 1 (NCCL) on the
    box, against ``FlowGNN``'s forward and the unfused ``train_step``; on
    more than one card the forward and step on ``torch.cuda.device_count()``
    spawned NCCL ranks against one rank's, on the sliced-band grid, whose
    shards are whole band tiles, so that the kernels meet the exchange."""
    import torch
    from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN
    from gnn_bfs_rans_tpu_torch.models.partitioned import PartitionedFlowGNN
    from gnn_bfs_rans_tpu_torch.parallel.distributed import launch, world_size
    from gnn_bfs_rans_tpu_torch.parallel.partition import (
        build_partition, gather_partitioned, make_partitioned_forward,
        make_partitioned_train_step, shard_partition,
        shard_partitioned_targets)
    from gnn_bfs_rans_tpu_torch.parallel.ranks import run_jobs
    from gnn_bfs_rans_tpu_torch.train.loop import (TrainConfig,
                                                   make_optimizer, train_step)
    from gnn_bfs_rans_tpu_torch.utils.synthetic import build_grid_graph

    dev = torch.device("cuda")
    graph = load_graph(case, "GAT")
    gd = graph.to(dev)
    world = world_size()
    pg = build_partition(graph, world, SHARD_HALO)
    shard = shard_partition(pg, 0, dev)
    targets = torch.randn(2, graph.n_pad, 7,
                          generator=torch.Generator().manual_seed(9))
    tcfg = TrainConfig(lr=1e-3)
    fwd = {}
    for dt in ("float32", "bfloat16"):
        model = FlowGNN(_flagship(dt), torch.Generator().manual_seed(1)).to(dev)
        model.eval()
        with torch.no_grad():
            whole = model(gd)[:graph.n_nodes].float()
        part = gather_partitioned(make_partitioned_forward(model, SHARD_HALO)(
            shard), shard)
        fwd[dt] = (torch.from_numpy(part).to(dev), whole)
    (p32, w32), (p16, w16) = fwd["float32"], fwd["bfloat16"]
    err, scale = _rel_err(p32, w32)
    own_dist = (w16 - w32).abs().max().item()
    dist = (p16 - w32).abs().max().item()
    log(f"partitioned forward GAT 4x256 at world {world} (NCCL): f32 vs "
        f"FlowGNN {err / scale:.3e} (tol 1e-5); bf16 from the f32 forward "
        f"{dist:.3e} vs FlowGNN bf16's {own_dist:.3e} (limit "
        f"{SERVE_F32_RATIO}x); {smi}")
    if not (err <= 1e-5 * scale and dist <= SERVE_F32_RATIO * own_dist):
        raise AssertionError("partitioned forward disagrees with FlowGNN")

    # both steps clip their gradients alike: the gradients compared are
    # those the optimizer applied
    def flow_step(dt):
        model = FlowGNN(_flagship(dt, fuse_epilogue=False, fuse_train=False),
                        torch.Generator().manual_seed(1)).to(dev)
        loss = train_step(model, make_optimizer(model, tcfg), gd,
                          targets.to(dev), 1e-3, tcfg)
        return loss.item(), _grads(model)

    def part_step(dt, pg=pg, shard=shard, targets=targets, cfg=tcfg):
        model = PartitionedFlowGNN(_flagship(dt),
                                   torch.Generator().manual_seed(1)).to(dev)
        step = make_partitioned_train_step(model, make_optimizer(model, cfg),
                                           cfg, SHARD_HALO)
        loss = step(shard, shard_partitioned_targets(targets.numpy(), pg, 0,
                                                     dev), 1e-3)
        return loss.item(), _grads(model)

    f32, f16 = flow_step("float32"), flow_step("bfloat16")
    _step_gap(f"partitioned step world {world}", part_step("float32"), f32)
    _step_gap(f"partitioned step world {world}", part_step("bfloat16"), f32,
              own=f16, bf16=True)

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"partitioned NCCL exchange: 1 card, world 1 (a multi-rank "
            f"exchange needs one card a rank); {smi}")
        return world
    # the grid's 48 band tiles split into whole tiles at 2, 3, 4, 6 or 8
    # ranks (the box's shards would not, and would take the dense route);
    # a clip that never fires, so that the gradients compared are the
    # SUM-reduced ones and a scale error shows
    grid = build_grid_graph(*SHARD_GRID, with_band=True,
                            band_components=LAYER_COMPONENTS["GAT"])
    g_targets = torch.randn(2, grid.n_pad, 7,
                            generator=torch.Generator().manual_seed(10))
    no_clip = TrainConfig(lr=1e-3, grad_clip=1e9)
    g_pg = build_partition(grid, 1, SHARD_HALO)
    g_shard = shard_partition(g_pg, 0, dev)
    model = FlowGNN(_flagship("float32"),
                    torch.Generator().manual_seed(1)).to(dev)
    one_fwd = torch.from_numpy(gather_partitioned(
        make_partitioned_forward(model, SHARD_HALO)(g_shard), g_shard))
    one_step = part_step("float32", g_pg, g_shard, g_targets, no_clip)
    sd = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    p = dict(config=_flagship("float32").to_dict(), state=sd, graph=grid,
             halo=SHARD_HALO, targets=g_targets.numpy(),
             train=no_clip.to_dict(), lr=1e-3)
    jobs = [("partitioned_forward", p), ("partitioned_step", p)]
    t = time.time()
    many = launch(run_jobs, n_cards, (jobs, "cuda"), device="cuda")[0]
    if not many[0]["has_band"]:
        raise AssertionError(f"the {n_cards}-rank partition of the grid has "
                             "no band slices")
    err, scale = _rel_err(torch.from_numpy(many[0]["out"]), one_fwd)
    log(f"partitioned forward and step on {n_cards} NCCL ranks "
        f"({SHARD_GRID[0]}x{SHARD_GRID[1]} grid, sliced bands) in "
        f"{time.time() - t:.1f} s: forward vs one rank {err / scale:.3e} "
        f"(tol 1e-5); {smi}")
    if not err <= 1e-5 * scale:
        raise AssertionError(f"{n_cards}-rank partitioned forward: {err}")
    _step_gap(f"partitioned step on {n_cards} NCCL ranks vs one rank",
              (many[1]["loss"], {k: torch.from_numpy(v).to(dev)
                                 for k, v in many[1]["grads"].items()}),
              one_step)
    return n_cards


def _times(step, label, smi, steps=10):
    """Host time (quartiles, synchronized), device time and idle share of
    ``step()`` (eager)."""
    q = host_time_ms(step, reps=steps, warmup=2)
    dev_us, idle = profile_forward(step, label, steps=3, with_idle=True,
                                   top=4)
    log(f"{label}: host ms {q[1]:.4f} ({q[0]:.4f}, {q[2]:.4f}), device "
        f"{(dev_us or 0) / 1e3:.4f} ms, idle {idle}; {smi}")


def dp_multicase_checks(case, train_case, smi):
    """The DP step (4 snapshots) against train_step on the same batch; the
    multi-case step on 4 perturbed box cases and its forward's case order;
    train_multicase_streamed for 2 epochs with Prefetcher(depth=2).  The
    steps are the graphed ones (phase 21 holds them against their eager
    forms)."""
    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.foam import FoamCase
    from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
    from gnn_bfs_rans_tpu_torch.graph.build import attach_band
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN
    from gnn_bfs_rans_tpu_torch.parallel import (
        make_dp_train_step, make_multicase_forward, make_multicase_train_step,
        make_perturbed_cases, shard_cases, shard_targets)
    from gnn_bfs_rans_tpu_torch.parallel.generalization import (
        analytic_targets, train_multicase_streamed)
    from gnn_bfs_rans_tpu_torch.train.data import load_dataset
    from gnn_bfs_rans_tpu_torch.train.loop import (TrainConfig,
                                                   make_optimizer, train_step)
    from gnn_bfs_rans_tpu_torch.train.streaming import perturbed_case_source

    dev = torch.device("cuda")
    ds = load_dataset(train_case, TRAIN_TIMES, with_band=True,
                      band_components=LAYER_COMPONENTS["GAT"])
    gd = ds.graph.to(dev)
    batch = ds.targets[np.arange(4) % ds.n_snapshots]
    tcfg = TrainConfig(lr=1e-3)
    runs = []
    for dp in (False, True):
        model = FlowGNN(_flagship(), torch.Generator().manual_seed(1)).to(dev)
        opt = make_optimizer(model, tcfg)
        if dp:
            tg, w = shard_targets(batch, device=dev)
            step = make_dp_train_step(model, opt, tcfg)
            loss = step(gd, tg, w, 1e-3)
            run = lambda: step(gd, tg, w, 1e-3)  # noqa: E731
        else:
            tg = torch.from_numpy(batch).to(dev)
            loss = train_step(model, opt, gd, tg, 1e-3, tcfg)
        runs.append((loss.item(), _grads(model)))
    (l_s, g_s), (l_d, g_d) = runs
    g_max = max(v.abs().max().item() for v in g_s.values())
    gap = max(_rel_err(g_d[k], g_s[k])[0] / max(g_s[k].abs().max().item(),
                                                g_max if _zero_grad(k)
                                                else 1e-3 * g_max)
              for k in g_s)
    log(f"DP step (world 1, 4 snapshots, GAT 4x256 bf16) vs train_step: "
        f"loss {l_d:.7f} vs {l_s:.7f}, worst gradient gap {gap:.3e}")
    if abs(l_d - l_s) > STEP_LOSS_TOL["bfloat16"] * abs(l_s) or gap > 1e-2:
        raise AssertionError(f"DP step: loss {l_d} vs {l_s}, gap {gap}")
    _times(run, "DP step GAT 4x256 bf16, 4 snapshots, world 1", smi)

    mesh = FoamCase(case).load_mesh()
    base, cases = make_perturbed_cases(mesh, 4, amplitude=0.05, seed=0)
    base = attach_band(base, LAYER_COMPONENTS["GAT"])
    bd = base.to(dev)
    tg = np.stack([analytic_targets(c, cases.node_feats[c])
                   for c in range(4)])
    cases = dataclasses.replace(cases, targets=tg)
    model = FlowGNN(_flagship(), torch.Generator().manual_seed(1)).to(dev)
    local = shard_cases(cases, device=dev)
    step = make_multicase_train_step(model, make_optimizer(model, tcfg), tcfg)
    losses = [step(bd, local, 1e-3).item() for _ in range(3)]
    _times(lambda: step(bd, local, 1e-3),
           "multi-case step GAT 4x256 bf16, 4 cases, world 1", smi)
    out = make_multicase_forward(model)(bd, local)
    model.eval()
    with torch.no_grad():
        each = torch.stack([model(dataclasses.replace(
            bd, node_feat=local.node_feats[c], edge_feat=local.edge_feats[c]))
            for c in range(4)])
    order_err, _ = _rel_err(out, each)
    log(f"multi-case: losses {losses}; forward vs per-case FlowGNN "
        f"forwards, case order: max gap {order_err:.3e}")
    if order_err != 0 or not np.isfinite(losses).all():
        raise AssertionError(f"multi-case forward order gap {order_err}")

    def source():
        return perturbed_case_source(base, STREAM_CASES, chunk=1,
                                     amplitude=0.05, seed=0,
                                     targets_for=analytic_targets)

    timings = []
    model = FlowGNN(_flagship(), torch.Generator().manual_seed(1)).to(dev)
    _, hist = train_multicase_streamed(model, tcfg, base, source, epochs=2,
                                       lr=1e-3, prefetch_depth=2,
                                       timings=timings)
    for h, t in zip(hist, timings):
        log(f"streamed epoch {h['epoch']}: loss {h['loss']:.6f}, "
            f"{h['seconds'] / t['chunks'] * 1e3:.3f} ms a chunk "
            f"({t['chunks']} chunks of 1 case); step {t['step_s'] * 1e3:.3f} "
            f"ms in all, consumer's wait on the prefetch queue "
            f"{t['prefetch_wait_s'] * 1e3:.3f} ms; {smi}")
    if not np.isfinite([h["loss"] for h in hist]).all():
        raise AssertionError(f"streamed training: {hist}")


def shard_benchmark(smi):
    """One 125,000-cell shard (+ 256 halo rows) of a 1M-cell grid in 8
    shards, GAT 4×256 bf16: its chained marginal forward, edge messages/s,
    and the eager forward's idle share."""
    import torch
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN
    from gnn_bfs_rans_tpu_torch.parallel.partition import (
        build_partition, make_partitioned_forward, shard_partition)
    from gnn_bfs_rans_tpu_torch.utils.synthetic import (
        build_grid_graph, run_partition_shard_benchmark)

    t = time.time()
    res = run_partition_shard_benchmark(global_nodes=1_000_000, n_shards=8,
                                        hidden_dim=256)
    log(f"run_partition_shard_benchmark in {time.time() - t:.1f} s: "
        f"{json.dumps(res)}")
    # the eager forward's device time and idle share on the same shard
    grid = build_grid_graph(96, res["shard_nodes"] // 96, with_band=True,
                            band_components=("bias_self",))
    shard = shard_partition(build_partition(grid, 1, SHARD_HALO), 0, "cuda")
    model = FlowGNN(_flagship(), torch.Generator().manual_seed(0)).cuda()
    fwd = make_partitioned_forward(model, SHARD_HALO)
    fwd(shard)                 # the graph's warm-up and capture, before
    fwd(shard)                 # the profiler starts
    dev_us, idle = profile_forward(lambda: fwd(shard), "shard forward",
                                   steps=5, with_idle=True, top=6)
    log(f"1M-cell shard (125,000 + 256 rows) GAT 4x256 bf16: span "
        f"{res['step_median_s'] * 1e3:.4f} ms (chained marginal), "
        f"{res['value']:.4e} edge msgs/s; replayed device "
        f"{(dev_us or 0) / 1e3:.4f} ms, idle {idle}; {smi}")


def remat_checks(case, train_case, smi):
    """One step with and without remat from the same state and generator
    (GAT 4×256 bf16 unfused; Transformer 4×256 bf16; dropout 0.1):
    parameters bit for bit; peak memory and step time on the box and on a
    grid of 250,080 cells; and the remat step replayed as the Trainer's
    CUDA graph against eager steps (phase 17's check), bit for bit."""
    import torch
    from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN
    from gnn_bfs_rans_tpu_torch.train.data import load_dataset
    from gnn_bfs_rans_tpu_torch.train.loop import (TrainConfig,
                                                   make_optimizer, train_step)
    from gnn_bfs_rans_tpu_torch.utils.synthetic import build_grid_graph

    for layer, kw in (("GAT", dict(fuse_train=False)), ("Transformer", {})):
        ds = load_dataset(train_case, list(TRAIN_TIMES), with_band=True,
                          band_components=LAYER_COMPONENTS[layer])
        tr = _graph_trainer(train_case.parent, ds, f"remat-{layer}", DROPOUT,
                            layer_type=layer, num_layers=LAYERS,
                            compute_dtype="bfloat16", remat=True, **kw)
        replays_vs_eager(tr, f"{layer.lower()}4x256-bf16-remat")

    dev = torch.device("cuda")
    tcfg = TrainConfig(lr=1e-3)
    t = time.time()
    big = build_grid_graph(*REMAT_GRID, with_band=True,
                           band_components=("bias_self", "bias_noself",
                                            "geo")).to(dev)
    log(f"remat grid {REMAT_GRID[0]}x{REMAT_GRID[1]} ({big.n_nodes} cells) "
        f"built in {time.time() - t:.1f} s")
    graphs = {"box": None, "grid": big}
    for layer, kw in (("GAT", dict(fuse_train=False)), ("Transformer", {})):
        graphs["box"] = load_graph(case, layer).to(dev)
        for where, g in graphs.items():
            targets = torch.randn(1, g.n_pad, 7, device=dev,
                                  generator=torch.Generator(dev).manual_seed(3))
            out = {}
            for remat in (False, True):
                cfg = _flagship(layer_type=layer, dropout=DROPOUT,
                                remat=remat, **kw)
                model = FlowGNN(cfg, torch.Generator().manual_seed(1)).to(dev)
                opt = make_optimizer(model, tcfg)
                gen = torch.Generator(device=dev).manual_seed(5)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base_mem = torch.cuda.memory_allocated()
                loss = train_step(model, opt, g, targets, 1e-3, tcfg, gen)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base_mem
                state = {k: v.clone() for k, v in model.state_dict().items()}
                gen_state = gen.get_state()
                q = host_time_ms(lambda: train_step(model, opt, g, targets,
                                                    1e-3, tcfg, gen),
                                 reps=5, warmup=1)
                out[remat] = (loss.item(), state, gen_state, peak, q[1])
            (l0, s0, r0, m0, t0), (l1, s1, r1, m1, t1) = out[False], out[True]
            gap = max((s0[k].float() - s1[k].float()).abs().max().item()
                      for k in s0)
            same = l0 == l1 and gap == 0 and torch.equal(r0, r1)
            log(f"remat {layer} 4x256 bf16 dropout {DROPOUT} on the {where} "
                f"({g.n_nodes} cells): bit-identical {same} (loss {l1:.7f} vs "
                f"{l0:.7f}, max parameter gap {gap:.3e}, generator state "
                f"equal {torch.equal(r0, r1)}); peak memory above the "
                f"model {m1 / 2**20:.1f} MiB vs {m0 / 2**20:.1f} MiB without "
                f"({m1 / max(m0, 1):.3f}x); step host ms {t1:.4f} vs "
                f"{t0:.4f} ({t1 / t0:.3f}x); {smi}")
            if not same:
                raise AssertionError(f"remat {layer} {where}: loss {l1} vs "
                                     f"{l0}, parameter gap {gap}")


def scaleout_phase(case, train_case, gen, smi):
    """Phase 20: the sliced-band kernels, the partitioned forward and step
    (NCCL), the DP, multi-case and streamed steps, ``bench --mode dp``,
    the 1M-cell shard, remat."""
    import torch
    from gnn_bfs_rans_tpu_torch.parallel.distributed import init_distributed

    t0 = time.time()
    sliced_band_checks(gen)
    log(f"phase 20 sliced bands: {time.time() - t0:.1f} s")
    info = init_distributed(world_size=1, device="cuda")
    log(f"phase 20 group: {info} (backend "
        f"{torch.distributed.get_backend()})")
    try:
        t = time.time()
        world = partitioned_checks(case, smi)
        log(f"phase 20 partitioned (world {world}): {time.time() - t:.1f} s")
        t = time.time()
        dp_multicase_checks(case, train_case, smi)
        log(f"phase 20 DP / multi-case / streamed: "
            f"{time.time() - t:.1f} s")
    finally:
        torch.distributed.destroy_process_group()
    t = time.time()
    shard_benchmark(smi)
    log(f"phase 20 shard benchmark: {time.time() - t:.1f} s")
    t = time.time()
    remat_checks(case, train_case, smi)
    log(f"phase 20 remat: {time.time() - t:.1f} s; phase 20 in all "
        f"{time.time() - t0:.1f} s")


# ------------------------------------------------------------ phase 21
# the last modules: FlowGNNSurrogate, train-multitopo, CUDA graphs of the
# scale-out steps over NCCL, the native face tokenizer.  Three boxes in two
# buckets at node_align 512 / edge_align 2048: 400 × 30 (12,000 cells) and
# 390 × 31 (12,090) share the (12,288, 49,152, 4) bucket, 200 × 30 (6,000)
# has its own
TOPO_BOXES = (("a", 400, 30), ("b", 390, 31), ("c", 200, 30))
TOPO_EPOCHS = 6
# the 100,000-cell mixed hex/prism case (triangles and quads in one faces
# file): 100 × 100 × 7, its odd layers split into prisms
PRISM = (100, 100, 7)


def _enqueue_ms(fn, calls=20):
    """Host milliseconds a call of ``fn`` takes to return (the card's work
    queued, not waited for), after a synchronize."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def _replay_vs_eager(label, replayed, eager, smi, steps=6):
    """Host-clock quartiles, device time and idle share of one call,
    eager and replayed, each ending in a synchronize; for the replays also
    the span of back-to-back replays (device) and the host time a replay
    takes to be queued."""
    out = {}
    for name, fn in (("eager", eager), ("replayed", replayed)):
        q = host_time_ms(fn, reps=steps, warmup=2)
        dev_us, idle = profile_forward(fn, f"{label} {name}", steps=3,
                                       with_idle=True, top=4)
        out[name] = (q, dev_us, idle)
    (qe, de, ie), (qr, dr, ir) = out["eager"], out["replayed"]
    span, queued = event_time_ms(replayed, 10), _enqueue_ms(replayed, 10)
    log(f"{label}: host ms eager {qe[1]:.4f} ({qe[0]:.4f}, {qe[2]:.4f}) -> "
        f"replayed {qr[1]:.4f} ({qr[0]:.4f}, {qr[2]:.4f}); device ms "
        f"{(de or 0) / 1e3:.4f} -> {(dr or 0) / 1e3:.4f}; idle (profiler) "
        f"{ie:.3f} -> {ir:.3f}; replays back to back: span {span:.4f} ms "
        f"each, queued in {queued:.4f} ms of host time; {smi}")


def surrogate_checks(case, smi):
    """FlowGNNSurrogate on the 400 × 30 box with a boundary embedding:
    GCN 6×256 f32 (row 8, 3 layers a stage) and GAT 4×256 bf16 under
    ``exact_bn`` (rows 1 and 2): the launches of an eager forward, the
    kernels against the plain versions (SERVE_TOL), the replayed forward
    equal to the eager one, and its span, host time and idle share."""
    import torch
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.kernels import _build
    from gnn_bfs_rans_tpu_torch.models import FlowGNNSurrogate
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig
    from gnn_bfs_rans_tpu_torch.train.graphs import Graphed

    dev = torch.device("cuda")
    for layer, layers, dt, exact in (("GCN", GCN_LAYERS, "float32", False),
                                     ("GAT", LAYERS, "bfloat16", True)):
        label = (f"surrogate {layer.lower()}{layers}x{HIDDEN}-{dt}"
                 f"{' exact_bn' if exact else ''}")
        graph = load_graph(case, layer).to(dev)
        cfg = ModelConfig(hidden_dim=HIDDEN, num_layers=layers,
                          layer_type=layer, heads=HEADS, backend="pallas",
                          compute_dtype=dt, dropout=0.0)
        model = FlowGNNSurrogate(cfg, torch.Generator().manual_seed(0))
        model = model.to(dev).eval()
        bc = 0.1 * torch.randn(graph.n_pad, HIDDEN, device=dev,
                               generator=torch.Generator(dev).manual_seed(1))

        def forward():
            return model(graph, bc, exact_bn=exact)

        want = {CONV_KERNEL[layer]: layers}
        if exact:
            want["fused_epilogue_fwd"] = 2 * layers
        _build.reset_launches()
        with torch.inference_mode():
            eager = forward()
            torch.cuda.synchronize()
            moved = {k: v for k, v in _build.LAUNCHES.items() if v}
            with plain_versions():
                plain = forward()
            fwd = Graphed(forward, dev)
            fwd()
            replayed = fwd().clone()
            rows = slice(0, graph.n_nodes)
            err, scale = _rel_err(eager[rows], plain[rows])
            log(f"{label}: launches {moved} (expected {want}); kernels vs "
                f"plain versions max abs {err:.3e} (tol "
                f"{SERVE_TOL * scale:.3e}); replay equal to eager "
                f"{torch.equal(replayed, eager)}")
            if (moved != want or err > SERVE_TOL * scale
                    or not torch.isfinite(eager).all()
                    or not torch.equal(replayed, eager)):
                raise AssertionError(f"{label}: outside the stated bounds")
            host_e, host_r = host_time_ms(forward), host_time_ms(fwd)
            span = event_time_ms(fwd)
        log(f"{label}: host ms eager {host_e[1]:.4f} ({host_e[0]:.4f}, "
            f"{host_e[2]:.4f}) -> replayed {host_r[1]:.4f} ({host_r[0]:.4f}, "
            f"{host_r[2]:.4f}); 20 replays span {span:.4f} ms each, idle "
            f"{1 - span / host_r[1]:.3f}; {smi}")


def _banded_cases(ds):
    """The dataset's cases with their GCN band (row 8 sums in a fixed
    order, the dense branch's backward with atomics: bit-for-bit
    comparisons need the band), built on the true counts."""
    from gnn_bfs_rans_tpu_torch.graph.build import attach_band

    out = []
    for c in ds.cases:
        true = dataclasses.replace(c.graph, n_nodes=c.n_nodes,
                                   n_edges=c.n_edges)
        g = attach_band(true, ("gcn",))
        out.append(dataclasses.replace(c, graph=dataclasses.replace(
            g, n_nodes=c.graph.n_nodes, n_edges=c.graph.n_edges)))
    return out


def multitopo_checks(tmp, smi):
    """``train-multitopo`` through the CLI on three boxes in two buckets
    (the JAX CLI's defaults: GCN 3×64, LayerNorm, ``dense``): its buckets,
    epoch times and losses, ``best`` served; then one step graph a bucket
    replayed case by case (the shared bucket's second case included)
    against eager steps bit for bit (on the cases' GCN bands, ``pallas``),
    and each bucket's replayed step against the eager one in time."""
    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
    from gnn_bfs_rans_tpu_torch.foam import generate_box_case
    from gnn_bfs_rans_tpu_torch.infer import Predictor
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig
    from gnn_bfs_rans_tpu_torch.train.graphs import signature
    from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig, train_step
    from gnn_bfs_rans_tpu_torch.train.multitopo import (
        MultiTopoDataset, MultiTopoTrainer, load_multitopo_dataset)

    paths = []
    for name, nx, ny in TOPO_BOXES:
        generate_box_case(tmp / f"topo_{name}", nx, ny, 1,
                          time_dirs=("282",))
        paths.append(str(tmp / f"topo_{name}"))
    out = tmp / "multitopo_out"
    buf = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["train-multitopo", "--case_paths", *paths,
                       "--output_dir", str(out), "--epochs",
                       str(TOPO_EPOCHS), "--device", "cuda"])
    wall = time.time() - t
    text = buf.getvalue()
    hist = json.loads((out / "training_history.json").read_text())
    epochs = [ln for ln in text.splitlines() if ln.startswith("Epoch ")]
    log(f"train-multitopo (3 boxes, GCN 3x64 dense, {TOPO_EPOCHS} epochs) "
        f"in {wall:.1f} s: " + "; ".join(
            ln for ln in text.splitlines() if "bucket" in ln)
        + "; epochs: " + " | ".join(ln.split(": ", 1)[1] for ln in epochs)
        + f"; {smi}")
    if (rc != 0 or "3 cases in 2 bucket(s)" not in text
            or not np.isfinite(hist["train_loss"]).all()
            or hist["train_loss"][-1] >= hist["train_loss"][0]):
        raise AssertionError(f"train-multitopo: rc {rc}, {hist}")
    dense = load_multitopo_dataset(paths, node_align=512, edge_align=2048)
    fields = Predictor.from_checkpoint(out, "best").predict_fields(
        dense.cases[2].graph)
    if not all(np.isfinite(v).all() for v in fields.values()):
        raise AssertionError("train-multitopo: best serves non-finite fields")

    ds = MultiTopoDataset(_banded_cases(dense), dense.normalizer)
    a, b, c = range(3)
    if (ds.cases[a].bucket != ds.cases[b].bucket or len(ds.buckets) != 2
            or signature(ds.cases[a].graph) != signature(ds.cases[b].graph)):
        raise AssertionError(f"multitopo buckets {ds.buckets}")
    cfg = ModelConfig(hidden_dim=64, num_layers=3, layer_type="GCN",
                      dropout=0.0, norm_type="layer", backend="pallas")
    tcfg = TrainConfig(lr=3e-3)
    trs = [MultiTopoTrainer(ds, cfg, tcfg, tmp / f"topo_{n}",
                            log_fn=lambda *_: None, device="cuda")
           for n in ("graphed", "eager")]
    graphed, eager = trs
    gaps = []
    for ci in (a, a, c, c, b, c, b):
        got = graphed._step(ds.cases[ci].bucket)(
            graphed.graphs[ci], graphed.targets[ci], 3e-3).item()
        want = train_step(eager.model, eager.optimizer, eager.graphs[ci],
                          eager.targets[ci], 3e-3, tcfg,
                          eager.generator).item()
        same = got == want and all(
            torch.equal(p, q) for p, q in zip(graphed.model.parameters(),
                                              eager.model.parameters()))
        gaps.append((ci, got, want, same))
    log(f"multitopo step graphs ({sum(k[0] == 'step' for k in graphed._graphs)}"
        f" for {len(ds.buckets)} buckets), case, replayed vs eager loss, "
        f"parameters equal: {gaps}")
    if not all(g[3] for g in gaps) or len(graphed._graphs) != 2:
        raise AssertionError("multitopo: replays differ from eager steps")

    # the CLI's model (dense): each bucket's replayed step against eager
    tr = MultiTopoTrainer(dense,
                          ModelConfig(hidden_dim=64, num_layers=3,
                                      layer_type="GCN", dropout=0.0,
                                      norm_type="layer", backend="dense"),
                          tcfg, tmp / "topo_dense", log_fn=lambda *_: None,
                          device="cuda")
    for ci in (a, c):
        bucket = tr.dataset.cases[ci].bucket
        step = tr._step(bucket)
        g, tg = tr.graphs[ci], tr.targets[ci]
        _replay_vs_eager(
            f"multitopo step GCN 3x64 dense, bucket {bucket}",
            lambda: step(g, tg, 3e-3),
            lambda: train_step(tr.model, tr.optimizer, g, tg, 3e-3, tcfg,
                               tr.generator), smi)


def graphed_scaleout_checks(case, train_case, smi):
    """In a NCCL group of one rank: the DP step (4 snapshots), the
    multi-case step (4 cases), the streamed multi-case loop (8 cases in
    chunks of 3, 3, 2: two graphs) and the partitioned step and forward,
    GAT 4×256 bf16 dropout 0.1 (the partitioned model unfused), each
    replayed against its eager form from one state and generator bit for
    bit, with host time, device time and idle share eager and replayed;
    then ``bench --mode dp --devices 1`` (chained replays)."""
    import numpy as np
    import torch
    from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
    from gnn_bfs_rans_tpu_torch.foam import FoamCase
    from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
    from gnn_bfs_rans_tpu_torch.graph.build import attach_band
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN
    from gnn_bfs_rans_tpu_torch.models.partitioned import PartitionedFlowGNN
    from gnn_bfs_rans_tpu_torch.parallel import (
        build_partition, make_dp_train_step, make_multicase_train_step,
        make_partitioned_forward, make_partitioned_train_step,
        make_perturbed_cases, shard_cases, shard_partition,
        shard_partitioned_targets, shard_targets)
    from gnn_bfs_rans_tpu_torch.parallel.generalization import (
        analytic_targets, train_multicase_streamed)
    from gnn_bfs_rans_tpu_torch.train.data import load_dataset
    from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig, make_optimizer
    from gnn_bfs_rans_tpu_torch.train.streaming import perturbed_case_source

    dev = torch.device("cuda")
    tcfg = TrainConfig(lr=1e-3)
    ds = load_dataset(train_case, TRAIN_TIMES, with_band=True,
                      band_components=LAYER_COMPONENTS["GAT"])
    gd = ds.graph.to(dev)
    snaps = ds.targets[np.arange(4) % ds.n_snapshots]
    mesh = FoamCase(case).load_mesh()
    base, cases = make_perturbed_cases(mesh, 4, amplitude=0.05, seed=0)
    base = attach_band(base, LAYER_COMPONENTS["GAT"])
    cases = dataclasses.replace(cases, targets=np.stack(
        [analytic_targets(c, cases.node_feats[c]) for c in range(4)]))
    bd = base.to(dev)
    graph = load_graph(case, "GAT")
    pg = build_partition(graph, 1, SHARD_HALO)
    ptargets = np.random.default_rng(9).normal(
        size=(2, graph.n_pad, 7)).astype(np.float32)

    def setup(kind):
        """(step, its arguments, the model) from seed 1."""
        if kind == "partitioned":
            model = PartitionedFlowGNN(_flagship(dropout=DROPOUT),
                                       torch.Generator().manual_seed(1))
            model = model.to(dev)
            step = make_partitioned_train_step(
                model, make_optimizer(model, tcfg), tcfg, SHARD_HALO)
            return step, (shard_partition(pg, 0, dev),
                          shard_partitioned_targets(ptargets, pg, 0, dev)), \
                model
        model = FlowGNN(_flagship(dropout=DROPOUT),
                        torch.Generator().manual_seed(1)).to(dev)
        opt = make_optimizer(model, tcfg)
        if kind == "dp":
            return make_dp_train_step(model, opt, tcfg), (
                gd, *shard_targets(snaps, device=dev)), model
        return make_multicase_train_step(model, opt, tcfg), (
            bd, shard_cases(cases, device=dev)), model

    labels = {"dp": "DP step GAT 4x256 bf16, 4 snapshots",
              "multicase": "multi-case step GAT 4x256 bf16, 4 cases",
              "partitioned": "partitioned step GAT 4x256 bf16 unfused"}
    for kind, label in labels.items():
        runs = []
        for graphed in (True, False):
            step, args, model = setup(kind)
            if not step.capture:
                raise AssertionError(f"{label}: not captured in a NCCL "
                                     "group")
            fn = step if graphed else step.eager
            gen = torch.Generator(dev).manual_seed(5)
            losses = [fn(*args, 1e-3, gen).item() for _ in range(4)]
            runs.append((losses, [p.detach().clone()
                                  for p in model.parameters()]))
            if graphed:
                replayed = functools.partial(step, *args, 1e-3, gen)
            else:
                eager = functools.partial(step.eager, *args, 1e-3, gen)
        (lg, pg_), (le, pe) = runs
        same = lg == le and all(torch.equal(x, y) for x, y in zip(pg_, pe))
        log(f"{label} (world 1, NCCL): 4 calls graphed (warm-up, capture, "
            f"2 replays) vs eager: losses {lg} vs {le}, parameters equal "
            f"{same}")
        if not same:
            raise AssertionError(f"{label}: replays differ from eager steps")
        _replay_vs_eager(f"{label} (world 1, NCCL)", replayed, eager, smi)

    model = PartitionedFlowGNN(_flagship(), torch.Generator().manual_seed(1))
    fwd = make_partitioned_forward(model.to(dev), SHARD_HALO)
    shard = shard_partition(pg, 0, dev)
    outs = [fwd(shard) for _ in range(3)]
    want = fwd.eager(shard)
    log(f"partitioned forward GAT 4x256 bf16 (world 1, NCCL): replays equal "
        f"to eager {[torch.equal(o, want) for o in outs]}")
    if not all(torch.equal(o, want) for o in outs):
        raise AssertionError("partitioned forward: replays differ")
    _replay_vs_eager("partitioned forward GAT 4x256 bf16 (world 1, NCCL)",
                     lambda: fwd(shard), lambda: fwd.eager(shard), smi)

    def source():
        return perturbed_case_source(base, STREAM_CASES, chunk=3,
                                     amplitude=0.05, seed=0,
                                     targets_for=analytic_targets)

    cfg = _flagship(dropout=DROPOUT)
    timings = []
    model = FlowGNN(cfg, torch.Generator().manual_seed(1)).to(dev)
    _, hist = train_multicase_streamed(model, tcfg, base, source, epochs=2,
                                       lr=1e-3, prefetch_depth=2,
                                       timings=timings)
    twin = FlowGNN(cfg, torch.Generator().manual_seed(1)).to(dev)
    step = make_multicase_train_step(twin, make_optimizer(twin, tcfg), tcfg)
    gen = torch.Generator(dev).manual_seed(tcfg.seed)
    eager_losses = [[step.eager(bd, shard_cases(batch, device=dev), 1e-3,
                                gen).item() for batch in source()]
                    for _ in range(2)]
    same = all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 twin.parameters()))
    same &= [h["loss"] for h in hist] == [float(np.mean(v))
                                          for v in eager_losses]
    for h, t in zip(hist, timings):
        log(f"streamed (graphed) epoch {h['epoch']}: loss {h['loss']:.6f}, "
            f"{h['seconds'] / t['chunks'] * 1e3:.3f} ms a chunk "
            f"({t['chunks']} chunks of 3, 3, 2 cases); step "
            f"{t['step_s'] * 1e3:.3f} ms in all, consumer's wait on the "
            f"prefetch queue {t['prefetch_wait_s'] * 1e3:.3f} ms; {smi}")
    log(f"streamed 2 epochs, 8 cases in chunks of 3 (the short last "
        f"chunk on a graph of its own): replays equal to eager steps on the "
        f"same chunks {same}")
    if not same:
        raise AssertionError("streamed multi-case: replays differ from "
                             "eager steps")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["bench", "--mode", "dp", "--devices", "1",
                       "--case_path", str(train_case), "--compute_dtype",
                       "bfloat16", "--device", "cuda"])
    line = buf.getvalue().strip().splitlines()[-1]
    res = json.loads(line)
    log(f"bench --mode dp --devices 1 ({res['note']}): {line}; {smi}")
    if (rc != 0 or res["value"] != 1.0 or res["step_s_1dev"] <= 0
            or res["timing"] != "chained_replay"):
        raise AssertionError(f"bench --mode dp: {line}")


def native_checks(tmp, smi):
    """The native and numpy walks of the faces file of the 100,000-cell
    mixed hex/prism case: equal outputs, their host times, and
    ``load_mesh``'s (native) host time."""
    import numpy as np
    from gnn_bfs_rans_tpu_torch import native
    from gnn_bfs_rans_tpu_torch.foam import FoamCase, tokenizer
    from gnn_bfs_rans_tpu_torch.foam.casegen import generate_mixed_prism_case

    path = tmp / "prism100k"
    t = time.time()
    generate_mixed_prism_case(path, *PRISM)
    made = time.time() - t
    if not native.available():
        raise AssertionError("the native tokenizer did not build")
    body = tokenizer.strip_header(
        (path / "constant" / "polyMesh" / "faces").read_text())
    times = {}
    for name, fn in (("native", tokenizer.parse_face_list_fast),
                     ("numpy", tokenizer.parse_face_list)):
        best = float("inf")
        for _ in range(2):
            t = time.perf_counter()
            got = fn(body)
            best = min(best, time.perf_counter() - t)
        times[name] = (best * 1e3, got)
    (tn, (on, pn)), (tw, (ow, pw)) = times["native"], times["numpy"]
    same = np.array_equal(on, ow) and np.array_equal(pn, pw)
    t = time.perf_counter()
    mesh = FoamCase(path).load_mesh()
    load_ms = (time.perf_counter() - t) * 1e3
    log(f"faces of the {mesh.n_cells}-cell mixed prism case ({len(on) - 1} "
        f"faces, sizes {sorted(set(np.diff(on).tolist()))}; made in "
        f"{made:.1f} s): native walk {tn:.1f} ms, numpy walk {tw:.1f} ms "
        f"(best of 2, host), equal {same}; load_mesh {load_ms:.1f} ms; "
        f"{smi}")
    if not same or mesh.n_cells != 100_000:
        raise AssertionError("native tokenizer: walks differ")


def last_modules_phase(case, train_case, smi):
    """Phase 21: the surrogate, train-multitopo, the graphed scale-out
    steps over NCCL, the native tokenizer."""
    import torch
    from gnn_bfs_rans_tpu_torch.parallel.distributed import init_distributed

    t0 = time.time()
    surrogate_checks(case, smi)
    log(f"phase 21 surrogate: {time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        multitopo_checks(Path(tmp), smi)
        log(f"phase 21 multitopo: {time.time() - t:.1f} s")
        t = time.time()
        native_checks(Path(tmp), smi)
        log(f"phase 21 native: {time.time() - t:.1f} s")
    init_distributed(world_size=1, device="cuda")
    try:
        t = time.time()
        graphed_scaleout_checks(case, train_case, smi)
        log(f"phase 21 graphed scale-out: {time.time() - t:.1f} s")
    finally:
        torch.distributed.destroy_process_group()
    log(f"phase 21 in all {time.time() - t0:.1f} s")


# MeshGraphNets' blocks (phase 22): each output and cotangent of the kernels
# is held, by its relative RMS gap to the same block computed in f32 on the
# same bf16 inputs, to MGN_TOL_RATIO times the plain bf16 version's own gap
# (the kernels round at the same points; their f32 sums run in another
# order, and the edge block rounds the node sums of dh0 once to bf16 before
# the node products), and at least MGN_TOL_FLOOR; the same block with every
# product's operands in 8-bit floats (e4m3 forward, e5m2 backward) must
# fail that limit (all but dβ, which no product enters).  As in
# tests/test_torch_cuda.py::test_mgn_kernels_match_plain.
MGN_TOL_RATIO = 3.0
MGN_TOL_FLOOR = 2e-3
MGN_C = 128
# the benchmark's grid: 96 × 2,605 cells, 994,918 directed edges
MGN_GRID = (96, 2605)


def _mgn_fake8(x, dtype, top):
    scale = top / x.detach().abs().amax().float().clamp_min(1e-30)
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


def _mgn_e4m3(block):
    """The plain block with every product's operands in 8-bit floats."""
    import torch
    import torch.nn.functional as F

    class Fake8(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return _mgn_fake8(x, torch.float8_e4m3fn, 448.0)

        @staticmethod
        def backward(ctx, g):
            return _mgn_fake8(g, torch.float8_e5m2, 57344.0)

    def mlp_ln(x, w0, b0, w1, b1, w2, b2, gamma, beta):
        def lin(x, w, b):
            return Fake8.apply(x.float()) @ Fake8.apply(w.float()).t() + b

        h1 = torch.relu(lin(torch.relu(lin(x, w0, b0)), w1, b1))
        return F.layer_norm(lin(h1, w2, b2), (MGN_C,), gamma, beta, 1e-5)

    def edge(v, e, s, r, *w):
        ep = mlp_ln(torch.cat([v.index_select(0, s), v.index_select(0, r),
                               e], dim=1), *w)
        agg = torch.zeros((v.shape[0], MGN_C), device=e.device).index_add(
            0, r.long(), ep)
        return e.float() + ep, agg

    def node(v, agg, *w):
        return v.float() + mlp_ln(torch.cat([v, agg], dim=1), *w)

    return edge if block == "edge" else node


def _mgn_outputs(fn, args, w, leaves, cot):
    import torch

    out = fn(*args, *w)
    out = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(out, leaves, cot)
    return [o.detach() for o in out] + list(grads)


def _mgn_gap(got, want):
    want = want.double()
    return float((got.double() - want).norm() / want.norm())


def check_mgn(graph, block, gen):
    """One MeshGraphNets block (``kernels/mgn.py``: the edge block over the
    grid's receiver-sorted edges, or the node block over its rows) at latent
    128 in bf16: launches counted by kernel, every output and cotangent
    against the plain version, forward and backward timed; the row of the
    kernel table."""
    import torch
    from gnn_bfs_rans_tpu_torch.kernels import _build
    from gnn_bfs_rans_tpu_torch.kernels.mgn import (
        edge_block_bwd, edge_block_fwd, mgn_edge, mgn_edge_plain, mgn_node,
        mgn_node_plain, node_block_bwd, node_block_fwd, sender_order)

    dev = torch.device("cuda")
    c, ne, n = MGN_C, graph.n_edges, graph.n_pad

    def u(*shape, scale=1.0):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * scale).to(dev)

    def latent(rows):
        return torch.randn((rows, c), generator=gen).to(
            dev, torch.bfloat16).requires_grad_(True)

    k0 = 3 * c if block == "edge" else 2 * c
    w = [u(c, k0, scale=k0 ** -0.5), u(c, scale=k0 ** -0.5),
         u(c, c, scale=c ** -0.5), u(c, scale=c ** -0.5),
         u(c, c, scale=c ** -0.5), u(c, scale=c ** -0.5),
         1 + 0.1 * u(c), 0.1 * u(c)]
    for t in w:
        t.requires_grad_(True)
    v = latent(n)
    wn = ["dW0", "db0", "dW1", "db1", "dW2", "db2", "dgamma", "dbeta"]
    if block == "edge":
        e = latent(ne)
        s, r = graph.senders[:ne].to(dev), graph.receivers[:ne].to(dev)
        order = sender_order(s, n)
        args = (v, e, s, r)
        leaves = [v, e, *w]
        cot = (torch.randn((ne, c), generator=gen).to(dev, torch.bfloat16),
               torch.randn((n, c), generator=gen).to(dev, torch.bfloat16))
        names = ["e_new", "agg", "dv", "de", *wn]
        kernel, plain = (lambda *a: mgn_edge(*a, s_order=order),
                         mgn_edge_plain)
        rows = ne
    else:
        agg = latent(n)
        args = (v, agg)
        leaves = [v, agg, *w]
        cot = (torch.randn((n, c), generator=gen).to(dev, torch.bfloat16),)
        names = ["v_new", "dv", "dagg", *wn]
        kernel, plain = mgn_node, mgn_node_plain
        rows = n

    _build.reset_launches()
    got = _mgn_outputs(kernel, args, w, leaves, cot)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = ({"mgn_edge_fwd": 1, "mgn_edge_fixup": 2, "mgn_edge_bwd": 1,
             "mgn_edge_senders": 1} if block == "edge"
            else {"mgn_node_fwd": 1, "mgn_node_bwd": 1})
    if launches != want:
        raise AssertionError(f"mgn_{block} launches {launches}, expected "
                             f"{want}")
    ref = _mgn_outputs(plain, args, w, leaves, cot)
    n_lat = len(leaves) - len(w)
    d = [t.detach().double().requires_grad_(True) for t in leaves]
    exact = _mgn_outputs(plain, list(d[:n_lat]) + list(args[n_lat:]),
                         d[n_lat:], d, [x.double() for x in cot])
    low = _mgn_outputs(_mgn_e4m3(block), args, w, leaves, cot)
    worst = 0.0
    for name, k, p_, x, q in zip(names, got, ref, exact, low):
        if k.dtype != p_.dtype or k.shape != p_.shape:
            raise AssertionError(f"mgn_{block} {name}: {k.dtype} "
                                 f"{tuple(k.shape)} against the plain "
                                 f"{p_.dtype} {tuple(p_.shape)}")
        tol = max(MGN_TOL_RATIO * _mgn_gap(p_, x), MGN_TOL_FLOOR)
        gk, gq = _mgn_gap(k, x), _mgn_gap(q, x)
        log(f"mgn_{block} {name}: kernel {gk:.3e} plain {_mgn_gap(p_, x):.3e}"
            f" e4m3 {gq:.3e} limit {tol:.3e}")
        if not gk <= tol:
            raise AssertionError(f"mgn_{block} {name}: gap {gk:.3e} > "
                                 f"{tol:.3e}")
        if name != "dbeta" and not gq > tol:
            raise AssertionError(f"mgn_{block} {name}: the e4m3 version's "
                                 f"gap {gq:.3e} is within {tol:.3e}")
        worst = max(worst, gk / tol)
    del got, ref, exact, low, d

    # times: the training forward (it saves for the backward) and the
    # backward's launches, each ten calls in a CUDA graph
    wd = [t.detach() for t in w]
    xs = [t.detach() for t in args]
    if block == "edge":
        _, _, saved = edge_block_fwd(*xs, *wd, save=True)

        def fwd():
            edge_block_fwd(*xs, *wd, save=True)

        def bwd():
            edge_block_bwd(cot[0], cot[1], xs[3], *order, saved, wd[0],
                           wd[2], wd[4], wd[6])
    else:
        _, saved = node_block_fwd(*xs, *wd, save=True)

        def fwd():
            node_block_fwd(*xs, *wd, save=True)

        def bwd():
            node_block_bwd(cot[0], saved, wd[0], wd[2], wd[4], wd[6])
    fwd_ms = graph_time_ms(fwd, calls=5, replays=4)
    bwd_ms = graph_time_ms(bwd, calls=5, replays=4)
    eager_ms = cuda_time_ms(fwd, iters=10)

    def plain_fwd():
        with torch.no_grad():
            plain(*xs, *wd)

    def plain_step():
        _mgn_outputs(plain, args, w, leaves, cot)

    plain_ms = cuda_time_ms(plain_fwd, iters=5, warmup=1)
    plain_step_ms = cuda_time_ms(plain_step, iters=3, warmup=1)
    # the least bytes and operations: each input read once, each output
    # written once (bf16 latents, f32 sums and statistics, 4-byte indices)
    lat, lat_n = 2 * rows * c, 2 * n * c
    weights = 2 * c * (k0 + 2 * c) + 4 * 8 * c
    kept = 3 * lat + 8 * rows
    ln = 8 * c * rows
    if block == "edge":
        f_bytes = lat_n + lat + 8 * rows + weights + lat + lat_n + kept
        b_bytes = (lat + lat_n + kept + 4 * rows + 4 * lat + 4 * n * c
                   + lat + 4 * rows + 4 * n * c)
    else:
        f_bytes = 2 * lat + weights + lat + kept
        b_bytes = lat + kept + 5 * lat
    f_flops = 2 * rows * c * (k0 + 2 * c) + ln
    b_flops = 2 * rows * c * c * (3 if block == "edge" else 4) + 2 * ln
    fb, fby = bound(f_bytes, f_flops, H100_BF16_FLOPS)
    bb, bby = bound(b_bytes, b_flops, H100_BF16_FLOPS)
    log(f"mgn_{block} rows {rows}: launches {launches}; forward ms "
        f"{fwd_ms:.4f} (eager {eager_ms:.4f}) bound_ms {fb:.5f} ({fby}); "
        f"backward ms {bwd_ms:.4f} bound_ms {bb:.5f} ({bby}); plain forward "
        f"ms {plain_ms:.4f}, forward + backward {plain_step_ms:.4f}; worst "
        f"gap {worst:.3f} of its limit")
    return dict(max_rel_gap_of_limit=worst, ms=fwd_ms, bwd_ms=bwd_ms,
                plain_ms=plain_ms, plain_step_ms=plain_step_ms,
                bound_ms=fb, bound_by=fby, bwd_bound_ms=bb, bwd_bound_by=bby,
                library_ms=None)


def mgn_phase(case):
    """Phase 22: MeshGraphNets' edge and node kernels at the grid's size,
    then one train step of the 15 × 128 bf16 model on ``case`` (its launch
    counts: the ``launches`` of the kernel table).  Returns the table's
    rows."""
    import torch
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.kernels import _build
    from gnn_bfs_rans_tpu_torch.models import ModelConfig, build_model
    from gnn_bfs_rans_tpu_torch.utils.synthetic import build_grid_graph

    gen = torch.Generator().manual_seed(22)
    grid = build_grid_graph(*MGN_GRID, with_band=False)
    measured = {block: check_mgn(grid, block, gen)
                for block in ("edge", "node")}
    del grid
    torch.cuda.empty_cache()
    cfg = ModelConfig(layer_type="MeshGraphNets", num_layers=15,
                      hidden_dim=MGN_C, dropout=0.0, use_batch_norm=False,
                      backend="pallas", compute_dtype="bfloat16")
    model = build_model(cfg).to("cuda")
    graph = load_graph(case, "MeshGraphNets").to("cuda")
    _build.reset_launches()
    model(graph, train=True).square().mean().backward()
    torch.cuda.synchronize()
    step = dict(_build.LAUNCHES)
    want = {"mgn_edge_fwd": 15, "mgn_edge_fixup": 30, "mgn_edge_bwd": 15,
            "mgn_edge_senders": 15, "mgn_node_fwd": 15, "mgn_node_bwd": 15}
    if step != want:
        raise AssertionError(f"MeshGraphNets train step launches {step}, "
                             f"expected {want}")
    log(f"MeshGraphNets 15x128 bf16 train step on {graph.n_nodes} cells: "
        f"launches {step}")
    src = "gnn_bfs_rans_tpu_torch/csrc/mgn_edge.cu"
    return [dict(name=f"mgn_{block}", route="cuda", source=src,
                 replaces="not a TPU function (MeshGraphNets' "
                          f"{block} block)",
                 launches={k: v for k, v in step.items()
                           if k.startswith(f"mgn_{block}")},
                 **measured[block])
            for block in ("edge", "node")]


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
    global H100_BF16_FLOPS, H100_BYTES_PER_S
    from gnn_bfs_rans_tpu_torch.utils import roofline
    peak = roofline.device_peak("cuda")
    if peak.flops is None:
        raise AssertionError(f"utils/roofline.py has no peaks for {peak.kind}")
    H100_BF16_FLOPS, H100_BYTES_PER_S = peak.flops, peak.hbm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gnn_bfs_rans_tpu_torch.foam import (FoamCase, drifting_box_fields,
                                             generate_box_case)
    from gnn_bfs_rans_tpu_torch.graph.build import build_graph
    from gnn_bfs_rans_tpu_torch.infer import load_graph
    from gnn_bfs_rans_tpu_torch.kernels import _build
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig

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

    if sys.argv[1:] == ["--phase", "22"]:
        # phase 22 alone: its rows of the kernel table, no result line
        with tempfile.TemporaryDirectory() as tmp:
            case = Path(tmp) / "case"
            generate_box_case(case, 400, 30, 1)
            mgn_rows = mgn_phase(case)
        print(smi)
        print(json.dumps({"kernels": mgn_rows}))
        log("phase 22 alone: passed")
        return 0

    if sys.argv[1:] in (["--phase", "20"], ["--phase", "21"]):
        # phase 20 or 21 alone (a quicker call while working on it): no
        # kernel table and no result line
        with tempfile.TemporaryDirectory() as tmp:
            case, train_case = Path(tmp) / "case", Path(tmp) / "train_case"
            generate_box_case(case, 400, 30, 1)
            generate_box_case(train_case, 400, 30, 1, time_dirs=TRAIN_TIMES,
                              time_field_fn=drifting_box_fields)
            if sys.argv[2] == "20":
                scaleout_phase(case, train_case,
                               torch.Generator().manual_seed(0), smi)
            else:
                last_modules_phase(case, train_case, smi)
        log(f"phase {sys.argv[2]} alone: passed")
        return 0

    gen = torch.Generator().manual_seed(0)
    rows = {}
    graphs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for nx, ny in ((163, 75), (400, 30)):
            generate_box_case(tmp / f"box{nx}", nx, ny, 1)
            graphs[nx] = graph = load_graph(tmp / f"box{nx}").to("cuda")
            for dt in ("float32", "bfloat16"):
                rows[("gat", nx, dt)] = check_gat(graph, dt, gen)
        n_pad, n_valid = graph.n_pad, graph.n_nodes
        for mode in ("float32", "mixed", "bfloat16"):
            rows[("epi", mode)] = check_epilogue(mode, n_pad, n_valid, gen)
        t1 = time.time()
        case = tmp / "case"
        info = generate_box_case(case, 400, 30, 1)
        serve_launches = {}
        gat_cfg = ModelConfig(hidden_dim=HIDDEN, num_layers=LAYERS,
                              layer_type="GAT", heads=HEADS, backend="pallas",
                              compute_dtype="bfloat16")
        serve_launches["gat"] = serve(tmp, case, info, gat_cfg,
                                      f"gat{LAYERS}x{HIDDEN}-bf16", gen)
        log(f"serving phase: {time.time() - t1:.1f} s, launches "
            f"{serve_launches}")

        t1 = time.time()
        for nx in (163, 400):
            for dt in ("float32", "bfloat16"):
                rows[("gat_train", nx, dt)] = check_gat_train(graphs[nx], dt,
                                                              gen)
                for rate in (0.0, DROPOUT):
                    measured = check_gat_bwd(
                        graphs[nx], dt, rate, gen,
                        measure=nx == 400 and rate == DROPOUT)
                    if measured and dt == "bfloat16":
                        rows["row5"], rows["row6"] = measured
        for mode in ("float32", "mixed", "bfloat16"):
            rows[("epi_train", mode)], rows[("row3", mode)] = \
                check_epilogue_bwd(mode, n_pad, n_valid, gen)
        check_row3_branches(gen)
        for dt in ("float32", "bfloat16", "mixed"):
            compare_train_step(graphs[400], dt)
        # the f32 step's gap at dropout 0 through every kernel, and through
        # row 6 alone (the plain versions for the rest): what row 6 adds
        compare_train_step(graphs[400], "float32", "gat4x256-dropout0",
                           dropout=0.0)
        compare_train_step(graphs[400], "float32", "gat4x256-dropout0-row6",
                           keep=("fold_project_bwd",), dropout=0.0)
        # row 6 at the main path's three shapes, f32 and bf16, ragged N
        row6 = check_row6_shapes(graphs[400].n_pad, gen)
        log(json.dumps({"row6_shapes": {f"{k[0]} {k[1]}": v
                                        for k, v in row6.items()}}))
        log(f"training kernel phases: {time.time() - t1:.1f} s")

        # row 8 on the GCN and GIN planes: the 400×30 box (W 3) and a box
        # whose RCM bandwidth lies in (128, 256] (W 5)
        t1 = time.time()
        spmm_graphs = {}
        for nx, ny, window in ((400, 30, 3), (200, 150, 5)):
            path = case if nx == 400 else tmp / f"box{nx}x{ny}"
            if nx != 400:
                generate_box_case(path, nx, ny, 1)
            g = build_graph(FoamCase(path).load_mesh(), with_band=True,
                          band_components=("adj", "gcn", "bias_self"))
            if g.band is None or g.band.gcn.shape[1] != window:
                raise AssertionError(f"box {nx}x{ny}: expected a W {window} "
                                     "band")
            spmm_graphs[nx] = g = g.to("cuda")
            for plane in ("gcn", "adj"):
                for dt in ("float32", "bfloat16"):
                    rows[("spmm", nx, plane, dt)] = check_spmm(
                        g, plane, dt, gen, measure=nx == 400)
        # row 4 on both GAT bands
        for nx in (163, 400):
            for dt in ("float32", "bfloat16"):
                for rate in (0.0, DROPOUT):
                    rows[("gatm", nx, dt, rate)] = check_gat_mean(
                        graphs[nx], dt, rate, gen, measure=nx == 400)
        log(f"rows 8 and 4: {time.time() - t1:.1f} s")

        # GCN (the default config, f32, and bf16) and GIN serving, 6×256
        t1 = time.time()
        serve_launches["gcn"] = serve(tmp, case, info, ModelConfig(),
                                      "gcn6x256-f32", gen)
        serve(tmp, case, info, ModelConfig(compute_dtype="bfloat16"),
              "gcn6x256-bf16", gen)
        serve_launches["gin"] = serve(
            tmp, case, info,
            ModelConfig(layer_type="GIN", compute_dtype="bfloat16"),
            "gin6x256-bf16", gen)
        log(f"GCN / GIN serving: {time.time() - t1:.1f} s")

        # rows 9 and 11; the Transformer served through infer
        t1 = time.time()
        tr_rows, tr_launches, edge_bands = transformer_phase(tmp, case, info,
                                                             gen)
        rows.update(tr_rows)
        log(f"Transformer phases: {time.time() - t1:.1f} s, launches "
            f"{tr_launches}")

        # one train step, kernels vs plain versions
        t1 = time.time()
        full = spmm_graphs[400]
        for dt in ("float32", "bfloat16", "mixed"):
            compare_train_step(full, dt, "gcn6x256", layer_type="GCN",
                               num_layers=GCN_LAYERS)
        compare_train_step(full, "float32", "gin6x256", layer_type="GIN",
                           num_layers=GCN_LAYERS)
        compare_train_step(full, "bfloat16", "gat4x256-unfused",
                           fuse_train=False)
        log(f"GCN / GIN / unfused GAT train steps: {time.time() - t1:.1f} s")

        t1 = time.time()
        train_case = tmp / "train_case"
        train_info = generate_box_case(train_case, 400, 30, 1,
                                       time_dirs=TRAIN_TIMES,
                                       time_field_fn=drifting_box_fields)
        # rows 9 (dropout form), 10, 7, 6 (bias form); the Transformer
        # trained through the CLI and without edges through the Trainer
        trt_rows, launches_tr, launches_tr_noedge = transformer_train_phase(
            tmp, case, train_info, edge_bands, gen)
        rows.update(trt_rows)
        log(f"Transformer training phases: {time.time() - t1:.1f} s")

        t1 = time.time()
        launches = train(tmp, train_case, train_info)
        launches_gcn = train_default(tmp, train_case, train_info)
        launches_gatm = train_gat_unfused(tmp, train_case)
        log(f"training phases: {time.time() - t1:.1f} s")

        # the CUDA graphs: steps eager and replayed, train --epoch_block,
        # the replayed Predictor
        t1 = time.time()
        launches_blocked = graphs_phase(tmp, case, train_case, train_info)
        log(f"CUDA graph phase: {time.time() - t1:.1f} s, launches of the "
            f"blocked run {launches_blocked}")

        # rows 4 (concat) and 5 (per-head), the concat conv, the dense and
        # segment backends, a mesh without a band, dense and LayerNorm
        # training
        t1 = time.time()
        pr6_rows, launches_concat = pr6_phase(tmp, case, graphs, train_case,
                                              train_info, gen)
        rows.update(pr6_rows)
        log(f"phase 16: {time.time() - t1:.1f} s")

        # the bench harness: headline, train with trace, Transformer, GCN,
        # a million cells; the case's wall time by stage
        t1 = time.time()
        bench_phase(tmp, case)
        log(f"phase 18 (bench): {time.time() - t1:.1f} s")

        # the reference's own .pt checkpoints served through the kernels;
        # export-torch; the mixed hex/prism case; the host subcommands
        t1 = time.time()
        reference_phase(tmp, case, info)
        log(f"phase 19 (reference checkpoints): {time.time() - t1:.1f} s")

        # scale-out: sliced bands, the partitioned forward and step (NCCL),
        # DP, multi-case and streamed steps, remat
        t1 = time.time()
        scaleout_phase(case, train_case, gen, smi)
        log(f"phase 20 (scale-out): {time.time() - t1:.1f} s")

        # the surrogate, train-multitopo, the graphed scale-out steps over
        # NCCL and bench --mode dp, the native tokenizer
        t1 = time.time()
        last_modules_phase(case, train_case, smi)
        log(f"phase 21 (the last modules): {time.time() - t1:.1f} s")

        # MeshGraphNets' edge and node kernels at the grid's size
        t1 = time.time()
        mgn_rows = mgn_phase(case)
        log(f"phase 22 (MeshGraphNets): {time.time() - t1:.1f} s")

    # phase 23: the kernel table and the result line
    gat = {k: v for k, v in rows[("gat_train", 400, "bfloat16")].items()}
    kernels = [
        dict(name="banded_gat_mean_fused", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/banded_gat.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded.py:991",
             launches=launches.get("banded_gat_mean_fused", 0), **gat),
        dict(name="fused_epilogue_fwd", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/epilogue_fwd.cu",
             replaces="gnn_bfs_rans_tpu/kernels/epilogue.py:217",
             launches=launches.get("fused_epilogue_fwd", 0),
             **rows[("epi_train", "bfloat16")]),
        dict(name="fused_epilogue_bwd", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/epilogue_bwd.cu",
             replaces="gnn_bfs_rans_tpu/kernels/epilogue.py:260",
             launches=launches.get("fused_epilogue_bwd", 0),
             **rows[("row3", "bfloat16")]),
        dict(name="banded_gat_bwd", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/banded_gat_bwd.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded_bwd.py:682",
             launches=launches.get("banded_gat_bwd", 0), **rows["row5"]),
        dict(name="fold_project_bwd", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/fold_project_bwd.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded_bwd.py:202",
             launches=launches.get("fold_project_bwd", 0), **rows["row6"]),
        # the GCN training path (the CLI's default model, f32)
        dict(name="banded_spmm", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/banded_spmm.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded.py:217",
             launches=launches_gcn.get("banded_spmm", 0),
             **rows[("spmm", 400, "gcn", "float32")]),
        # the unfused GAT training path (bf16, dropout 0.1)
        dict(name="banded_gat_mean", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/banded_gat.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded.py:499",
             launches=launches_gatm.get("banded_gat_mean", 0),
             **rows[("gatm", 400, "bfloat16", DROPOUT)]),
        # the Transformer serving path (4x256 bf16, --bn_exact off): the
        # geo head-mean form it runs; library_ms is SDPA on the plain form
        dict(name="banded_transformer_fwd", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/banded_transformer.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded.py:759",
             launches=tr_launches["bf16"]["off"].get(
                 "banded_transformer_fwd", 0),
             **{**rows[("tr", 400, "geo", True, "bfloat16")],
                "library_ms": rows[("tr", 400, "plain", True, "bfloat16")][
                    "library_ms"]}),
        # the fuse_eval serving path (--bn_exact off)
        dict(name="banded_transformer_geo_mean_fused", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/banded_transformer.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded.py:1586",
             launches=tr_launches["bf16-fuse-eval"]["off"].get(
                 "banded_transformer_geo_mean_fused", 0),
             **rows[("trf", 400, "bfloat16")]),
        # the Transformer training path (4x256 bf16, dropout 0.1, geo)
        dict(name="banded_transformer_bwd", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/banded_transformer_bwd.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded_bwd.py:1354",
             launches=launches_tr.get("banded_transformer_bwd", 0),
             **rows["row10"]),
        dict(name="fold_partials", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/fold_partials.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded_bwd.py:86",
             launches=launches_tr.get("fold_partials", 0), **rows["row7"]),
        # not a TPU kernel: the XLA products of the JAX op's forward
        dict(name="transformer_project", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/banded_transformer.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded.py:1476 (XLA "
                      "products of banded_transformer_geo_mean_projgrad)",
             launches=launches_tr.get("transformer_project", 0),
             **rows[("project", "bfloat16")]),
        # the concat GAT conv's path (bf16, dropout 0.1): row 4's concat
        # form and row 5's per-head cotangent
        dict(name="banded_gat (concat)", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/banded_gat.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded.py:499",
             launches=launches_concat["bfloat16"].get("banded_gat", 0),
             **rows[("row4c", "bfloat16")]),
        dict(name="banded_gat_bwd (per-head)", route="cuda",
             source="gnn_bfs_rans_tpu_torch/csrc/banded_gat_bwd.cu",
             replaces="gnn_bfs_rans_tpu/kernels/banded_bwd.py:682",
             launches=launches_concat["bfloat16"].get("banded_gat_bwd", 0),
             **rows[("row5h", "bfloat16")]),
        # not TPU kernels: MeshGraphNets' blocks (launches by kernel, one
        # train step of the 15 x 128 model)
        *mgn_rows,
    ]
    for k in kernels:
        n_launched = (sum(k["launches"].values())
                      if isinstance(k["launches"], dict) else k["launches"])
        if n_launched <= 0:
            raise AssertionError(f"{k['name']} never launched on its "
                                 "main path")
    if launches_tr_noedge.get("fold_partials", 0) <= 0:
        raise AssertionError("fold_partials never launched on the no-edge "
                             "Transformer training path")
    for path, name in (("gat", "banded_gat_mean_fused"),
                       ("gat", "fused_epilogue_fwd"),
                       ("gcn", "banded_spmm"), ("gin", "banded_spmm")):
        if max(serve_launches[path][bn].get(name, 0)
               for bn in ("off", "on")) <= 0:
            raise AssertionError(f"{name} never launched on the {path} "
                                 "serving path")
    log(f"total: {time.time() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
