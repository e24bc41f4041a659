"""Analytic FLOP/byte accounting, MFU, and roofline sanity guards.

Counterpart of ``gnn_bfs_rans_tpu/utils/roofline.py``, with the card's
peaks in place of the TPU generations'.  Each measured configuration
reports

* ``matmul_flops`` — *algorithmic* (ideal) multiply-accumulate work,
  counted analytically from N/E/H/heads/layers (the "model FLOPs"
  convention: the banded kernels' padded-window overcompute is not
  counted, so MFU measures useful work per second);
* ``mfu`` — matmul_flops / time / the card's bf16 tensor-core peak;
* ``bound`` — which roofline wall (tensor cores, labelled ``mxu`` as in
  the JAX package, or HBM) is closer to the measured time.

``check_roofline`` raises when a measured time is *below*
``matmul_flops / peak``: physically impossible, so the timing harness is
under-resolved.  The FLOP and byte formulas are the JAX module's, name for
name, and return its values exactly.  The JAX module's
``xla_bytes_accessed`` (XLA's compiled-graph cost analysis) has no
counterpart: torch has no such analysis, so ``bytes_basis`` is always
``"estimate"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# Public per-card peaks: (dense bf16 tensor-core FLOP/s, HBM bytes/s).
# Keys are matched as lowercase substrings of torch.cuda.get_device_name(),
# the most specific first (DEVICE_PEAKS' order).
DEVICE_PEAKS: dict[str, tuple[float, float]] = {
    # NVIDIA H100 Tensor Core GPU data sheet, H100 PCIe column: bf16 dense
    # 756 TFLOP/s (1,513 with sparsity), 2.0 TB/s HBM2e
    "h100 pcie": (756e12, 2.0e12),
    # the same data sheet, H100 SXM column: bf16 dense 989 TFLOP/s (1,979
    # with sparsity), 3.35 TB/s HBM3; reported as "NVIDIA H100 80GB HBM3"
    "h100": (989e12, 3.35e12),
}


@dataclasses.dataclass(frozen=True)
class DevicePeak:
    kind: str
    flops: float | None   # bf16 tensor-core peak, FLOP/s (None: unknown/CPU)
    hbm: float | None     # HBM bandwidth, bytes/s


def device_peak(device=None) -> DevicePeak:
    """Look up the peak specs of ``device``: a torch device or its string
    (``"cuda"``, ``"cuda:1"``, ``"cpu"``; None: the card when there is
    one, else the CPU); any other string is taken as a card's name as
    ``torch.cuda.get_device_name`` reports it.  The kind is that name in
    lower case, or ``"cpu"``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        kind = device.lower()
    elif torch.device(device).type == "cuda":
        kind = torch.cuda.get_device_name(device).lower()
    else:
        kind = torch.device(device).type
    for key, (flops, hbm) in DEVICE_PEAKS.items():
        if key in kind:
            return DevicePeak(kind, flops, hbm)
    return DevicePeak(kind, None, None)  # CPU / unknown: no guard possible


def _mm(m: int, k: int, n: int) -> float:
    """FLOPs of an [m,k]@[k,n] matmul (multiply+add counted separately)."""
    return 2.0 * m * k * n


def forward_matmul_flops(
    layer_type: str,
    num_layers: int,
    hidden_dim: int,
    n_nodes: int,
    n_edges: int,
    heads: int = 4,
    input_dim: int = 3,
    output_dim: int = 7,
    edge_dim: int = 4,
    use_edge_attr: bool = True,
) -> float:
    """Algorithmic matmul FLOPs of one FlowGNN forward pass.

    Counts only O(N·H²)/O(E·H) multiply-accumulate work (tensor-core
    shaped); softmax/LeakyReLU/BN elementwise passes are excluded — the
    "model FLOPs" convention, so MFU compares across backends.  Formulas
    follow models/flow_gnn.py + models/convs.py:

    * input projection  Linear(input_dim→H)
    * per layer, by conv type (heads=Hd, features=C=H):
        GCN:  proj N·H·H; aggregation (E+N self-loop) edge MACs of width H
        GAT:  proj N·H·(Hd·C); α matmul N·(Hd·C)·(2·Hd);
              weighted value aggregation over (E + N self-loops) per head
        GIN:  aggregation E·H; 2-layer MLP N·(H·H + H·H)
        Transformer: q/k/v projections 3·N·H·(Hd·C); skip N·H·C;
              qw N·(Hd·C)·(Hd·De); edge keys/values E·De·(Hd·C) when
              edge-conditioned; qk dots E·Hd·C; value agg E·Hd·C;
              edge-term collapse N·(Hd·De)·C
    * output MLP H→H→H→H/2→output_dim (flow_gnn.py out_0..out_3)
    """
    n, e, h, hd = float(n_nodes), float(n_edges), float(hidden_dim), float(heads)
    c = h  # per-head feature width equals hidden_dim in every conv here
    total = _mm(n, input_dim, h)

    if layer_type == "GCN":
        per_layer = _mm(n, h, h) + 2.0 * (e + n) * h
    elif layer_type == "GAT":
        per_layer = (
            _mm(n, h, hd * c)
            + _mm(n, hd * c, 2 * hd)
            + 2.0 * (e + n) * hd * c      # attention-weighted aggregation
        )
    elif layer_type == "GIN":
        per_layer = 2.0 * e * h + _mm(n, h, h) + _mm(n, h, h)
    elif layer_type == "Transformer":
        per_layer = (
            3.0 * _mm(n, h, hd * c)       # q, k, v
            + _mm(n, h, c)                # root/skip weight (concat=False)
            + 2.0 * e * hd * c            # q·k logits
            + 2.0 * e * hd * c            # attention-weighted value agg
        )
        if use_edge_attr:
            per_layer += (
                _mm(n, hd * c, hd * edge_dim)   # qw block matmul
                + 2.0 * e * edge_dim * hd * c   # k/v edge conditioning
                + _mm(n, hd * edge_dim, c)      # edge-term head-mean collapse
            )
    else:
        raise ValueError(f"unknown layer_type {layer_type!r}")

    total += num_layers * per_layer
    total += (
        _mm(n, h, h) + _mm(n, h, h) + _mm(n, h, h / 2)
        + _mm(n, h / 2, output_dim)
    )
    return total


def train_matmul_flops(*args: Any, **kwargs: Any) -> float:
    """Matmul FLOPs of one training step ≈ 3× forward (the backward of each
    matmul is two matmuls of the same shape: grad-input, grad-weight)."""
    return 3.0 * forward_matmul_flops(*args, **kwargs)


def hbm_bytes_estimate(
    layer_type: str,
    num_layers: int,
    hidden_dim: int,
    n_nodes: int,
    param_count: int,
    bytes_per_el: int = 2,
    graph_bytes: int = 0,
    mode: str = "forward",
) -> float:
    """Coarse HBM traffic estimate for one step (documentation-grade).

    Per layer the activation stream reads/writes x [N,H] a handful of times
    (≈ 6 passes); parameters and static graph/band arrays are read once.
    Backward roughly doubles activation traffic and adds a parameter
    write.  This feeds the ``bound`` classification only — not a guard.
    """
    act = 6.0 * n_nodes * hidden_dim * bytes_per_el * num_layers
    par = 4.0 * param_count
    tot = act + par + graph_bytes
    if mode == "train":
        tot = 2.0 * tot + 4.0 * param_count
    return tot


def graph_static_bytes(graph) -> int:
    """Bytes of the graph's tensors and of its ``Band``'s planes.

    The ``Band.transposed`` cache (transposed planes made at first use by
    a backward) is left out: the JAX graph has no counterpart, and with it
    out the count equals the JAX package's on the same case."""
    total = 0
    for f in dataclasses.fields(graph):
        v = getattr(graph, f.name)
        if isinstance(v, torch.Tensor):
            total += v.nbytes
    band = graph.band
    if band is not None:
        for f in dataclasses.fields(band):
            v = getattr(band, f.name)
            if isinstance(v, torch.Tensor):
                total += v.nbytes
    return total


def analyze(
    *,
    layer_type: str,
    num_layers: int,
    hidden_dim: int,
    n_nodes: int,
    n_edges: int,
    time_s: float,
    mode: str = "forward",
    heads: int = 4,
    param_count: int = 0,
    graph_bytes: int = 0,
    use_edge_attr: bool = True,
    device=None,
) -> dict:
    """Full roofline report for one measured config; JSON-able.

    ``mfu`` is against the bf16 tensor-core peak whatever the compute
    dtype (the JAX package's convention), so an f32 run reads low."""
    kw = dict(
        layer_type=layer_type, num_layers=num_layers, hidden_dim=hidden_dim,
        n_nodes=n_nodes, n_edges=n_edges, heads=heads,
        use_edge_attr=use_edge_attr,
    )
    flops = (train_matmul_flops(**kw) if mode == "train"
             else forward_matmul_flops(**kw))
    bytes_est = hbm_bytes_estimate(
        layer_type, num_layers, hidden_dim, n_nodes, param_count,
        graph_bytes=graph_bytes, mode=mode,
    )
    peak = device_peak(device)
    out = {
        "matmul_flops": flops,
        "hbm_bytes_est": bytes_est,
        "flops_per_sec": flops / time_s,
        "device_kind": peak.kind,
        "bytes_basis": "estimate",
    }
    if peak.flops:
        t_mxu = flops / peak.flops
        t_hbm = bytes_est / peak.hbm
        out["mfu"] = flops / time_s / peak.flops
        out["hbm_frac"] = bytes_est / time_s / peak.hbm
        out["hbm_frac_est"] = out["hbm_frac"]
        # a frac > 1 means the byte model overcounts (the measured time is
        # below the model's bandwidth floor)
        out["byte_model_infeasible"] = bool(out["hbm_frac"] > 1.05)
        out["roofline_min_s"] = max(t_mxu, t_hbm)
        out["bound"] = "mxu" if t_mxu >= t_hbm else "hbm"
        if out["mfu"] > 0.6 and out["hbm_frac"] > 0.6:
            out["bound"] = "mixed"
        elif out["mfu"] < 0.25 and out["hbm_frac"] < 0.25:
            # neither wall explains the time → elementwise passes / overhead
            out["bound"] = "vpu/glue"
    else:
        out["mfu"] = None
        out["bound"] = "unknown"
    return out


def check_roofline(matmul_flops: float, time_s: float, device=None,
                   slack: float = 1.05) -> None:
    """Raise if a measurement implies more than the card's peak FLOP/s.

    ``slack`` absorbs peak-spec rounding.  No-op on the CPU and unknown
    cards."""
    peak = device_peak(device)
    if peak.flops is None:
        return
    rate = matmul_flops / max(time_s, 1e-12)
    if rate > peak.flops * slack:
        raise RuntimeError(
            f"roofline violation: measured {rate/1e12:.1f} TFLOP/s exceeds "
            f"{peak.kind} peak {peak.flops/1e12:.0f} TFLOP/s — the timing "
            f"harness is under-resolved; time={time_s*1e6:.1f} µs for "
            f"{matmul_flops/1e9:.2f} GFLOP"
        )
