"""Operations, bytes and the card's peaks: the arithmetic of the
benchmark's MFU and roofline metrics.

* :data:`DEVICE_PEAKS` and :func:`peaks` — a frozen copy of
  ``gnn_bfs_rans_tpu_torch/utils/roofline.py::DEVICE_PEAKS`` (NVIDIA's
  H100 data sheet, dense bf16 tensor-core FLOP/s and HBM bytes/s),
  matched as lower-case substrings of ``torch.cuda.get_device_name``;
* :func:`forward_matmul_flops` / :func:`train_matmul_flops` — frozen
  copies of the same module's model-FLOP formulas (matmul work only, the
  banded kernels' padded windows not counted; a training step is three
  forwards);
* :func:`step_ops` — the benchmark's own count of each operation of a
  forward or a training step, its FLOPs and the bytes it must move at the
  least (each input read once, each output written once, the adjacency as
  one 4-byte index a real edge, not the band's padded windows), so that a
  kernel roofline reads the same work whatever kernel implements it.
"""

from __future__ import annotations

DEVICE_PEAKS: dict[str, tuple[float, float]] = {
    # H100 PCIe: bf16 dense 756 TFLOP/s, HBM2e 2.0 TB/s
    "h100 pcie": (756e12, 2.0e12),
    # H100 SXM: bf16 dense 989 TFLOP/s, HBM3 3.35 TB/s
    # ("NVIDIA H100 80GB HBM3")
    "h100": (989e12, 3.35e12),
}


def peaks(device_name: str) -> tuple[float, float] | None:
    kind = device_name.lower()
    for key, val in DEVICE_PEAKS.items():
        if key in kind:
            return val
    return None


def _mm(m: float, k: float, n: float) -> float:
    return 2.0 * m * k * n


def forward_matmul_flops(layer_type: str, num_layers: int, hidden_dim: int,
                         n_nodes: int, n_edges: int, heads: int = 4,
                         input_dim: int = 3, output_dim: int = 7,
                         edge_dim: int = 4, use_edge_attr: bool = True
                         ) -> float:
    """Model matmul FLOPs of one FlowGNN forward."""
    n, e, h, hd = float(n_nodes), float(n_edges), float(hidden_dim), \
        float(heads)
    c = h
    total = _mm(n, input_dim, h)
    if layer_type == "GCN":
        per_layer = _mm(n, h, h) + 2.0 * (e + n) * h
    elif layer_type == "GAT":
        per_layer = (_mm(n, h, hd * c) + _mm(n, hd * c, 2 * hd)
                     + 2.0 * (e + n) * hd * c)
    elif layer_type == "GIN":
        per_layer = 2.0 * e * h + _mm(n, h, h) + _mm(n, h, h)
    elif layer_type == "Transformer":
        per_layer = (3.0 * _mm(n, h, hd * c) + _mm(n, h, c)
                     + 2.0 * e * hd * c + 2.0 * e * hd * c)
        if use_edge_attr:
            per_layer += (_mm(n, hd * c, hd * edge_dim)
                          + 2.0 * e * edge_dim * hd * c
                          + _mm(n, hd * edge_dim, c))
    else:
        raise ValueError(f"unknown layer_type {layer_type!r}")
    total += num_layers * per_layer
    total += (_mm(n, h, h) + _mm(n, h, h) + _mm(n, h, h / 2)
              + _mm(n, h / 2, output_dim))
    return total


def train_matmul_flops(*args, **kwargs) -> float:
    return 3.0 * forward_matmul_flops(*args, **kwargs)


def model_flops(cfg: dict, n_nodes: int, n_edges: int, train: bool) -> float:
    kw = dict(layer_type=cfg["layer_type"], num_layers=cfg["num_layers"],
              hidden_dim=cfg["hidden_dim"], n_nodes=n_nodes, n_edges=n_edges,
              heads=cfg["heads"], input_dim=cfg["input_dim"],
              output_dim=cfg["output_dim"], edge_dim=cfg["edge_dim"],
              use_edge_attr=cfg["use_edge_attr"])
    return train_matmul_flops(**kw) if train else forward_matmul_flops(**kw)


def _dtype_bytes(cfg: dict) -> int:
    return 2 if cfg["compute_dtype"] in ("bfloat16", "mixed") else 4


def step_ops(cfg: dict, n_nodes: int, n_edges: int, train: bool
             ) -> list[tuple[str, float, float]]:
    """``(operation, FLOPs, bytes)`` of one eval step (``train`` False: the
    forward and its loss) or one training step (forward, loss,
    backward, clip, Adam).  ``n_edges``: the real directed edges,
    self-loops not included."""
    n, e = float(n_nodes), float(n_edges)
    h, hd, c = cfg["hidden_dim"], cfg["heads"], cfg["hidden_dim"]
    hc = hd * c
    b = _dtype_bytes(cfg)
    de = cfg["edge_dim"]
    idx = 4.0 * e                      # the adjacency: an index a real edge
    ops: list[tuple[str, float, float]] = []
    n_params = 0

    def dense(name, n_in, n_out, in_bytes=b, out_bytes=b, bias=True):
        nonlocal n_params
        n_params += n_in * n_out + (n_out if bias else 0)
        fl = _mm(n, n_in, n_out)
        by = n * n_in * in_bytes + n_in * n_out * b + n * n_out * out_bytes
        ops.append((name, fl, by))
        if train:
            # grad-input and grad-weight: read dY, X, W; write dX, dW
            ops.append((name + ".bwd", 2.0 * fl,
                        n * n_out * out_bytes + n * n_in * in_bytes
                        + n_in * n_out * b + n * n_in * in_bytes
                        + n_in * n_out * 4))

    dense("input_proj", cfg["input_dim"], h, in_bytes=4)
    for i in range(cfg["num_layers"]):
        if cfg["layer_type"] == "GAT":
            w_count = h * hc + 2 * hc + h
            fl = _mm(n, h, hc) + _mm(n, hc, 2 * hd) + 2.0 * (e + n) * hc
            graph_bytes = idx
        elif cfg["layer_type"] == "Transformer":
            w_count = 3 * (h * hc + hc) + de * hc + h * h + h
            fl = (3.0 * _mm(n, h, hc) + _mm(n, h, c) + 4.0 * e * hc
                  + _mm(n, hc, hd * de) + 2.0 * e * de * hc
                  + _mm(n, hd * de, c))
            # the edges' geometry: dist and 1/dist an edge, xyz a row
            graph_bytes = idx + 8.0 * e + 16.0 * n
        else:
            raise ValueError(cfg["layer_type"])
        n_params += w_count
        x_bytes = n * h * b
        # x, the weights, the adjacency in; the conv's output out
        ops.append((f"conv{i}", fl,
                    x_bytes + w_count * b + graph_bytes + x_bytes))
        if train:
            # dY, x, the weights, the adjacency in; dx and dW (f32) out
            ops.append((f"conv{i}.bwd", 2.0 * fl,
                        2 * x_bytes + w_count * b + graph_bytes + x_bytes
                        + w_count * 4))
        # residual add, BatchNorm, ReLU, dropout: x and x_new in, y out
        ops.append((f"norm{i}", 10.0 * n * h, 3.0 * n * h * b))
        n_params += 2 * h
        if train:
            ops.append((f"norm{i}.bwd", 12.0 * n * h, 3.0 * n * h * b))
    dense("out_0", h, h)
    dense("out_1", h, h)
    dense("out_2", h, h // 2)
    dense("out_3", h // 2, cfg["output_dim"], in_bytes=4, out_bytes=4)
    # the loss reads the prediction and the target
    ops.append(("loss", 4.0 * n * cfg["output_dim"],
                2.0 * n * cfg["output_dim"] * 4))
    if train:
        # global-norm clip reads the gradients; Adam reads p, g, m, v and
        # writes p, m, v (f32)
        ops.append(("clip", 2.0 * n_params, 4.0 * n_params))
        ops.append(("adam", 12.0 * n_params, 28.0 * n_params))
    return ops


def least_seconds(ops: list[tuple[str, float, float]], flops_peak: float,
                  bytes_peak: float) -> float:
    """Σ over the operations of max(FLOPs / peak, bytes / bandwidth)."""
    return sum(max(fl / flops_peak, by / bytes_peak) for _, fl, by in ops)
