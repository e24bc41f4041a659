"""Operations, bytes and the card's peaks: the arithmetic of the
benchmark's MFU and roofline metrics.

* :data:`DEVICE_PEAKS` — a frozen copy of
  ``gnn_bfs_rans_tpu_torch/utils/roofline.py::DEVICE_PEAKS`` (NVIDIA's
  H100 data sheet, dense bf16 tensor-core FLOP/s and HBM bytes/s),
  matched as lower-case substrings of ``torch.cuda.get_device_name``;
  :data:`F32_FLOPS` the same sheet's float32 FLOP/s outside the tensor
  cores, the peak of a float32 configuration (TF32 off);
* :func:`model_flops` — the model's matmul FLOPs of a forward or a
  training step, as its architecture's module counts them
  (``reference/archs/``);
* :func:`step_ops` — the benchmark's own count of each operation of a
  forward or a training step, its FLOPs and the bytes it must move at the
  least (each input read once, each output written once, the adjacency as
  one 4-byte index a real edge, not the band's padded windows), so that a
  kernel roofline reads the same work whatever kernel implements it; the
  architecture's module counts them.
"""

from __future__ import annotations

from ..reference import archs

DEVICE_PEAKS: dict[str, tuple[float, float]] = {
    # H100 PCIe: bf16 dense 756 TFLOP/s, HBM2e 2.0 TB/s
    "h100 pcie": (756e12, 2.0e12),
    # H100 SXM: bf16 dense 989 TFLOP/s, HBM3 3.35 TB/s
    # ("NVIDIA H100 80GB HBM3")
    "h100": (989e12, 3.35e12),
}
F32_FLOPS: dict[str, float] = {"h100 pcie": 51e12, "h100": 67e12}


def peaks(device_name: str, compute_dtype: str = "bfloat16"
          ) -> tuple[float, float] | None:
    """(FLOP/s in the configuration's compute dtype, bytes/s)."""
    kind = device_name.lower()
    for key, val in DEVICE_PEAKS.items():
        if key in kind:
            if compute_dtype == "float32":
                return F32_FLOPS[key], val[1]
            return val
    return None


def model_flops(cfg: dict, n_nodes: int, n_edges: int, train: bool) -> float:
    return archs.load(cfg).model_flops(cfg, n_nodes, n_edges, train)


def step_ops(cfg: dict, n_nodes: int, n_edges: int, train: bool
             ) -> list[tuple[str, float, float]]:
    """``(operation, FLOPs, bytes)`` of one eval step (``train`` False: the
    forward and its loss) or one training step (forward, loss,
    backward, clip, Adam).  ``n_edges``: the real directed edges,
    self-loops not included."""
    return archs.load(cfg).step_ops(cfg, n_nodes, n_edges, train)


def least_seconds(ops: list[tuple[str, float, float]], flops_peak: float,
                  bytes_peak: float) -> float:
    """Σ over the operations of max(FLOPs / peak, bytes / bandwidth)."""
    return sum(max(fl / flops_peak, by / bytes_peak) for _, fl, by in ops)
