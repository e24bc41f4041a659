"""gnn_bfs_rans_tpu_torch — PyTorch/CUDA port of gnn_bfs_rans_tpu.

A second package beside the JAX one, written in PyTorch for an NVIDIA
H100: every TPU kernel on a ported path becomes a kernel written by hand
for Hopper (CUDA C++ under ``csrc/``, or Triton), each with a plain
PyTorch version that the CPU runs.  The JAX package is the reference and
is never imported here.  Ported so far: FlowGNN with GCN, GAT and GIN
convolutions on the banded path, served (``infer``) and trained
(``train``; GAT with the fused or the unfused kernels).
"""

__version__ = "0.1.0"
