"""gnn_bfs_rans_tpu_torch — PyTorch/CUDA port of gnn_bfs_rans_tpu.

A second package beside the JAX one, written in PyTorch for an NVIDIA
H100: every TPU kernel on a ported path becomes a kernel written by hand
for Hopper in CUDA C++ (``csrc/``, built by ``nvcc`` for ``sm_90a`` and
loaded with ``ctypes``; the port needs no Triton), each with a plain
PyTorch version that the CPU runs.  The JAX package is the reference and
is never imported here.  Ported so far: FlowGNN with GCN, GAT, GIN and
Transformer convolutions on the ``pallas`` (banded kernels), ``dense`` and
``segment`` backends, BatchNorm (fused or unfused) or LayerNorm, served
(``infer``, meshes with or without a band), trained (``train``) and
benchmarked (``bench``, ``python -m gnn_bfs_rans_tpu_torch.bench``: the
harness of ``utils/``); every TPU kernel function of the JAX package has
its counterpart.
"""

__version__ = "0.1.0"
