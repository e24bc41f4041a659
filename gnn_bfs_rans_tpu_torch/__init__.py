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
harness of ``utils/``); checkpoints in the reference's own ``.pt`` format
served (``Predictor.from_torch_checkpoint``) and written
(``export-torch``); the plotting and data-check subcommands; scale-out on
``torch.distributed`` (``parallel/``: data-parallel, multi-case and
node-partitioned training and serving, one rank a card; the streamed case
loader; ``train-multicase``, ``bench --mode dp``); every TPU kernel
function of the JAX package has its counterpart.
"""

__version__ = "0.1.0"
