"""Fused-projection banded GAT forward (eval form): CUDA kernel + plain version.

Counterpart of ``gnn_bfs_rans_tpu/kernels/banded.py::banded_gat_mean_fused``
(its forward ``banded_gat_mean_fused_fwd``, ``_gat_kernel`` with
``fuse_proj=True, mean_heads=True``), without dropout, softmax statistics
or the z residual: the serving path needs none of them.  The kernel is
``csrc/banded_gat.cu``; its header says what bounds it on the card and how
the design answers that.

Layouts are the JAX package's: ``bias_self`` int8 ``[n_tiles, T, Wcols]``,
``w`` ``[F, H·C]``, packed ``alphas`` f32 ``[N, 2H]`` (src | dst), ``x``
``[N, F]`` → ``[N, C]`` in x's dtype (float32 or bfloat16).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "banded_gat"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.banded_gat_mean_fused_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _windows(a: torch.Tensor, tile: int, width: int) -> torch.Tensor:
    """[N, F] → [n_tiles, Wcols, F]: receiver tile t's window covers rows
    ``[t·T − pad, t·T − pad + Wcols)``, ``pad = (Wcols − T)/2``, zero
    outside ``[0, N)`` (those columns are masked)."""
    pad = (width - tile) // 2
    ap = torch.nn.functional.pad(a, (0, 0, pad, pad))
    return ap.unfold(0, width, tile).transpose(1, 2)


def banded_gat_mean_fused_plain(
    bias_self: torch.Tensor,
    w: torch.Tensor,
    alphas: torch.Tensor,
    x: torch.Tensor,
    heads: int,
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points.

    Dense over the window like the TPU kernel: masked columns get the
    additive −1e30 bias and contribute exactly 0 after the exp.
    """
    n_tiles, tile, width = bias_self.shape
    n = x.shape[0]
    hc = w.shape[1]
    c = hc // heads
    dt = x.dtype
    # projection: f32 accumulate, rounded to the primal dtype
    z = (x.float() @ w.float()).to(dt)
    win_z = _windows(z, tile, width).reshape(n_tiles, width, heads, c)
    win_a = _windows(alphas[:, :heads], tile, width)          # [n, Wc, H]
    a_dst = alphas[:, heads:].reshape(n_tiles, tile, heads)
    logits = a_dst[:, :, None, :] + win_a[:, None, :, :]       # [n, T, Wc, H]
    logits = torch.where(logits >= 0, logits, negative_slope * logits)
    logits = logits + ((bias_self.float() - 1.0) * 1e30)[..., None]
    m = logits.amax(dim=2, keepdim=True)
    e = torch.exp(logits - m)
    inv = 1.0 / e.sum(dim=2, keepdim=True).clamp_min(1e-16)  # [n, T, 1, H]
    if dt == torch.bfloat16:
        e = e.to(dt).float()          # the probability plane the matmul sees
    acc = None
    for h in range(heads):
        o = torch.einsum("ntw,nwc->ntc", e[..., h], win_z[:, :, h].float())
        o = o * inv[:, :, 0, h:h + 1]
        acc = o if acc is None else acc + o
    return (acc * (1.0 / heads)).reshape(n, c).to(dt)


def banded_gat_mean_fused(
    bias_self: torch.Tensor,
    w: torch.Tensor,
    alphas: torch.Tensor,
    x: torch.Tensor,
    heads: int,
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Banded GAT forward: plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (or a raise)."""
    if x.device.type == "cpu":
        return banded_gat_mean_fused_plain(bias_self, w, alphas, x, heads,
                                           negative_slope)
    n_tiles, tile, width = bias_self.shape
    n, f = x.shape
    hc = w.shape[1]
    c = hc // heads
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("bias_self", bias_self), ("w", w), ("alphas", alphas)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x and w must share float32 or bfloat16, got "
                        f"{x.dtype} / {w.dtype}")
    if bias_self.dtype != torch.int8 or alphas.dtype != torch.float32:
        raise TypeError("bias_self must be int8 and alphas float32")
    if (n != n_tiles * tile or w.shape[0] != f or hc != heads * c
            or alphas.shape != (n, 2 * heads) or width < tile
            or (width - tile) % 2):
        raise ValueError(
            f"shape mismatch: bias_self {tuple(bias_self.shape)}, w "
            f"{tuple(w.shape)}, alphas {tuple(alphas.shape)}, x "
            f"{tuple(x.shape)}, heads {heads}")
    if c % 4:
        raise ValueError("the attention kernel moves 4 columns per access: "
                         "C must be a multiple of 4")
    if x.dtype == torch.bfloat16 and (
            f % 8 or hc % 8 or x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("the bf16 projection loads 16-byte chunks: F and "
                         "H·C must be multiples of 8 and x, w 16-byte "
                         "aligned")
    if 8 * width * 8 > 48 * 1024:
        raise ValueError(f"window width {width} exceeds the kernel's "
                         "shared-memory budget (768 columns)")
    lib = _lib()
    z = torch.empty((n, hc), dtype=x.dtype, device=x.device)
    out = torch.empty((n, c), dtype=x.dtype, device=x.device)
    rc = lib.banded_gat_mean_fused_launch(
        bias_self.data_ptr(), w.data_ptr(), alphas.data_ptr(), x.data_ptr(),
        z.data_ptr(), out.data_ptr(), n, f, heads, c, tile, width,
        negative_slope, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "banded_gat_mean_fused")
    _build.LAUNCHES["banded_gat_mean_fused"] += 1
    return out
