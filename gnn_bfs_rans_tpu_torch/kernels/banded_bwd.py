"""Banded GAT backward: the attention kernel (row 5), the projection kernel
(row 6), and their plain versions.

* ``banded_gat_bwd`` replaces ``gnn_bfs_rans_tpu/kernels/banded_bwd.py::
  banded_gat_bwd`` (``mean_expand=True``): softmax recompute, dropout
  replay, softmax VJP → dz [N, H·C] in z's dtype and the packed dα [N, 2H]
  f32.  Kernel: ``csrc/banded_gat_bwd.cu``.  The TPU kernel emits
  per-window dz partials for ``fold_project_bwd`` to fold; the CUDA kernel
  gathers each sender's dz row from its receivers and emits dz rows, with
  one rounding instead of two (a few bf16 ulps apart in bf16).  It is
  the backward of both kernel 1's op and row 4's (``banded_gat_mean_packed``,
  the JAX package's ``_gatm_vjp_bwd``).
* ``fold_project_bwd`` replaces ``banded_bwd.py::fold_project_bwd``
  (``with_bias=False``): dx = dz·Wᵀ in x's dtype and dW = xᵀ·dz in f32, both
  in the kernel's own body.  Kernel: ``csrc/fold_project_bwd.cu``.  Here it
  takes dz rows, so its fold is that of dW's per-block partials.

The port runs one backward at every size; the TPU package's carry-based
direct-dz mode (``project_x``/``alpha_wa``, engaged above 64 MB of dz) is
not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import dropout as _drop
from .banded import _DTYPE_CODE, _windows, attention_keep, inv_keep


def _mm_round(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The TPU kernels' bf16 rounding point of a matmul operand."""
    return v.to(dt).float() if dt == torch.bfloat16 else v


def banded_gat_bwd_plain(bias_self, z, alphas, g, heads, negative_slope=0.2,
                         dropout_rate=0.0, seed=None):
    """Plain PyTorch version with the kernel's rounding points: dense over
    the window like the TPU kernel (masked entries contribute exactly 0),
    dz summed in f32 over every receiver, then rounded once."""
    n_tiles, tile, width = bias_self.shape
    n, hc = z.shape
    c = hc // heads
    dt = z.dtype
    win_z = _windows(z, tile, width).reshape(n_tiles, width, heads, c).float()
    win_a = _windows(alphas[:, :heads], tile, width)          # [n, W, H]
    a_dst = alphas[:, heads:].reshape(n_tiles, tile, heads)
    pre = a_dst[:, :, None, :] + win_a[:, None, :, :]          # [n, T, W, H]
    full = torch.where(pre >= 0, pre, negative_slope * pre)
    full = full + ((bias_self.float() - 1.0) * 1e30)[..., None]
    e = torch.exp(full - full.amax(dim=2, keepdim=True))
    inv = 1.0 / e.sum(dim=2, keepdim=True).clamp_min(1e-16)  # [n, T, 1, H]
    gout = g.float().reshape(n_tiles, tile, c) * (1.0 / heads)
    dp = torch.einsum("ntc,nwhc->ntwh", _mm_round(gout, dt), win_z)
    e_d = e
    if dropout_rate > 0:
        keep = attention_keep(seed.long(), n_tiles, tile, width, heads,
                              dropout_rate, z.device)
        k = inv_keep(dropout_rate)
        e_d = torch.where(keep, e * k, 0.0)
        dp = torch.where(keep, dp * k, 0.0)
    rs = (e * dp).sum(dim=2, keepdim=True) * inv
    dpre = e * ((dp - rs) * inv) * torch.where(pre >= 0, 1.0, negative_slope)
    dad = dpre.sum(dim=2).reshape(n, heads)
    das_win = _mm_round(dpre, dt).sum(dim=1)                  # [n, W, H]
    gout_s = gout[:, :, None, :] * inv[:, :, 0, :, None]      # [n, T, H, C]
    dz_win = torch.einsum("ntwh,nthc->nwhc", _mm_round(e_d, dt),
                          _mm_round(gout_s, dt))
    # fold the windows onto sender rows; window rows outside [0, N) go to a
    # spare row n that is dropped (no data-dependent shapes: no host sync)
    pad = (width - tile) // 2
    rows = (torch.arange(n_tiles, device=z.device)[:, None] * tile - pad
            + torch.arange(width, device=z.device)[None, :]).reshape(-1)
    rows = torch.where((rows >= 0) & (rows < n), rows, n)
    dz = torch.zeros(n + 1, hc, dtype=torch.float32, device=z.device)
    dz.index_add_(0, rows, dz_win.reshape(-1, hc))
    das = torch.zeros(n + 1, heads, dtype=torch.float32, device=z.device)
    das.index_add_(0, rows, das_win.reshape(-1, heads))
    return dz[:n].to(dt), torch.cat([das[:n], dad], dim=1)


def banded_gat_bwd(bias_self, z, alphas, g, heads, negative_slope=0.2,
                   dropout_rate=0.0, seed=None):
    """(dz, dα) of the head-mean banded GAT given z (the forward's
    projection), the packed f32 α and the output cotangent ``g`` [N, C] in
    z's dtype.  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if z.device.type == "cpu":
        return banded_gat_bwd_plain(bias_self, z, alphas, g, heads,
                                    negative_slope, dropout_rate, seed)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    n_tiles, tile, width = bias_self.shape
    n, hc = z.shape
    c = hc // heads
    for name, t in (("bias_self", bias_self), ("alphas", alphas), ("g", g)):
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")
    if z.dtype not in _DTYPE_CODE or g.dtype != z.dtype:
        raise TypeError(f"z and g must share float32 or bfloat16, got "
                        f"{z.dtype} / {g.dtype}")
    if bias_self.dtype != torch.int8 or alphas.dtype != torch.float32:
        raise TypeError("bias_self must be int8 and alphas float32")
    if (n != n_tiles * tile or hc != heads * c or g.shape != (n, c)
            or alphas.shape != (n, 2 * heads) or width < tile
            or (width - tile) % 2):
        raise ValueError(f"shape mismatch: bias_self {tuple(bias_self.shape)}, "
                         f"z {tuple(z.shape)}, alphas {tuple(alphas.shape)}, "
                         f"g {tuple(g.shape)}, heads {heads}")
    if 4 * width * 16 > 48 * 1024 or 4 * (width + tile) * 12 > 48 * 1024:
        raise ValueError(f"window width {width} exceeds the kernel's "
                         "shared-memory budget (768 columns)")
    seed = _drop.check_seed(seed, dropout_rate, z.device)
    lib = _build.bind("banded_gat_bwd", "banded_gat_bwd_launch",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
                         ctypes.c_void_p])
    stats = torch.empty((n, 3 * heads), dtype=torch.float32, device=z.device)
    dz = torch.empty_like(z)
    da = torch.empty((n, 2 * heads), dtype=torch.float32, device=z.device)
    rc = lib.banded_gat_bwd_launch(
        bias_self.data_ptr(), alphas.data_ptr(), z.data_ptr(), g.data_ptr(),
        stats.data_ptr(), dz.data_ptr(), da.data_ptr(), n, heads, c, tile,
        width, negative_slope, 1.0 / heads, _DTYPE_CODE[z.dtype],
        None if seed is None else seed.data_ptr(),
        _drop.threshold(dropout_rate),
        inv_keep(dropout_rate) if seed is not None else 1.0,
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(lib, rc, "banded_gat_bwd")
    _build.LAUNCHES["banded_gat_bwd"] += 1
    return dz, da


def fold_project_bwd_plain(dz, x, w):
    """(dx, dW): dx = dz·Wᵀ rounded to x's dtype, dW = xᵀ·dz in f32."""
    dx = (dz.float() @ w.float().t()).to(x.dtype)
    return dx, x.float().t() @ dz.float()


def _k_chunk(n: int, f: int, hc: int) -> int:
    """Rows per dW slice: ~2 blocks per SM of the H100 (132), slices of at
    least 256 rows, a multiple of the 32-row K step."""
    def cdiv(a, b):
        return -(-a // b)

    splits = max(1, min(cdiv(264, cdiv(f, 128) * cdiv(hc, 128)), n // 256))
    return cdiv(cdiv(n, splits), 32) * 32


def fold_project_bwd(dz, x, w):
    """Projection backward of z = x·W from dz rows: (dx [N, F] in x's
    dtype, dW [F, H·C] f32).  CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if dz.device.type == "cpu":
        return fold_project_bwd_plain(dz, x, w)
    if dz.device.type != "cuda":
        raise ValueError(f"unsupported device {dz.device}")
    n, hc = dz.shape
    f = x.shape[1]
    for name, t in (("dz", dz), ("x", x), ("w", w)):
        if t.device != dz.device:
            raise ValueError(f"{name} is on {t.device}, dz on {dz.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != dz.dtype:
            raise TypeError(f"dz, x and w must share one dtype, got "
                            f"{dz.dtype} / {x.dtype} / {w.dtype}")
    if dz.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dz.dtype}")
    if x.shape[0] != n or w.shape != (f, hc):
        raise ValueError(f"shape mismatch: dz {tuple(dz.shape)}, x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if dz.dtype == torch.bfloat16 and (
            f % 8 or hc % 8
            or any(t.data_ptr() % 16 for t in (dz, x, w))):
        raise ValueError("the bf16 products load 16-byte chunks: F and H·C "
                         "must be multiples of 8 and dz, x, w 16-byte aligned")
    lib = _build.bind("fold_project_bwd", "fold_project_bwd_launch",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
    k_chunk = _k_chunk(n, f, hc)
    splits = -(-n // k_chunk)
    dx = torch.empty_like(x)
    dw = torch.empty((f, hc), dtype=torch.float32, device=dz.device)
    part = torch.empty((splits, f, hc), dtype=torch.float32, device=dz.device)
    rc = lib.fold_project_bwd_launch(
        dz.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), part.data_ptr(), n, f, hc, k_chunk,
        _DTYPE_CODE[dz.dtype], torch.cuda.current_stream(dz.device).cuda_stream)
    _build.check(lib, rc, "fold_project_bwd")
    _build.LAUNCHES["fold_project_bwd"] += 1
    return dx, dw
