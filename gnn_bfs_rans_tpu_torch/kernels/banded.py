"""Fused-projection banded GAT: forward kernel, plain version, autograd op.

Counterpart of ``gnn_bfs_rans_tpu/kernels/banded.py::banded_gat_mean_fused``
(its forward ``banded_gat_mean_fused_fwd``, ``_gat_kernel`` with
``fuse_proj=True, mean_heads=True``, attention dropout and ``emit_z``) and of
``banded_gat_mean_fused_wa``, the training op whose custom VJP gives
(dW, dWa, dx).  The forward kernel is ``csrc/banded_gat.cu``; the backward
runs ``banded_bwd.banded_gat_bwd`` and ``banded_bwd.fold_project_bwd``.
Each source's header says what bounds it on the card and how the design
answers that.

Layouts are the JAX package's: ``bias_self`` int8 ``[n_tiles, T, Wcols]``,
``w`` ``[F, H·C]``, packed ``alphas`` f32 ``[N, 2H]`` (src | dst), ``x``
``[N, F]`` → ``[N, C]`` in x's dtype (float32 or bfloat16).  Dropout draws
from the hash stream of :mod:`.dropout`: tile t's [H·T, Wcols] plane uses
seed + t, so masks match the JAX package's interpret mode bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import dropout as _drop

KERNEL = "banded_gat"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _windows(a: torch.Tensor, tile: int, width: int) -> torch.Tensor:
    """[N, F] → [n_tiles, Wcols, F]: receiver tile t's window covers rows
    ``[t·T − pad, t·T − pad + Wcols)``, ``pad = (Wcols − T)/2``, zero
    outside ``[0, N)`` (those columns are masked)."""
    pad = (width - tile) // 2
    ap = torch.nn.functional.pad(a, (0, 0, pad, pad))
    return ap.unfold(0, width, tile).transpose(1, 2)


def inv_keep(rate: float) -> float:
    """1/(1 − rate) as the f32 factor the attention kernels scale by."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def attention_keep(seed, n_tiles: int, tile: int, width: int,
                   heads: int, rate: float, device) -> torch.Tensor:
    """[n_tiles, T, Wcols, H] keep mask of the attention dropout: element
    (h·T + i)·Wcols + w of tile t's [H·T, Wcols] plane, stream seed + t.
    ``seed``: an int or a [1] int64 tensor (read without a host sync)."""
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    t = ar(n_tiles)[:, None, None, None]
    flat = ((ar(heads)[None, None, None, :] * tile + ar(tile)[None, :, None, None])
            * width + ar(width)[None, None, :, None])
    return _drop.hash_bits(seed + t, flat) >= _drop.threshold(rate)


def banded_gat_mean_fused_plain(
    bias_self: torch.Tensor,
    w: torch.Tensor,
    alphas: torch.Tensor,
    x: torch.Tensor,
    heads: int,
    negative_slope: float = 0.2,
    dropout_rate: float = 0.0,
    seed: torch.Tensor | None = None,
    emit_z: bool = False,
):
    """Plain PyTorch version with the kernel's rounding points.

    Dense over the window like the TPU kernel: masked columns get the
    additive −1e30 bias and contribute exactly 0 after the exp.  Returns
    ``out``, or ``(out, z)`` with ``emit_z``.
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
    if dropout_rate > 0:
        keep = attention_keep(seed.long(), n_tiles, tile, width, heads,
                              dropout_rate, x.device)
        e = torch.where(keep, e * inv_keep(dropout_rate), 0.0)
    if dt == torch.bfloat16:
        e = e.to(dt).float()          # the probability plane the matmul sees
    acc = None
    for h in range(heads):
        o = torch.einsum("ntw,nwc->ntc", e[..., h], win_z[:, :, h].float())
        o = o * inv[:, :, 0, h:h + 1]
        acc = o if acc is None else acc + o
    out = (acc * (1.0 / heads)).reshape(n, c).to(dt)
    return (out, z) if emit_z else out


def banded_gat_mean_fused(
    bias_self: torch.Tensor,
    w: torch.Tensor,
    alphas: torch.Tensor,
    x: torch.Tensor,
    heads: int,
    negative_slope: float = 0.2,
    dropout_rate: float = 0.0,
    seed: torch.Tensor | None = None,
    emit_z: bool = False,
):
    """Banded GAT forward: plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (or a raise).  ``seed``: [1] int32 on x's device when
    ``dropout_rate > 0``.  Returns ``out``, or ``(out, z)`` with ``emit_z``."""
    if x.device.type == "cpu":
        return banded_gat_mean_fused_plain(bias_self, w, alphas, x, heads,
                                           negative_slope, dropout_rate, seed,
                                           emit_z)
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
    seed = _drop.check_seed(seed, dropout_rate, x.device)
    lib = _build.bind(
        KERNEL, "banded_gat_mean_fused_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
           ctypes.c_float, ctypes.c_void_p])
    z = torch.empty((n, hc), dtype=x.dtype, device=x.device)
    out = torch.empty((n, c), dtype=x.dtype, device=x.device)
    rc = lib.banded_gat_mean_fused_launch(
        bias_self.data_ptr(), w.data_ptr(), alphas.data_ptr(), x.data_ptr(),
        z.data_ptr(), out.data_ptr(), n, f, heads, c, tile, width,
        negative_slope, _DTYPE_CODE[x.dtype],
        None if seed is None else seed.data_ptr(),
        _drop.threshold(dropout_rate), inv_keep(dropout_rate) if seed is not None
        else 1.0, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "banded_gat_mean_fused")
    _build.LAUNCHES["banded_gat_mean_fused"] += 1
    return (out, z) if emit_z else out


class _GatMeanFusedWa(torch.autograd.Function):
    """``banded_gat_mean_fused_wa``: α = x·wa inside the op, cotangents
    (dW, dWa, dx); the band and the seed get none."""

    @staticmethod
    def forward(ctx, bias_self, w, wa, x, heads, negative_slope,
                dropout_rate, seed):
        # the JAX package's XLA product outside its Pallas kernel
        alphas = (x.float() @ wa.float()).contiguous()
        out, z = banded_gat_mean_fused(bias_self, w, alphas, x, heads,
                                       negative_slope, dropout_rate, seed,
                                       emit_z=True)
        ctx.save_for_backward(bias_self, w, wa, alphas, x, z, seed)
        ctx.args = (heads, negative_slope, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, g):
        from .banded_bwd import banded_gat_bwd, fold_project_bwd

        bias_self, w, wa, alphas, x, z, seed = ctx.saved_tensors
        heads, negative_slope, dropout_rate = ctx.args
        dz, da = banded_gat_bwd(bias_self, z, alphas,
                                g.to(z.dtype).contiguous(), heads,
                                negative_slope, dropout_rate, seed)
        dx, dw = fold_project_bwd(dz, x, w)
        # the narrow α products stay plain products, as in the JAX package
        dwa = (x.float().t() @ da).to(wa.dtype)
        dx = dx + (da.to(x.dtype).float() @ wa.float().t()).to(x.dtype)
        return None, dw.to(w.dtype), dwa, dx, None, None, None, None


def banded_gat_mean_fused_wa(bias_self, w, wa, x, heads,
                             negative_slope=0.2, dropout_rate=0.0, seed=None):
    """Differentiable fused GAT (head mean) with α = x·wa inside the op.

    ``wa`` is the packed [F, 2H] α factor (W·amat) in x's dtype."""
    return _GatMeanFusedWa.apply(bias_self, w, wa, x.contiguous(), heads,
                                 negative_slope, dropout_rate, seed)
