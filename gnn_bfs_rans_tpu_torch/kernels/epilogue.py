"""Fused residual + BatchNorm (batch statistics) + ReLU forward, rate 0.

Counterpart of the forward of ``gnn_bfs_rans_tpu/kernels/epilogue.py::
fused_epilogue`` (``_fused_fwd_impl``) at dropout rate 0 — the serving
path's ``exact_bn`` mode.  Two Triton passes replace its two Pallas calls:

* ``_res_stats_kernel`` (was ``_res_stats_kernel``, ``epilogue.py:223``):
  xr = x + x_new, stored, plus per-block masked column sums Σxr and Σxr²
  over rows ``< n_valid``;
* ``_affine_relu_kernel`` (was ``_fwd_kernel``, ``epilogue.py:240``):
  y = relu((xr − m̃)·a + b̃) in xr's dtype.

Between them a one-program ``_finalize_kernel`` does what XLA does there in
the JAX package: folds the block partials and forms the per-channel
vectors mean = Σxr/n, var = max(Σxr²/n − mean², 0) (the fused
E[x²] − E[x]² form, not ``MaskedBatchNorm``'s two-pass variance),
a = γ·rsqrt(var + ε), m̃ the mean rounded to xr's dtype and
b̃ = β + (m̃ − mean)·a (``_make_vec``) — one launch instead of a dozen
small tensor ops on the host.

What bounds it on an H100: memory.  It reads x and x_new, writes and reads
xr, and writes y: 5·N·C·dtype bytes (≈ 31 MB at [12,032, 256] bf16, ~9 µs
at 3.35 TB/s); the arithmetic is a few operations per element.  The design
streams each row block once per pass with wide coalesced loads and keeps
the column partials per block (no atomics, so the sums are deterministic).
No single PyTorch call computes this masked-statistics form.
"""

import functools

import torch

from . import _build

BLOCK_ROWS = 32

# Bound at first launch (this module must import without Triton); the
# jitted kernels resolve ``tl`` through the module's globals.  The module
# keeps no ``from __future__ import annotations``: Triton reads the
# ``tl.constexpr`` annotations as objects.
triton = None
tl = None


def _stat_vectors(s1, s2, n_valid, scale, bias, eps, dtype):
    """mean, var and the [3, C] f32 (m̃, a, b̃) rows from the column sums
    (the plain version of ``_finalize_kernel``)."""
    n = float(n_valid)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    eff_scale = scale.float() * torch.rsqrt(var + eps)
    mean_lo = mean.to(dtype).float()
    eff_bias = bias.float() + (mean_lo - mean) * eff_scale
    return mean, var, torch.stack([mean_lo, eff_scale, eff_bias])


def fused_epilogue_fwd_plain(x, x_new, scale, bias, n_valid: int, eps: float):
    """Plain PyTorch version with the kernels' rounding points."""
    dt = torch.promote_types(x.dtype, x_new.dtype)
    xr = x.to(dt) + x_new.to(dt)
    xf = xr[:n_valid].float()
    mean, var, vec = _stat_vectors(xf.sum(0), (xf * xf).sum(0), n_valid,
                                   scale, bias, eps, dt)
    y = (xr - vec[0].to(dt)) * vec[1].to(dt) + vec[2].to(dt)
    return torch.where(y.float() > 0, y, torch.zeros_like(y)), mean, var


@functools.cache
def _kernels():
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def _res_stats_kernel(x_ptr, xn_ptr, xr_ptr, part_ptr, n_rows, n_valid,
                          C, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_C)
        inb = (rows[:, None] < n_rows) & (cols[None, :] < C)
        offs = rows[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=inb, other=0.0).to(tl.float32)
        xn = tl.load(xn_ptr + offs, mask=inb, other=0.0).to(tl.float32)
        xr = (x + xn).to(xr_ptr.dtype.element_ty)
        tl.store(xr_ptr + offs, xr, mask=inb)
        xf = tl.where(inb & (rows[:, None] < n_valid), xr.to(tl.float32), 0.0)
        cm = cols < C
        tl.store(part_ptr + pid * 2 * C + cols, tl.sum(xf, axis=0), mask=cm)
        tl.store(part_ptr + pid * 2 * C + C + cols, tl.sum(xf * xf, axis=0),
                 mask=cm)

    @triton.jit
    def _affine_relu_kernel(xr_ptr, vec_ptr, y_ptr, n_rows, C,
                            BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_C)
        cm = cols < C
        inb = (rows[:, None] < n_rows) & cm[None, :]
        offs = rows[:, None] * C + cols[None, :]
        dt = xr_ptr.dtype.element_ty
        xr = tl.load(xr_ptr + offs, mask=inb, other=0.0)
        # each operation rounds to xr's dtype, as (xr − m̃)·a + b̃ does there
        m = tl.load(vec_ptr + cols, mask=cm, other=0.0).to(dt)
        a = tl.load(vec_ptr + C + cols, mask=cm, other=0.0).to(dt)
        b = tl.load(vec_ptr + 2 * C + cols, mask=cm, other=0.0).to(dt)
        t = (xr.to(tl.float32) - m[None, :].to(tl.float32)).to(dt)
        t = (t.to(tl.float32) * a[None, :].to(tl.float32)).to(dt)
        y = (t.to(tl.float32) + b[None, :].to(tl.float32)).to(dt)
        y = tl.where(y.to(tl.float32) > 0.0, y, 0.0).to(dt)
        tl.store(y_ptr + offs, y, mask=inb)

    @triton.jit
    def _finalize_kernel(part_ptr, scale_ptr, bias_ptr, vec_ptr, mean_ptr,
                         var_ptr, G, C, n, eps, BF16: tl.constexpr,
                         BLOCK_G: tl.constexpr, BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cm = cols < C
        s1 = tl.zeros([BLOCK_C], dtype=tl.float32)
        s2 = tl.zeros([BLOCK_C], dtype=tl.float32)
        for g0 in range(0, G, BLOCK_G):
            gs = g0 + tl.arange(0, BLOCK_G)
            inb = (gs[:, None] < G) & cm[None, :]
            offs = gs[:, None] * 2 * C + cols[None, :]
            s1 += tl.sum(tl.load(part_ptr + offs, mask=inb, other=0.0), axis=0)
            s2 += tl.sum(tl.load(part_ptr + C + offs, mask=inb, other=0.0),
                         axis=0)
        mean = s1 / n
        var = tl.maximum(s2 / n - mean * mean, 0.0)
        a = tl.load(scale_ptr + cols, mask=cm, other=0.0) * tl.rsqrt(var + eps)
        mean_lo = mean
        if BF16:
            mean_lo = mean.to(tl.bfloat16).to(tl.float32)
        b = tl.load(bias_ptr + cols, mask=cm, other=0.0) + (mean_lo - mean) * a
        tl.store(mean_ptr + cols, mean, mask=cm)
        tl.store(var_ptr + cols, var, mask=cm)
        tl.store(vec_ptr + cols, mean_lo, mask=cm)
        tl.store(vec_ptr + C + cols, a, mask=cm)
        tl.store(vec_ptr + 2 * C + cols, b, mask=cm)

    return triton, _res_stats_kernel, _finalize_kernel, _affine_relu_kernel


def fused_epilogue_fwd(x, x_new, scale, bias, n_valid: int, eps: float = 1e-5):
    """y = relu(BN_batch(x + x_new)); returns (y, mean, var).

    Statistics run over rows ``[0, n_valid)``; y covers every row.  CPU
    tensors take the plain version, CUDA tensors the Triton kernels.
    """
    if x.device.type == "cpu":
        return fused_epilogue_fwd_plain(x, x_new, scale, bias, n_valid, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dt = torch.promote_types(x.dtype, x_new.dtype)
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {dt}")
    if x.shape != x_new.shape or x.dim() != 2 or scale.shape != (x.shape[1],) \
            or bias.shape != scale.shape or not 0 < n_valid <= x.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, x_new "
                         f"{tuple(x_new.shape)}, scale {tuple(scale.shape)}, "
                         f"n_valid {n_valid}")
    for t in (x_new, scale, bias):
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")
    # mixed dtypes promote as the JAX package's x.astype(xr_dtype) does
    x = x.to(dt).contiguous()
    x_new = x_new.to(dt).contiguous()
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    triton, res_stats, finalize, affine_relu = _kernels()
    n_rows, c = x.shape
    block_c = triton.next_power_of_2(c)
    grid = (triton.cdiv(n_rows, BLOCK_ROWS),)
    xr = torch.empty_like(x)
    part = torch.empty((grid[0], 2, c), dtype=torch.float32, device=x.device)
    res_stats[grid](x, x_new, xr, part, n_rows, n_valid, c,
                    BLOCK_R=BLOCK_ROWS, BLOCK_C=block_c, num_warps=8)
    _build.LAUNCHES["fused_epilogue_fwd"] += 1
    vec = torch.empty((3, c), dtype=torch.float32, device=x.device)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    # narrow column blocks: more programs share the serial fold over the
    # row-block partials
    finalize[(triton.cdiv(c, 16),)](
        part, scale, bias, vec, mean, var, grid[0], c, float(n_valid),
        float(eps), BF16=dt == torch.bfloat16, BLOCK_G=128, BLOCK_C=16,
        num_warps=4)
    y = torch.empty_like(xr)
    affine_relu[grid](xr, vec, y, n_rows, c,
                      BLOCK_R=BLOCK_ROWS, BLOCK_C=block_c, num_warps=8)
    _build.LAUNCHES["fused_epilogue_fwd"] += 1
    return y, mean, var
