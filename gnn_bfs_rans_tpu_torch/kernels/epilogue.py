"""Fused residual + BatchNorm (batch statistics) + ReLU + dropout, and its
backward.

Counterpart of ``gnn_bfs_rans_tpu/kernels/epilogue.py::fused_epilogue``
(forward ``_fused_fwd_impl``, custom VJP ``_fused_vjp_bwd``).

forward (row 2), Triton kernels for its two Pallas calls:
  * ``_res_stats_kernel`` (was ``_res_stats_kernel``, ``epilogue.py:223``):
    xr = x + x_new, stored, plus per-block masked column sums Σxr and Σxr²
    over rows ``< n_valid``;
  * ``_affine_relu_kernel`` (was ``_fwd_kernel``, ``epilogue.py:240``):
    y = dropout(relu((xr − m̃)·a + b̃)) in xr's dtype;
  between them a one-program-per-column-block ``_finalize_kernel`` does
  what XLA does there in the JAX package: folds the block partials (in
  block order: deterministic, no atomics) and forms mean = Σxr/n, var =
  max(Σxr²/n − mean², 0) (the fused E[x²] − E[x]² form), a = γ·rsqrt(var +
  ε), m̃ the mean rounded to xr's dtype, b̃ = β + (m̃ − mean)·a
  (``_make_vec``).  The fold replaces a dozen small tensor ops on the host
  (0.37–0.50 ms of host time per call, measured on the card).
backward (row 3), one cooperative CUDA launch for its two Pallas calls
(``_bwd_partials_kernel``, ``:269``; ``_bwd_dx_kernel``, ``:283``) and the
fold between them: ``csrc/epilogue_bwd.cu``.  g1 = g ⊙ keep/(1 − rate) ⊙
[y_pre > 0] recomputed from (xr, the vectors, seed), column sums G1 = Σg1
and G2 = Σg1·x̂ over ALL rows (dbias, dscale), then dxr = a·(g1 − G1/n −
x̂·G2/n) on rows < n_valid, a·g1 on pad rows; g and xr are read once and
held in shared memory across a grid-wide barrier (the source's header).

Dropout draws from the hash stream of :mod:`.dropout` with the JAX
package's keys: element (row mod B)·C + c of stream seed + row // B, where
B is the JAX package's row block (``_pick_block``).  The Triton copy of the
hash is ``_keep`` below.  The drop scale 1/(1 − rate) is rounded to xr's
dtype, as the JAX package's weakly typed scalar is.

Every Triton launch passes ``enable_fp_fusion=False``: Triton would
otherwise contract (xr − m̃)·a + b̃ into one fused multiply-add (in bf16
too, once LLVM narrows the f32 products to bf16), rounding once where the
plain version and the JAX package round twice.  That moves many bf16
outputs by one ulp and, through the ReLU predicate the backward
recomputes, sends hundreds of gradient entries down the other branch of
the ReLU than the plain version takes.  The CUDA backward writes its
arithmetic with ``__fsub_rn``/``__fmul_rn``/``__fadd_rn`` for the same
reason.

What bounds it on an H100: memory.  Forward: x, x_new read, xr written and
read, y written (~31 MB at [12,032, 256] bf16); backward: g and xr read
once, dxr written (18.5 MB, 5.5 µs at 3.35 TB/s); the arithmetic is a few
operations per element.  No single PyTorch call computes this masked-
statistics form.
"""

import ctypes
import functools

import torch

from . import _build
from . import dropout as _drop

BLOCK_ROWS = 32
# launch options of every kernel: no multiply-add contraction (see above)
_OPTS = dict(enable_fp_fusion=False)
# vec rows ([4, C] f32): m̃, a, b̃, inv_std
_MEAN_LO, _EFF_SCALE, _EFF_BIAS, _INV_STD = 0, 1, 2, 3

# Bound at first launch (this module must import without Triton); the
# jitted kernels resolve ``tl`` and their helpers through the module's
# globals.
# The module keeps no ``from __future__ import annotations``: Triton reads
# the ``tl.constexpr`` annotations as objects.
triton = None
tl = None
_keep = None


def pick_block(n_pad: int, feat: int, itemsize: int = 4) -> int:
    """The JAX package's row block (``epilogue.py::_pick_block``): the
    largest 8-aligned divisor of ``n_pad`` whose block stays ≤ 512 KiB.
    It keys the dropout stream."""
    cap = max(512 * 1024 // (feat * itemsize), 8)
    best = 8
    for b in range(8, min(cap, n_pad) + 1, 8):
        if n_pad % b == 0:
            best = b
    return best


def drop_scale(rate: float, dtype: torch.dtype) -> float:
    """1/(1 − rate) as xr's dtype holds it."""
    return float(torch.tensor(1.0 / (1.0 - rate)).to(dtype))


def _epilogue_keep(seed, n_rows: int, c: int, block: int, rate: float,
                   device) -> torch.Tensor:
    """[n_rows, C] keep mask: element (row mod B)·C + c of stream
    seed + row // B; ``seed`` an int or a [1] int64 tensor."""
    rows = torch.arange(n_rows, device=device)[:, None]
    flat = (rows % block) * c + torch.arange(c, device=device)[None, :]
    return _drop.hash_bits(seed + rows // block, flat) >= _drop.threshold(rate)


def _stat_vectors(s1, s2, n_valid, scale, bias, eps, dtype):
    """mean, var and the [4, C] f32 (m̃, a, b̃, inv_std) rows from the
    column sums (the plain version of ``_finalize_kernel``)."""
    n = float(n_valid)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    inv_std = torch.rsqrt(var + eps)
    eff_scale = scale.float() * inv_std
    mean_lo = mean.to(dtype).float()
    eff_bias = bias.float() + (mean_lo - mean) * eff_scale
    return mean, var, torch.stack([mean_lo, eff_scale, eff_bias, inv_std])


def _affine_relu_plain(xr, vec):
    """relu((xr − m̃)·a + b̃), each operation rounded to xr's dtype, and
    the ReLU predicate (compared in f32)."""
    dt = xr.dtype
    y = (xr - vec[_MEAN_LO].to(dt)) * vec[_EFF_SCALE].to(dt) \
        + vec[_EFF_BIAS].to(dt)
    pos = y.float() > 0
    return torch.where(pos, y, torch.zeros_like(y)), pos


def _forward_plain(x, x_new, scale, bias, n_valid, eps, rate, seed):
    dt = torch.promote_types(x.dtype, x_new.dtype)
    xr = x.to(dt) + x_new.to(dt)
    xf = xr[:n_valid].float()
    mean, var, vec = _stat_vectors(xf.sum(0), (xf * xf).sum(0), n_valid,
                                   scale, bias, eps, dt)
    y, _ = _affine_relu_plain(xr, vec)
    if rate > 0:
        n_rows, c = xr.shape
        keep = _epilogue_keep(seed.long(), n_rows, c,
                              pick_block(n_rows, c, xr.element_size()), rate,
                              xr.device)
        y = torch.where(keep, (y.float() * drop_scale(rate, dt)).to(dt), 0.0
                        ).to(dt)
    return y, mean, var, xr, vec


def fused_epilogue_fwd_plain(x, x_new, scale, bias, n_valid: int, eps: float,
                             rate: float = 0.0, seed=None):
    """Plain PyTorch version with the kernels' rounding points."""
    return _forward_plain(x, x_new, scale, bias, n_valid, eps, rate, seed)[:3]


def fused_epilogue_bwd_plain(g, xr, vec, mean, n_valid: int, rate: float,
                             seed, x_dtype, xn_dtype):
    """(dx, dx_new, dscale, dbias) with the kernels' rounding points."""
    dt = xr.dtype
    _, pos = _affine_relu_plain(xr, vec)
    g = g.to(dt)
    if rate > 0:
        n_rows, c = xr.shape
        keep = _epilogue_keep(seed.long(), n_rows, c,
                              pick_block(n_rows, c, xr.element_size()), rate,
                              xr.device)
        g = torch.where(keep, (g.float() * drop_scale(rate, dt)).to(dt), 0.0
                        ).to(dt)
    g1 = torch.where(pos, g, torch.zeros_like(g)).float()
    xhat = (xr.float() - mean) * vec[_INV_STD]
    g1_sum, g2_sum = g1.sum(0), (g1 * xhat).sum(0)
    n = float(n_valid)
    real = (torch.arange(xr.shape[0], device=xr.device) < n_valid)[:, None]
    dxr = (vec[_EFF_SCALE] * torch.where(
        real, g1 - (g1_sum / n + xhat * (g2_sum / n)), g1)).to(dt)
    return dxr.to(x_dtype), dxr.to(xn_dtype), g2_sum, g1_sum


@functools.cache
def _kernels():
    global triton, tl, _keep
    import triton
    import triton.language as tl

    @triton.jit
    def _keep(seed, rows, cols, C, B, thresh):
        # csrc/dropout.cuh: element (row % B)·C + c of stream seed + row // B
        s = seed.to(tl.uint32) + (rows // B).to(tl.uint32)
        x = ((rows % B) * C + cols).to(tl.uint32) ^ (s * 0x9E3779B9)
        x = x ^ (x >> 16)
        x = x * 0x7FEB352D
        x = x ^ (x >> 15)
        x = x * 0x846CA68B
        x = x ^ (x >> 16)
        return x >= thresh

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
    def _affine_relu_kernel(xr_ptr, vec_ptr, y_ptr, seed_ptr, n_rows, C, B,
                            thresh, scale, DROPOUT: tl.constexpr,
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
        if DROPOUT:
            keep = _keep(tl.load(seed_ptr), rows[:, None], cols[None, :], C,
                         B, thresh)
            y = tl.where(keep, (y.to(tl.float32) * scale).to(dt), 0.0).to(dt)
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
        inv_std = tl.rsqrt(var + eps)
        a = tl.load(scale_ptr + cols, mask=cm, other=0.0) * inv_std
        mean_lo = mean
        if BF16:
            mean_lo = mean.to(tl.bfloat16).to(tl.float32)
        b = tl.load(bias_ptr + cols, mask=cm, other=0.0) + (mean_lo - mean) * a
        tl.store(mean_ptr + cols, mean, mask=cm)
        tl.store(var_ptr + cols, var, mask=cm)
        tl.store(vec_ptr + cols, mean_lo, mask=cm)
        tl.store(vec_ptr + C + cols, a, mask=cm)
        tl.store(vec_ptr + 2 * C + cols, b, mask=cm)
        tl.store(vec_ptr + 3 * C + cols, inv_std, mask=cm)

    return triton, _res_stats_kernel, _finalize_kernel, _affine_relu_kernel


_BWD_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _drop_args(xr, rate, seed):
    """(seed tensor, B, thresh, scale, DROPOUT) kernel arguments."""
    seed = _drop.check_seed(seed, rate, xr.device)
    if seed is None:
        # a dummy pointer: DROPOUT=False never reads it
        return xr, 1, 0, 1.0, False
    n_rows, c = xr.shape
    return (seed, pick_block(n_rows, c, xr.element_size()),
            _drop.threshold(rate), drop_scale(rate, xr.dtype), True)


def _forward(x, x_new, scale, bias, n_valid, eps, rate, seed):
    """(y, mean, var, xr, vec): plain version on the CPU, kernels on CUDA."""
    if x.device.type == "cpu":
        return _forward_plain(x, x_new, scale, bias, n_valid, eps, rate, seed)
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
    seed_t, block, thresh, dscale, dropout = _drop_args(x, rate, seed)
    triton, res_stats, finalize, affine_relu = _kernels()
    n_rows, c = x.shape
    block_c = triton.next_power_of_2(c)
    grid = (triton.cdiv(n_rows, BLOCK_ROWS),)
    xr = torch.empty_like(x)
    part = torch.empty((grid[0], 2, c), dtype=torch.float32, device=x.device)
    res_stats[grid](x, x_new, xr, part, n_rows, n_valid, c,
                    BLOCK_R=BLOCK_ROWS, BLOCK_C=block_c, num_warps=8, **_OPTS)
    _build.LAUNCHES["fused_epilogue_fwd"] += 1
    vec = torch.empty((4, c), dtype=torch.float32, device=x.device)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    # narrow column blocks: more programs share the serial fold over the
    # row-block partials
    finalize[(triton.cdiv(c, 16),)](
        part, scale, bias, vec, mean, var, grid[0], c, float(n_valid),
        float(eps), BF16=dt == torch.bfloat16, BLOCK_G=128, BLOCK_C=16,
        num_warps=4, **_OPTS)
    y = torch.empty_like(xr)
    affine_relu[grid](xr, vec, y, seed_t, n_rows, c, block, thresh, dscale,
                      DROPOUT=dropout, BLOCK_R=BLOCK_ROWS, BLOCK_C=block_c,
                      num_warps=8, **_OPTS)
    _build.LAUNCHES["fused_epilogue_fwd"] += 1
    return y, mean, var, xr, vec


def fused_epilogue_fwd(x, x_new, scale, bias, n_valid: int, eps: float = 1e-5,
                       rate: float = 0.0, seed=None):
    """y = dropout(relu(BN_batch(x + x_new))); returns (y, mean, var).

    Statistics run over rows ``[0, n_valid)``; y covers every row.  ``seed``:
    [1] int32 on x's device when ``rate > 0``.  CPU tensors take the plain
    version, CUDA tensors the Triton kernels.  No gradient: see
    :func:`fused_epilogue`.
    """
    return _forward(x, x_new, scale, bias, n_valid, eps, rate, seed)[:3]


def fused_epilogue_bwd(g, xr, vec, mean, n_valid: int, rate: float, seed,
                       x_dtype, xn_dtype):
    """(dx, dx_new, dscale, dbias) of :func:`fused_epilogue` from the
    forward's residual ``xr``, its ``vec`` and ``mean``, and the cotangent
    ``g`` of y.  CPU tensors take the plain version, CUDA tensors the
    kernel of ``csrc/epilogue_bwd.cu``."""
    if xr.device.type == "cpu":
        return fused_epilogue_bwd_plain(g, xr, vec, mean, n_valid, rate, seed,
                                        x_dtype, xn_dtype)
    if xr.device.type != "cuda":
        raise ValueError(f"unsupported device {xr.device}")
    n_rows, c = xr.shape
    if g.shape != xr.shape or g.device != xr.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} does not match "
                         f"xr {tuple(xr.shape)} on {xr.device}")
    if xr.dtype not in _BWD_DTYPE or vec.shape != (4, c) or mean.shape != (c,):
        raise ValueError(f"xr {xr.dtype} {tuple(xr.shape)}, vec "
                         f"{tuple(vec.shape)}, mean {tuple(mean.shape)}")
    if not 0 < n_valid <= n_rows:
        raise ValueError(f"n_valid {n_valid} outside (0, {n_rows}]")
    dt = xr.dtype
    g = g.to(dt).contiguous()
    xr = xr.contiguous()
    vec = vec.float().contiguous()
    mean = mean.float().contiguous()
    seed_t, block, thresh, dscale, _ = _drop_args(xr, rate, seed)
    seed_t = seed_t if rate > 0 else None
    # the mixed form: a bf16 copy for the bf16 input of an f32 residual
    lo = dt == torch.float32 and torch.bfloat16 in (x_dtype, xn_dtype)
    dxr = torch.empty_like(xr)
    dx_lo = torch.empty(xr.shape, dtype=torch.bfloat16, device=xr.device) \
        if lo else None
    max_grid = 4 * _sm_count(xr.device)
    # the partials, then one word for the grid barrier's counter
    part = torch.empty(max_grid * 2 * c + 1, dtype=torch.float32,
                       device=xr.device)
    stats = torch.empty((4, c), dtype=torch.float32, device=xr.device)
    lib = _build.bind("epilogue_bwd", "epilogue_bwd_launch",
                      [ctypes.c_void_p] * 5 + [ctypes.c_uint, ctypes.c_float]
                      + [ctypes.c_int] * 4
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
    rc = lib.epilogue_bwd_launch(
        g.data_ptr(), xr.data_ptr(), vec.data_ptr(), mean.data_ptr(),
        None if seed_t is None else seed_t.data_ptr(), thresh, dscale, block,
        n_rows, n_valid, c, part.data_ptr(), part[-1:].data_ptr(), max_grid,
        stats[2:].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        dxr.data_ptr(),
        None if dx_lo is None else dx_lo.data_ptr(), _BWD_DTYPE[dt],
        torch.cuda.current_stream(xr.device).cuda_stream)
    _build.check(lib, rc, "fused_epilogue_bwd")
    # one count per pallas_call site replaced (the partials and dx calls)
    _build.LAUNCHES["fused_epilogue_bwd"] += 2
    outs = [dxr if d == dt else dx_lo if d == torch.bfloat16 else dxr.to(d)
            for d in (x_dtype, xn_dtype)]
    return outs[0], outs[1], stats[0], stats[1]


class _FusedEpilogue(torch.autograd.Function):
    """The JAX package's ``fused_epilogue`` custom VJP: keeps only xr and
    the per-channel vectors; mean and var carry no gradient."""

    @staticmethod
    def forward(ctx, x, x_new, scale, bias, seed, n_valid, rate, eps):
        y, mean, var, xr, vec = _forward(x, x_new, scale, bias, n_valid, eps,
                                         rate, seed)
        ctx.save_for_backward(xr, vec, mean, seed)
        ctx.args = (n_valid, rate, x.dtype, x_new.dtype)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        xr, vec, mean, seed = ctx.saved_tensors
        n_valid, rate, x_dt, xn_dt = ctx.args
        dx, dxn, dscale, dbias = fused_epilogue_bwd(
            g, xr, vec, mean, n_valid, rate, seed, x_dt, xn_dt)
        return dx, dxn, dscale, dbias, None, None, None, None


def fused_epilogue(x, x_new, scale, bias, seed, n_valid: int, rate: float,
                   eps: float):
    """Differentiable y = dropout(relu(BN_train(x + x_new))); returns
    (y, mean, var) with the biased batch statistics for the running-stats
    update.  Argument order of the JAX package's ``fused_epilogue``."""
    return _FusedEpilogue.apply(x, x_new, scale, bias, seed, n_valid, rate,
                                eps)
