"""Fused residual + BatchNorm (batch statistics) + ReLU + dropout, and its
backward.

Counterpart of ``gnn_bfs_rans_tpu/kernels/epilogue.py::fused_epilogue``
(forward ``_fused_fwd_impl``, custom VJP ``_fused_vjp_bwd``).

forward (row 2), one cooperative CUDA launch for its two Pallas calls
(``_res_stats_kernel``, ``epilogue.py:223``; ``_fwd_kernel``, ``:240``) and
the XLA ``_make_vec`` between them: ``csrc/epilogue_fwd.cu``.  xr = x +
x_new, written once and held in shared memory; masked column sums Σxr and
Σxr² over rows ``< n_valid``; after a grid-wide barrier the partials
folded in block order (deterministic, no atomics) into mean = Σxr/n, var =
max(Σxr²/n − mean², 0) (the fused E[x²] − E[x]² form), a = γ·rsqrt(var +
ε), m̃ the mean rounded to xr's dtype, b̃ = β + (m̃ − mean)·a; the dropout
keep bits drawn while a second barrier publishes those; then y =
dropout(relu((xr − m̃)·a + b̃)) in xr's dtype from the held tile.
backward (row 3), one cooperative CUDA launch for its two Pallas calls
(``_bwd_partials_kernel``, ``:269``; ``_bwd_dx_kernel``, ``:283``) and the
fold between them: ``csrc/epilogue_bwd.cu``.  g1 = g ⊙ keep/(1 − rate) ⊙
[y_pre > 0] recomputed from (xr, the vectors, seed), column sums G1 = Σg1
and G2 = Σg1·x̂ over ALL rows (dbias, dscale), then dxr = a·(g1 − G1/n −
x̂·G2/n) on rows < n_valid, a·g1 on pad rows; g and xr are read once and
held in shared memory across a grid-wide barrier (the source's header).

Dropout draws from the hash stream of :mod:`.dropout` (``csrc/dropout.cuh``
on the card) with the JAX package's keys: element (row mod B)·C + c of
stream seed + row // B, where B is the JAX package's row block
(``_pick_block``).  The drop scale 1/(1 − rate) is rounded to xr's dtype,
as the JAX package's weakly typed scalar is.

Both launches write their arithmetic with ``__fsub_rn``/``__fmul_rn``/
``__fadd_rn``: a fused multiply-add of (xr − m̃)·a + b̃ would round once
where the plain version and the JAX package round twice, which moves many
bf16 outputs by one ulp and, through the ReLU predicate the backward
recomputes, sends hundreds of gradient entries down the other branch of
the ReLU than the plain version takes.  The grid barrier, the block
partition and the cooperative launch are ``csrc/coop.cuh``, shared by the
two.

What bounds it on an H100: memory.  Forward: x, x_new read, xr and y
written once (24.6 MB at [12,032, 256] bf16, 7.4 µs at 3.35 TB/s);
backward: g and xr read once, dxr written (18.5 MB, 5.5 µs); the
arithmetic is a few operations per element.  No single PyTorch call
computes this masked-statistics form.
"""

import ctypes
import functools

import torch

from . import _build
from . import dropout as _drop

# vec rows ([4, C] f32): m̃, a, b̃, inv_std
_MEAN_LO, _EFF_SCALE, _EFF_BIAS, _INV_STD = 0, 1, 2, 3


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
    column sums (the plain version of the kernel's fold)."""
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


_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# one grid-barrier counter a (device, stream), from a bank zeroed once per
# device; each launch leaves its counter at zero (csrc/coop.cuh::grid_done)
_BANK_WORDS = 1024
_BANKS: dict = {}
_SLOTS: dict = {}


def _barrier_counter(device) -> torch.Tensor:
    """The grid barrier's counter for launches on the current stream:
    launches on two streams never share one, and a launch needs no memset
    before it (none in a captured CUDA graph either).  The bank is zeroed
    at the device's first launch, which must not be inside a graph
    capture (a warm-up call before capture, as every capture needs)."""
    bank = _BANKS.get(device)
    if bank is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the epilogue kernels' first launch on a "
                               "device must precede any CUDA graph capture")
        bank = _BANKS[device] = torch.zeros(_BANK_WORDS, dtype=torch.int32,
                                            device=device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    slot = _SLOTS.setdefault(key, len(_SLOTS) % _BANK_WORDS)
    return bank[slot:slot + 1]


def _drop_args(xr, rate, seed):
    """(seed tensor or None, B, thresh, scale) kernel arguments."""
    seed = _drop.check_seed(seed, rate, xr.device)
    if seed is None:
        return None, 1, 0, 1.0
    n_rows, c = xr.shape
    return (seed, pick_block(n_rows, c, xr.element_size()),
            _drop.threshold(rate), drop_scale(rate, xr.dtype))


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
    # mixed dtypes promote as the JAX package's x.astype(xr_dtype) does; a
    # bf16 x_new under an f32 x (the mixed form) widens in the kernel
    x = x.to(dt).contiguous()
    x_new = (x_new if x_new.dtype == torch.bfloat16 else x_new.to(dt)
             ).contiguous()
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    seed_t, block, thresh, dscale = _drop_args(x, rate, seed)
    n_rows, c = x.shape
    dev = x.device
    xr = torch.empty_like(x)
    y = torch.empty_like(x)
    vec = torch.empty((4, c), dtype=torch.float32, device=dev)
    stats = torch.empty((2, c), dtype=torch.float32, device=dev)
    max_grid = 4 * _sm_count(dev)
    part = torch.empty(max_grid * 2 * c, dtype=torch.float32, device=dev)
    lib = _build.bind("epilogue_fwd", "epilogue_fwd_launch",
                      [ctypes.c_void_p] * 5 + [ctypes.c_uint, ctypes.c_float]
                      + [ctypes.c_int] * 4 + [ctypes.c_float]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                      + [ctypes.c_void_p])
    rc = lib.epilogue_fwd_launch(
        x.data_ptr(), x_new.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if seed_t is None else seed_t.data_ptr(), thresh, dscale, block,
        n_rows, n_valid, c, float(eps), part.data_ptr(),
        _barrier_counter(dev).data_ptr(), max_grid, vec.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(),
        xr.data_ptr(), y.data_ptr(), _DTYPE[dt], _DTYPE[x_new.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "fused_epilogue_fwd")
    # one count per pallas_call site replaced (the partials and affine calls)
    _build.LAUNCHES["fused_epilogue_fwd"] += 2
    return y, stats[0], stats[1], xr, vec


def fused_epilogue_fwd(x, x_new, scale, bias, n_valid: int, eps: float = 1e-5,
                       rate: float = 0.0, seed=None):
    """y = dropout(relu(BN_batch(x + x_new))); returns (y, mean, var).

    Statistics run over rows ``[0, n_valid)``; y covers every row.  ``seed``:
    [1] int32 on x's device when ``rate > 0``.  CPU tensors take the plain
    version, CUDA tensors the kernel of ``csrc/epilogue_fwd.cu``.  No
    gradient: see :func:`fused_epilogue`.
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
    if xr.dtype not in _DTYPE or vec.shape != (4, c) or mean.shape != (c,):
        raise ValueError(f"xr {xr.dtype} {tuple(xr.shape)}, vec "
                         f"{tuple(vec.shape)}, mean {tuple(mean.shape)}")
    if not 0 < n_valid <= n_rows:
        raise ValueError(f"n_valid {n_valid} outside (0, {n_rows}]")
    dt = xr.dtype
    g = g.to(dt).contiguous()
    xr = xr.contiguous()
    vec = vec.float().contiguous()
    mean = mean.float().contiguous()
    seed_t, block, thresh, dscale = _drop_args(xr, rate, seed)
    # the mixed form: a bf16 copy for the bf16 input of an f32 residual
    lo = dt == torch.float32 and torch.bfloat16 in (x_dtype, xn_dtype)
    dxr = torch.empty_like(xr)
    dx_lo = torch.empty(xr.shape, dtype=torch.bfloat16, device=xr.device) \
        if lo else None
    max_grid = 4 * _sm_count(xr.device)
    part = torch.empty(max_grid * 2 * c, dtype=torch.float32,
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
        n_rows, n_valid, c, part.data_ptr(),
        _barrier_counter(xr.device).data_ptr(), max_grid,
        stats[2:].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        dxr.data_ptr(),
        None if dx_lo is None else dx_lo.data_ptr(), _DTYPE[dt],
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
