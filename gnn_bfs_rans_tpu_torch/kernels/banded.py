"""The banded kernels of the forward: GAT attention and the SpMM.

* ``banded_gat_mean_fused`` (kernel 1): counterpart of
  ``gnn_bfs_rans_tpu/kernels/banded.py::banded_gat_mean_fused`` (its
  forward ``banded_gat_mean_fused_fwd``, ``_gat_kernel`` with
  ``fuse_proj=True, mean_heads=True``, attention dropout and ``emit_z``),
  and ``banded_gat_mean_fused_wa``, the training op whose custom VJP gives
  (dW, dWa, dx).  The backward runs ``banded_bwd.banded_gat_bwd`` and
  ``banded_bwd.fold_project_bwd``.
* ``banded_gat_mean`` and ``banded_gat`` (row 4): ``banded_gat_fwd``, the
  attention on a precomputed z, with ``mean_heads=True`` (the head mean
  [N, C] of the unfused training path) or ``False`` (the concat GAT's
  per-head output [N, H·C]); their ops ``banded_gat_mean_packed`` and
  ``banded_gat_packed``, whose backward is ``banded_bwd.banded_gat_bwd``
  with the head-mean or the per-head cotangent, as in ``_gatm_vjp_bwd``
  and ``_gat_vjp_bwd``.  Kernel 1 and row 4 share ``csrc/banded_gat.cu``.
* ``banded_spmm`` (row 8): ``banded_spmm_fwd`` / ``banded_spmm``, the GCN
  and GIN aggregation ``out[t] = Σ_k A[t, k] @ x[t − k0 + k]``, kernel
  ``csrc/banded_spmm.cu``; its backward is the same kernel on
  ``transpose_band`` (``_transpose_band``), which the convs compute once
  per ``Band`` and keep (``Band.transposed``).
* ``banded_transformer_fwd`` (row 9): ``_transformer_kernel``, scaled
  dot-product attention over ``bias_noself`` with no conditioning, the
  generic ``edge`` planes or the factorised ``geo`` planes, head mean or
  concat, attention dropout on the hash stream (one draw per head), one
  entry point with flags and one autograd Function whose backward is
  ``banded_bwd.banded_transformer_bwd`` (row 10) then
  ``banded_bwd.fold_partials`` (row 7).
  ``banded_transformer_geo_mean_projgrad``: the training path of the geo
  head-mean conv, the q/k/v projections inside the op
  (``transformer_project`` on ``csrc/gemm_sm90.cuh``, qw = q·wblk formed
  from its q tiles), its backward rows 10, 7 and 6.  ``banded_transformer_geo_mean_fused`` (row 11) projects q/k/v in the
  launch (``csrc/gemm_sm90.cuh``: one wgmma launch fed by TMA in bf16),
  eval only.  Rows 9 and 11 in ``csrc/banded_transformer.cu``.

Each source's header says what bounds it on the card and how the design
answers that.  Layouts are the JAX package's: ``bias_self`` int8
``[n_tiles, T, Wcols]``, ``w`` ``[F, H·C]``, packed ``alphas`` f32
``[N, 2H]`` (src | dst), ``x`` ``[N, F]`` → ``[N, C]`` (concat: ``[N,
H·C]``) in x's dtype (float32 or bfloat16); SpMM planes ``[n_tiles, W, T, T]`` (``gcn`` f32,
``adj`` bf16).  Dropout draws from the hash stream of :mod:`.dropout`
with seed + t for tile t: the GAT's [H·T, Wcols] plane in one draw, the
Transformer's [T, Wcols] plane once per head (draw h), so masks match the
JAX package's interpret mode bit for bit.
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


def _attention_plain(bias_self, z, alphas, heads, negative_slope,
                     dropout_rate, seed, concat=False):
    """The attention on z [N, H·C] with the kernel's rounding points, dense
    over the window like the TPU kernel: masked columns get the additive
    −1e30 bias and contribute exactly 0 after the exp.  The head mean
    [N, C], or with ``concat`` every head's f32 output rounded on its own,
    [N, H·C]."""
    n_tiles, tile, width = bias_self.shape
    n, hc = z.shape
    c = hc // heads
    dt = z.dtype
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
                              dropout_rate, z.device)
        e = torch.where(keep, e * inv_keep(dropout_rate), 0.0)
    if dt == torch.bfloat16:
        e = e.to(dt).float()          # the probability plane the matmul sees
    outs = [torch.einsum("ntw,nwc->ntc", e[..., h], win_z[:, :, h].float())
            * inv[:, :, 0, h:h + 1] for h in range(heads)]
    if concat:
        return torch.stack(outs, 2).reshape(n, hc).to(dt)
    acc = outs[0]
    for o in outs[1:]:
        acc = acc + o
    return (acc * (1.0 / heads)).reshape(n, c).to(dt)


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
    """Plain PyTorch version with the kernel's rounding points.  Returns
    ``out``, or ``(out, z)`` with ``emit_z``."""
    # projection: f32 accumulate, rounded to the primal dtype
    z = (x.float() @ w.float()).to(x.dtype)
    out = _attention_plain(bias_self, z, alphas, heads, negative_slope,
                           dropout_rate, seed)
    return (out, z) if emit_z else out


def _check_attention(bias_self, alphas, like, n, hc, heads):
    """The attention kernel's conditions on the band mask and the packed α,
    for an [n, ·] operand ``like`` (x or z) and H·C = ``hc``."""
    n_tiles, tile, width = bias_self.shape
    for name, t in (("bias_self", bias_self), ("alphas", alphas),
                    ("operand", like)):
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, not {like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bias_self.dtype != torch.int8 or alphas.dtype != torch.float32:
        raise TypeError("bias_self must be int8 and alphas float32")
    if (n != n_tiles * tile or hc % heads or alphas.shape != (n, 2 * heads)
            or width < tile or (width - tile) % 2):
        raise ValueError(
            f"shape mismatch: bias_self {tuple(bias_self.shape)}, alphas "
            f"{tuple(alphas.shape)}, {n} rows, H·C {hc}, heads {heads}")
    if (hc // heads) % 4:
        raise ValueError("the attention kernel moves 4 columns per access: "
                         "C must be a multiple of 4")
    if alphas.data_ptr() % 16:
        raise ValueError("the attention kernel reads α in 16-byte accesses: "
                         "alphas must be 16-byte aligned")
    if 8 * width * 8 > 48 * 1024:
        raise ValueError(f"window width {width} exceeds the kernel's "
                         "shared-memory budget (768 columns)")


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
    _, tile, width = bias_self.shape
    n, f = x.shape
    hc = w.shape[1]
    c = hc // heads
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_attention(bias_self, alphas, x, n, hc, heads)
    if w.device != x.device or not w.is_contiguous():
        raise ValueError(f"w must be contiguous on {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x and w must share float32 or bfloat16, got "
                        f"{x.dtype} / {w.dtype}")
    if w.shape[0] != f:
        raise ValueError(f"shape mismatch: w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)}")
    per16 = 16 // x.element_size()
    if f % per16 or hc % per16 or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"the projection loads 16-byte chunks: F and H·C "
                         f"must be multiples of {per16} and x, w 16-byte "
                         f"aligned")
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
                dropout_rate, seed, mask_t):
        # the JAX package's XLA product outside its Pallas kernel
        alphas = (x.float() @ wa.float()).contiguous()
        out, z = banded_gat_mean_fused(bias_self, w, alphas, x, heads,
                                       negative_slope, dropout_rate, seed,
                                       emit_z=True)
        ctx.save_for_backward(bias_self, w, wa, alphas, x, z, seed)
        ctx.args = (heads, negative_slope, dropout_rate)
        ctx.mask_t = mask_t
        return out

    @staticmethod
    def backward(ctx, g):
        from .banded_bwd import banded_gat_bwd, fold_project_bwd

        bias_self, w, wa, alphas, x, z, seed = ctx.saved_tensors
        heads, negative_slope, dropout_rate = ctx.args
        dz, da = banded_gat_bwd(bias_self, z, alphas,
                                g.to(z.dtype).contiguous(), heads,
                                negative_slope, dropout_rate, seed,
                                mask_t=_mask_t(ctx.mask_t, bias_self))
        dx, dw = fold_project_bwd(dz, x, w)
        # the narrow α products stay plain products, as in the JAX package
        dwa = (x.float().t() @ da).to(wa.dtype)
        dx = dx + (da.to(x.dtype).float() @ wa.float().t()).to(x.dtype)
        return None, dw.to(w.dtype), dwa, dx, None, None, None, None, None


def _mask_t(mask_t, bias_self):
    """Row 5's transposed mask: the caller's (the convs pass the band's
    kept ``Band.transposed('bias_self')``), else made from ``bias_self``."""
    if mask_t is None:
        from .banded_bwd import transpose_mask
        mask_t = transpose_mask(bias_self)
    return mask_t


def banded_gat_mean_fused_wa(bias_self, w, wa, x, heads,
                             negative_slope=0.2, dropout_rate=0.0, seed=None,
                             mask_t=None):
    """Differentiable fused GAT (head mean) with α = x·wa inside the op.

    ``wa`` is the packed [F, 2H] α factor (W·amat) in x's dtype.
    ``mask_t``: ``bias_self`` transposed to [n_tiles, Wcols, T] for row 5's
    sender pass (the convs pass the band's kept
    ``Band.transposed('bias_self')``); the backward makes it when None."""
    return _GatMeanFusedWa.apply(bias_self, w, wa, x.contiguous(), heads,
                                 negative_slope, dropout_rate, seed, mask_t)


# ------------------------------------------------------------------ row 4
def banded_gat_mean_plain(bias_self, z, alphas, heads, negative_slope=0.2,
                          dropout_rate=0.0, seed=None):
    """Plain PyTorch version of :func:`banded_gat_mean`."""
    return _attention_plain(bias_self, z, alphas, heads, negative_slope,
                            dropout_rate, seed)


def banded_gat_plain(bias_self, z, alphas, heads, negative_slope=0.2,
                     dropout_rate=0.0, seed=None):
    """Plain PyTorch version of :func:`banded_gat`."""
    return _attention_plain(bias_self, z, alphas, heads, negative_slope,
                            dropout_rate, seed, concat=True)


def _gat_attention(bias_self, z, alphas, heads, negative_slope, dropout_rate,
                   seed, concat):
    """Row 4 in either form: the plain version for CPU tensors, the CUDA
    kernel (``banded_gat_launch``) for CUDA tensors (or a raise)."""
    if z.device.type == "cpu":
        return _attention_plain(bias_self, z, alphas, heads, negative_slope,
                                dropout_rate, seed, concat)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    _, tile, width = bias_self.shape
    n, hc = z.shape
    c = hc // heads
    _check_attention(bias_self, alphas, z, n, hc, heads)
    if z.dtype not in _DTYPE_CODE:
        raise TypeError(f"z must be float32 or bfloat16, got {z.dtype}")
    if z.data_ptr() % 16:
        raise ValueError("the attention kernel reads z in 4-column accesses: "
                         "z must be 16-byte aligned")
    seed = _drop.check_seed(seed, dropout_rate, z.device)
    lib = _build.bind(
        KERNEL, "banded_gat_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_uint, ctypes.c_float, ctypes.c_void_p])
    out = torch.empty((n, hc if concat else c), dtype=z.dtype,
                      device=z.device)
    rc = lib.banded_gat_launch(
        bias_self.data_ptr(), alphas.data_ptr(), z.data_ptr(), out.data_ptr(),
        n, heads, c, tile, width, negative_slope, int(concat),
        _DTYPE_CODE[z.dtype], None if seed is None else seed.data_ptr(),
        _drop.threshold(dropout_rate),
        inv_keep(dropout_rate) if seed is not None else 1.0,
        torch.cuda.current_stream(z.device).cuda_stream)
    name = "banded_gat" if concat else "banded_gat_mean"
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return out


def banded_gat_mean(bias_self: torch.Tensor, z: torch.Tensor,
                    alphas: torch.Tensor, heads: int,
                    negative_slope: float = 0.2, dropout_rate: float = 0.0,
                    seed: torch.Tensor | None = None) -> torch.Tensor:
    """Head-mean banded GAT attention on a given z [N, H·C] → [N, C] in z's
    dtype: plain version for CPU tensors, the CUDA kernel for CUDA tensors
    (or a raise).  ``seed``: [1] int32 on z's device when
    ``dropout_rate > 0``."""
    return _gat_attention(bias_self, z, alphas, heads, negative_slope,
                          dropout_rate, seed, False)


def banded_gat(bias_self: torch.Tensor, z: torch.Tensor,
               alphas: torch.Tensor, heads: int, negative_slope: float = 0.2,
               dropout_rate: float = 0.0,
               seed: torch.Tensor | None = None) -> torch.Tensor:
    """Concat banded GAT attention on a given z [N, H·C] → every head's
    output [N, H·C] in z's dtype (``banded_gat_fwd`` with
    ``mean_heads=False``): plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (or a raise).  ``seed`` as :func:`banded_gat_mean`."""
    return _gat_attention(bias_self, z, alphas, heads, negative_slope,
                          dropout_rate, seed, True)


class _GatPacked(torch.autograd.Function):
    """``banded_gat_packed`` (concat) and ``banded_gat_mean_packed``:
    cotangents (dz, dα) from ``banded_bwd.banded_gat_bwd`` on the per-head
    or the head-mean cotangent (``_gat_vjp_bwd``, ``_gatm_vjp_bwd``); the
    band and the seed get none."""

    @staticmethod
    def forward(ctx, bias_self, z, alphas, heads, negative_slope,
                dropout_rate, seed, concat, mask_t):
        ctx.save_for_backward(bias_self, z, alphas, seed)
        ctx.args = (heads, negative_slope, dropout_rate, concat)
        ctx.mask_t = mask_t
        return _gat_attention(bias_self, z, alphas, heads, negative_slope,
                              dropout_rate, seed, concat)

    @staticmethod
    def backward(ctx, g):
        from .banded_bwd import banded_gat_bwd

        bias_self, z, alphas, seed = ctx.saved_tensors
        heads, negative_slope, dropout_rate, concat = ctx.args
        dz, da = banded_gat_bwd(bias_self, z, alphas,
                                g.to(z.dtype).contiguous(), heads,
                                negative_slope, dropout_rate, seed,
                                mean_expand=not concat,
                                mask_t=_mask_t(ctx.mask_t, bias_self))
        return None, dz, da, None, None, None, None, None, None


def banded_gat_mean_packed(bias_self, z, alphas, heads, negative_slope=0.2,
                           dropout_rate=0.0, seed=None, mask_t=None):
    """Differentiable head-mean banded GAT on z [N, H·C] and the packed f32
    α [N, 2H]; the unfused training path (``fuse_train=False``).
    ``mask_t`` as :func:`banded_gat_mean_fused_wa`."""
    return _GatPacked.apply(bias_self, z.contiguous(), alphas.contiguous(),
                            heads, negative_slope, dropout_rate, seed, False,
                            mask_t)


def banded_gat_packed(bias_self, z, alphas, heads, negative_slope=0.2,
                      dropout_rate=0.0, seed=None, mask_t=None):
    """Differentiable concat banded GAT on z [N, H·C] and the packed f32 α
    [N, 2H] → [N, H·C]; the concat conv's path in eval and training.
    ``mask_t`` as :func:`banded_gat_mean_fused_wa`."""
    return _GatPacked.apply(bias_self, z.contiguous(), alphas.contiguous(),
                            heads, negative_slope, dropout_rate, seed, True,
                            mask_t)


# ------------------------------------------------------------------ row 8
def transpose_band(band: torch.Tensor) -> torch.Tensor:
    """The band plane of Aᵀ: block (t, k) is block (t − k0 + k, W − 1 − k)ᵀ
    of A, zero where that tile lies outside the band (``_transpose_band``).
    Plain torch, as the JAX package leaves it to XLA."""
    n_tiles, window = band.shape[:2]
    k0 = window // 2
    pad = band.new_zeros((k0, *band.shape[1:]))
    padded = torch.cat([pad, band, pad])
    ks = torch.arange(window, device=band.device)
    src = padded[torch.arange(n_tiles, device=band.device)[:, None] + ks,
                 window - 1 - ks]                         # [n_tiles, W, T, T]
    return src.transpose(-1, -2).contiguous()


def banded_spmm_plain(band_coeff: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the dense window product in f32 (the einsum of
    the JAX package's ``banded_spmm_ref``), rounded once to x's dtype."""
    n_tiles, window, tile, _ = band_coeff.shape
    win = _windows(x.float(), tile, window * tile)       # [n, W·T, F]
    a = band_coeff.float().transpose(1, 2).reshape(n_tiles, tile,
                                                   window * tile)
    return torch.einsum("ntw,nwf->ntf", a, win).reshape(x.shape).to(x.dtype)


def banded_spmm_fwd(band_coeff: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """out = BandMatrix(band_coeff) @ x in x's dtype: plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (or a raise)."""
    if x.device.type == "cpu":
        return banded_spmm_plain(band_coeff, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n_tiles, window, tile, tile2 = band_coeff.shape
    n, f = x.shape
    if band_coeff.device != x.device:
        raise ValueError(f"band_coeff is on {band_coeff.device}, x on "
                         f"{x.device}")
    if not (band_coeff.is_contiguous() and x.is_contiguous()):
        raise ValueError("band_coeff and x must be contiguous")
    if band_coeff.dtype not in _DTYPE_CODE or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"band_coeff and x must be float32 or bfloat16, got "
                        f"{band_coeff.dtype} / {x.dtype}")
    if n != n_tiles * tile or tile2 != tile or window % 2 == 0:
        raise ValueError(f"shape mismatch: band_coeff "
                         f"{tuple(band_coeff.shape)}, x {tuple(x.shape)}")
    if f % 4 or x.data_ptr() % 16 or tile % 4 or band_coeff.data_ptr() % 16:
        raise ValueError("the SpMM kernel moves 4 columns per access: F and "
                         "the tile must be multiples of 4, x and the plane "
                         "16-byte aligned")
    lib = _build.bind("banded_spmm", "banded_spmm_launch",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p])
    out = torch.empty_like(x)
    rc = lib.banded_spmm_launch(
        band_coeff.data_ptr(), x.data_ptr(), out.data_ptr(), n, f, tile,
        window, _DTYPE_CODE[band_coeff.dtype], _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "banded_spmm")
    _build.LAUNCHES["banded_spmm"] += 1
    return out


class _BandedSpmm(torch.autograd.Function):
    """``banded_spmm``: dx = Aᵀ·g, the same kernel on the transposed band;
    the band gets no cotangent."""

    @staticmethod
    def forward(ctx, band_coeff, x, transposed):
        ctx.save_for_backward(band_coeff)
        ctx.transposed = transposed
        return banded_spmm_fwd(band_coeff, x)

    @staticmethod
    def backward(ctx, g):
        (band_coeff,) = ctx.saved_tensors
        at = (transpose_band(band_coeff) if ctx.transposed is None
              else ctx.transposed())
        return None, banded_spmm_fwd(at, g.contiguous()), None


def banded_spmm(band_coeff: torch.Tensor, x: torch.Tensor,
                transposed=None) -> torch.Tensor:
    """Differentiable banded SpMM: ``band_coeff`` [n_tiles, W, T, T] (f32
    or bf16) times x [n_tiles·T, F] (f32 or bf16) → x's shape and dtype.

    ``transposed``: a callable that returns the plane of Aᵀ, called by the
    backward only (the convs pass ``Band.transposed``, which keeps it:
    transposing costs about four SpMMs on the card); without it the
    backward transposes per call, as the JAX package does."""
    return _BandedSpmm.apply(band_coeff, x.contiguous(), transposed)


# ------------------------------------------------------------ rows 9, 11
TRANSFORMER_KERNEL = "banded_transformer"
_MAX_C = 512    # columns per head rows 9, 10 and 11 take
_MAX_DE = 8     # edge features per edge held in the kernel's registers


def _tr_logits(bias_noself, q, k, heads, edge, qw, geo, pos):
    """The Transformer kernels' logits, dense over the window
    ([n_tiles, H, T, Wcols], masked columns at −1e30) with their rounding
    points, and the planes the geo and edge terms use (``_transformer_kernel``
    and the backward's recompute)."""
    n_tiles, tile, width = bias_noself.shape
    n, hc = q.shape
    c = hc // heads
    scale = 1.0 / (c ** 0.5)
    q4 = q.reshape(n_tiles, tile, heads, c).float()
    win_k = _windows(k, tile, width).reshape(n_tiles, width, heads, c).float()
    logits = torch.einsum("nthc,nwhc->nhtw", q4, win_k) * scale
    planes = {}
    if edge is not None:
        d_e = edge.shape[1]
        # qw_d·scale: the weakly typed scalar takes q's dtype; the product
        # stays f32 (XLA keeps the excess precision of the bf16 multiply)
        s_dt = float(torch.tensor(scale, dtype=q.dtype))
        qs = qw.reshape(n_tiles, tile, heads, d_e).float() * s_dt
        for d in range(d_e):
            logits = logits + _by_head(qs[..., d]) * edge[:, d, None]
    logits = logits + ((bias_noself.float() - 1.0) * 1e30)[:, None]
    if geo is not None:
        qd = qw.reshape(n_tiles, tile, heads, 4).float() * scale
        pos_c = pos.reshape(n_tiles, tile, 4)
        pos_w = _windows(pos, tile, width)                     # [n, Wc, 4]
        qself = (qd * pos_c[:, :, None, :]).sum(-1)            # [n, T, H]
        qpos = torch.einsum("nthd,nwd->nhtw", qd, pos_w)
        dist, invd = geo[:, 0, None], geo[:, 1, None]         # [n, 1, T, Wc]
        logits = logits + (_by_head(qself) - qpos) * invd \
            + _by_head(qd[..., 3]) * dist
        planes = dict(pos_c=pos_c, pos_w=pos_w, dist=dist, invd=invd)
    return logits, planes


def _by_head(a):
    """[n, T, H] → [n, H, T, 1]."""
    return a.permute(0, 2, 1)[..., None]


def _softmax_parts(logits):
    """e (0 on masked columns) and inv = 1/max(Σe, 1e-16) of the kernels."""
    m = logits.amax(-1, keepdim=True).clamp_min(-1e30)
    e = torch.exp(logits - m)
    e = torch.where(logits <= -1e29, 0.0, e)
    return e, 1.0 / e.sum(-1, keepdim=True).clamp_min(1e-16)


def _tr_keep(seed, bias_noself, heads, rate):
    """The attention dropout's [n_tiles, H, T, Wcols] keep mask."""
    n_tiles, tile, width = bias_noself.shape
    return _drop.transformer_keep(seed.long(), n_tiles, tile, width, heads,
                                  rate, bias_noself.device)


def banded_transformer_fwd_plain(bias_noself, q, k, v, heads, edge=None,
                                 qw=None, geo=None, pos=None,
                                 mean_heads=False, dropout_rate=0.0,
                                 seed=None):
    """Plain PyTorch version of row 9, dense over the window like the TPU
    kernel (``_transformer_kernel``), with its rounding points: the scale
    is the Python float 1/√C; the edge term adds ``(qw_d·scale_q)·feat_d``
    with ``scale_q`` the scale in q's dtype and the product in f32, the geo
    term casts qw to f32 before scaling; the denominator is taken before
    the dropout, whose dropped e (per-head draws of the hash stream) feeds
    the value product and ``s``; the probabilities round to v's dtype for
    the value product, ``s`` sums the unrounded f32 e.  Returns ``out``
    ([N, C] with ``mean_heads``, else [N, H·C], in q's dtype), or
    ``(out, s)`` with ``s`` f32 [N, H·D_e] when conditioned (D_e = 4 for
    geo)."""
    n_tiles, tile, width = bias_noself.shape
    n, hc = q.shape
    c = hc // heads
    dt = q.dtype
    logits, planes = _tr_logits(bias_noself, q, k, heads, edge, qw, geo, pos)
    e, inv = _softmax_parts(logits)                           # inv [n, H, T, 1]
    if dropout_rate > 0:
        keep = _tr_keep(seed, bias_noself, heads, dropout_rate)
        e = torch.where(keep, e * inv_keep(dropout_rate), 0.0)
    win_v = _windows(v, tile, width).reshape(n_tiles, width, heads, c)
    ep = e.to(dt).float() if dt == torch.bfloat16 else e
    outs = [torch.einsum("ntw,nwc->ntc", ep[:, h], win_v[:, :, h].float())
            * inv[:, h] for h in range(heads)]
    if mean_heads:
        acc = outs[0]
        for o in outs[1:]:
            acc = acc + o
        out = (acc * (1.0 / heads)).reshape(n, c).to(dt)
    else:
        out = torch.stack(outs, 2).reshape(n, hc).to(dt)
    if geo is not None:
        pos_c, pos_w = planes["pos_c"], planes["pos_w"]
        ew = e * planes["invd"]
        t13 = torch.einsum("nhtw,nwd->nthd", ew, pos_w)
        t0 = ew.sum(-1).permute(0, 2, 1)[..., None]            # [n, T, H, 1]
        s3 = (e * planes["dist"]).sum(-1).permute(0, 2, 1)[..., None]
        s = torch.cat([(pos_c[:, :, None, :] * t0 - t13)[..., :3], s3], -1)
        s = s * inv.permute(0, 2, 1, 3)
        return out, s.reshape(n, heads * 4)
    if edge is not None:
        s = torch.stack([(e * edge[:, d, None]).sum(-1) * inv[..., 0]
                         for d in range(edge.shape[1])], -1)   # [n, H, T, D]
        return out, s.permute(0, 2, 1, 3).reshape(n, -1)
    return out


def _check_window(bias_noself, n, hc, heads):
    """The mask's and the head width's conditions, shared by rows 9, 10 and
    11; returns C."""
    n_tiles, tile, width = bias_noself.shape
    if bias_noself.dtype != torch.int8:
        raise TypeError("bias_noself must be int8")
    if n != n_tiles * tile or hc % heads or width < tile or (width - tile) % 2:
        raise ValueError(f"shape mismatch: bias_noself "
                         f"{tuple(bias_noself.shape)}, N {n}, H·C {hc}, "
                         f"heads {heads}")
    c = hc // heads
    if c % 4 or c > _MAX_C:
        raise ValueError(f"the kernel moves 4 columns per access and holds "
                         f"{_MAX_C} per head: C {c} must be a multiple of 4 "
                         f"and at most {_MAX_C}")
    if 8 * width * 8 > 48 * 1024:
        raise ValueError(f"window width {width} exceeds the kernel's "
                         "shared-memory budget (768 columns)")
    return c


def _check_transformer(bias_noself, q, k, v, heads, extra=()):
    """Rows 9 and 10's conditions on the mask and q/k/v (and the f32
    ``extra`` planes); returns (C, the row stride q, k and v share: they
    may be column blocks of one q | k | v buffer)."""
    for name, t in (("bias_noself", bias_noself), *extra):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, not {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, not {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype} / {k.dtype} / {v.dtype}")
    for name, t in extra:
        if name not in ("qw", "g") and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    ld = q.stride(0)
    if any(t.stride() != (ld, 1) for t in (q, k, v)) or ld < q.shape[1]:
        raise ValueError("q, k and v must be row-major with one row stride")
    if any(t.data_ptr() % 16 for t in (q, k, v)) or ld % 4:
        raise ValueError("the kernel reads q, k and v in 4-column accesses: "
                         "they must be 16-byte aligned")
    return _check_window(bias_noself, *q.shape, heads), ld


def _conditioning(edge, qw, geo, pos, q, heads, tile, width):
    """(mode, D_e, the conditioning plane, the planes to check) of rows 9
    and 10, with their shape checks."""
    n = q.shape[0]
    if geo is not None:
        mode, d_e, feat = 2, 4, geo
        extra = (("geo", geo), ("pos", pos), ("qw", qw))
    elif edge is not None:
        mode, d_e, feat = 1, edge.shape[1], edge
        extra = (("edge", edge), ("qw", qw))
    else:
        return 0, 0, None, ()
    if qw.dtype != q.dtype or qw.shape != (n, heads * d_e):
        raise ValueError(f"qw must be [{n}, {heads * d_e}] in q's dtype, "
                         f"got {tuple(qw.shape)} {qw.dtype}")
    if feat.shape != (n // tile, d_e if mode == 1 else 2, tile, width):
        raise ValueError(f"edge/geo plane shape {tuple(feat.shape)}")
    if mode == 1 and d_e > _MAX_DE:
        raise ValueError(f"at most {_MAX_DE} edge features, got {d_e}")
    if mode == 2 and pos.shape != (n, 4):
        raise ValueError(f"pos must be [{n}, 4], got {tuple(pos.shape)}")
    return mode, d_e, feat, extra


def _ptr(t):
    return None if t is None else t.data_ptr()


def _transformer_fwd(bias_noself, q, k, v, heads, edge=None, qw=None,
                     geo=None, pos=None, mean_heads=False, dropout_rate=0.0,
                     seed=None):
    """Row 9 without its gradient: plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (or a raise)."""
    if q.device.type == "cpu":
        return banded_transformer_fwd_plain(bias_noself, q, k, v, heads, edge,
                                            qw, geo, pos, mean_heads,
                                            dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    n, hc = q.shape
    n_tiles, tile, width = bias_noself.shape
    mode, d_e, feat, extra = _conditioning(edge, qw, geo, pos, q, heads, tile,
                                           width)
    c, ld = _check_transformer(bias_noself, q, k, v, heads, extra)
    seed = _drop.check_seed(seed, dropout_rate, q.device)
    lib = _build.bind(TRANSFORMER_KERNEL, "banded_transformer_launch",
                      [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                      + [ctypes.c_float, ctypes.c_void_p, ctypes.c_uint,
                         ctypes.c_float, ctypes.c_void_p])
    out = torch.empty((n, c if mean_heads else hc), dtype=q.dtype,
                      device=q.device)
    s = (torch.empty((n, heads * d_e), dtype=torch.float32, device=q.device)
         if mode else None)
    rc = lib.banded_transformer_launch(
        bias_noself.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(feat), _ptr(pos if mode == 2 else None),
        _ptr(qw if mode else None), out.data_ptr(), _ptr(s), n, ld, heads, c,
        tile, width, mode, d_e, int(mean_heads), _DTYPE_CODE[q.dtype],
        1.0 / (c ** 0.5), _ptr(seed), _drop.threshold(dropout_rate),
        inv_keep(dropout_rate) if seed is not None else 1.0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "banded_transformer_fwd")
    _build.LAUNCHES["banded_transformer_fwd"] += 1
    return (out, s) if mode else out


class _Transformer(torch.autograd.Function):
    """Row 9 with its backward: row 10 (``banded_bwd.banded_transformer_bwd``)
    then row 7 (``banded_bwd.fold_partials``) on the dk/dv partials, as the
    JAX package's ``_tr*_vjp_bwd`` do.  Cotangents (dq, dk, dv, dqw); the
    mask, the planes and the seed get none."""

    @staticmethod
    def forward(ctx, bias_noself, q, k, v, qw, edge, geo, pos, heads,
                mean_heads, dropout_rate, seed):
        ctx.save_for_backward(bias_noself, q, k, v, qw, edge, geo, pos, seed)
        ctx.args = (heads, mean_heads, dropout_rate)
        return _transformer_fwd(bias_noself, q, k, v, heads, edge, qw, geo,
                                pos, mean_heads, dropout_rate, seed)

    @staticmethod
    def backward(ctx, g, gs=None):
        from .banded_bwd import banded_transformer_bwd, fold_partials

        bias_noself, q, k, v, qw, edge, geo, pos, seed = ctx.saved_tensors
        heads, mean_heads, dropout_rate = ctx.args
        res = banded_transformer_bwd(
            bias_noself, q, k, v, g.to(q.dtype).contiguous(), heads, edge=edge,
            qw=qw, gs=None if gs is None else gs.float().contiguous(),
            geo=geo, pos=pos, mean_expand=mean_heads,
            dropout_rate=dropout_rate, seed=seed)
        tile = bias_noself.shape[1]
        dk = fold_partials(res[1], tile)
        dv = fold_partials(res[2], tile)
        dqw = res[3].to(qw.dtype) if len(res) > 3 else None
        return (None, res[0], dk, dv, dqw, None, None, None, None, None, None,
                None)


def banded_transformer_fwd(bias_noself, q, k, v, heads, edge=None, qw=None,
                           geo=None, pos=None, mean_heads=False,
                           dropout_rate=0.0, seed=None):
    """Row 9, differentiable (its backward: rows 10 and 7): scaled
    dot-product attention of q over the senders of each row of
    ``bias_noself`` [n_tiles, T, Wcols] (no conditioning, the generic
    ``edge`` planes with ``qw`` [N, H·D_e], or the factorised ``geo``
    planes with ``pos`` and ``qw`` [N, H·4]), head mean or concat, with
    attention dropout at ``dropout_rate`` masked from ``seed`` ([1] int32 on
    q's device).  Plain version for CPU tensors, the CUDA kernels for CUDA
    tensors (or a raise).  Returns as :func:`banded_transformer_fwd_plain`."""
    return _Transformer.apply(bias_noself, q, k, v, qw, edge, geo, pos, heads,
                              mean_heads, dropout_rate, seed)


def _qw_plain(q, wblk, heads):
    """q·wblk over wblk's diagonal head blocks only, f32 accumulate:
    qw[:, 4h + d] = q_h·wblk[hC:(h + 1)C, 4h + d] (what the kernels read;
    the block-diagonal wblk the conv builds gives q·wblk)."""
    c = q.shape[1] // heads
    blocks = wblk.float().reshape(heads, c, heads, 4).diagonal(0, 0, 2)
    return torch.einsum("nhc,cdh->nhd", q.float().reshape(-1, heads, c),
                        blocks).reshape(-1, heads * 4)


def transformer_project_plain(x, wq, wk, wv, bq, bk, bv, wblk):
    """Plain PyTorch version of :func:`transformer_project`."""
    qkv = torch.cat([(x.float() @ w.float() + b.float()).to(x.dtype)
                     for w, b in ((wq, bq), (wk, bk), (wv, bv))], 1)
    heads = wblk.shape[1] // 4
    return qkv, _qw_plain(qkv[:, :wq.shape[1]], wblk, heads).to(x.dtype)


def transformer_project(x, wq, wk, wv, bq, bk, bv, wblk):
    """The q/k/v projection of ``banded_transformer_geo_mean_projgrad``:
    (qkv [N, 3·H·C] = x·[Wq | Wk | Wv] + [bq | bk | bv], f32 accumulate, the
    bias added in f32, one rounding to x's dtype; qw = q·wblk [N, H·4] over
    wblk's diagonal head blocks, f32 accumulate, rounded to x's dtype).
    ``wq``, ``wk``, ``wv`` [F, H·C], ``bq``, ``bk``, ``bv`` [H·C] and
    ``wblk`` [H·C, H·4] in x's dtype; wblk's off-diagonal blocks are not
    read (the conv's wblk is block-diagonal).  Plain version for CPU
    tensors; on the card row 11's projection launch
    (``csrc/gemm_sm90.cuh``), qw formed in its q tiles' epilogue (bf16, C a
    multiple of 16 dividing 256) or by a kernel over the written q."""
    if x.device.type == "cpu":
        return transformer_project_plain(x, wq, wk, wv, bq, bk, bv, wblk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, f = x.shape
    hc = wq.shape[1]
    heads = wblk.shape[1] // 4
    named = (("x", x), ("wq", wq), ("wk", wk), ("wv", wv), ("bq", bq),
             ("bk", bk), ("bv", bv), ("wblk", wblk))
    for name, t in named:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
        if t.dtype != x.dtype or x.dtype not in _DTYPE_CODE:
            raise TypeError("x, the weights, the biases and wblk must share "
                            "float32 or bfloat16")
    if (any(w.shape != (f, hc) for w in (wq, wk, wv))
            or any(b.shape != (hc,) for b in (bq, bk, bv))
            or heads < 1 or hc % heads or wblk.shape != (hc, 4 * heads)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(wq.shape)}, wblk {tuple(wblk.shape)}")
    vec = 16 // x.element_size()
    if any(t.data_ptr() % 16 for _, t in named) or f % vec or hc % vec:
        raise ValueError(f"the projection loads 16-byte rows: F and H·C "
                         f"must be multiples of {vec} and every input "
                         f"16-byte aligned")
    qkv = torch.empty((n, 3 * hc), dtype=x.dtype, device=x.device)
    qw = torch.empty((n, 4 * heads), dtype=x.dtype, device=x.device)
    lib = _build.bind(TRANSFORMER_KERNEL, "transformer_project_launch",
                      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
    rc = lib.transformer_project_launch(
        *(t.data_ptr() for _, t in named), qkv.data_ptr(), qw.data_ptr(), n,
        f, heads, hc // heads, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "transformer_project")
    _build.LAUNCHES["transformer_project"] += 1
    return qkv, qw


class _TransformerProjgrad(torch.autograd.Function):
    """``banded_transformer_geo_mean_projgrad``: the q/k/v projections
    inside the op.  The forward projects q/k/v and qw (rounded once, as the
    JAX op forms them) and runs row 9; the backward runs row 10, row 6 on
    the wblk products (dq + dqw·wblkᵀ, dwblk = qᵀ·dqw), row 7 folding the
    dk/dv partials beside dq into one [N, 3·H·C] cotangent, and row 6's
    bias form on it against [Wq | Wk | Wv]: dx summed and all three dW and
    db in one launch.  The JAX package's carry-based in-kernel projection
    mode is not carried over (the decision recorded in ROADMAP.md)."""

    @staticmethod
    def forward(ctx, bias_noself, geo, pos, x, wq, wk, wv, bq, bk, bv, wblk,
                heads, dropout_rate, seed):
        hc = wq.shape[1]
        qkv, qw = transformer_project(x, wq, wk, wv, bq, bk, bv, wblk)
        out, s = _transformer_fwd(bias_noself, qkv[:, :hc], qkv[:, hc:2 * hc],
                                  qkv[:, 2 * hc:], heads, qw=qw, geo=geo,
                                  pos=pos, mean_heads=True,
                                  dropout_rate=dropout_rate, seed=seed)
        ctx.save_for_backward(bias_noself, geo, pos, x, wq, wk, wv, qkv, qw,
                              wblk, seed)
        ctx.args = (heads, dropout_rate, wq.dtype, bq.dtype)
        return out, s

    @staticmethod
    def backward(ctx, g, gs):
        from .banded_bwd import (banded_transformer_bwd, fold_partials,
                                 fold_project_bwd)

        (bias_noself, geo, pos, x, wq, wk, wv, qkv, qw, wblk,
         seed) = ctx.saved_tensors
        heads, dropout_rate, w_dt, b_dt = ctx.args
        hc = wq.shape[1]
        q, k, v = qkv[:, :hc], qkv[:, hc:2 * hc], qkv[:, 2 * hc:]
        dq, dk_part, dv_part, dqw = banded_transformer_bwd(
            bias_noself, q, k, v, g.to(q.dtype).contiguous(), heads, qw=qw,
            gs=gs.float().contiguous(), geo=geo, pos=pos, mean_expand=True,
            dropout_rate=dropout_rate, seed=seed)
        # q's cotangent from qw = q·wblk, in q's dtype, and dwblk = qᵀ·dqw
        dq_w, dwblk = fold_project_bwd(dqw.to(q.dtype), q, wblk)
        dz = torch.empty((x.shape[0], 3 * hc), dtype=q.dtype,
                         device=q.device)
        torch.add(dq, dq_w, out=dz[:, :hc])
        tile = bias_noself.shape[1]
        fold_partials(dk_part, tile, out=dz[:, hc:2 * hc])
        fold_partials(dv_part, tile, out=dz[:, 2 * hc:])
        dx, dw, db = fold_project_bwd(dz, x, torch.cat([wq, wk, wv], 1),
                                      with_bias=True)
        cols = [slice(i * hc, (i + 1) * hc) for i in range(3)]
        return (None, None, None, dx, *(dw[:, c].to(w_dt) for c in cols),
                *(db[c].to(b_dt) for c in cols), dwblk.to(wblk.dtype), None,
                None, None)


def banded_transformer_geo_mean_projgrad(bias_noself, geo, pos, x, wq, wk,
                                         wv, bq, bk, bv, wblk, heads,
                                         dropout_rate=0.0, seed=None):
    """The geo head-mean Transformer with the q/k/v projections inside the
    op (the JAX package's op of that name) → (out [N, C], s [N, H·4]).
    ``wq``, ``wk``, ``wv`` [F, H·C], ``bq``, ``bk``, ``bv`` [H·C] and the
    block-diagonal ``wblk`` [H·C, H·4] in x's dtype (the forward reads its
    diagonal head blocks only; the backward is the JAX op's, dwblk = qᵀ·dqw
    in full); attention dropout at ``dropout_rate`` from ``seed``.
    Differentiable in x, the weights, the biases and wblk."""
    return _TransformerProjgrad.apply(bias_noself, geo, pos, x.contiguous(),
                                      wq, wk, wv, bq, bk, bv,
                                      wblk.contiguous(), heads, dropout_rate,
                                      seed)


def banded_transformer_geo_mean_fused_plain(bias_noself, geo_band, pos, x,
                                            wq, wk, wv, bq, bk, bv, wblk,
                                            heads):
    """Plain PyTorch version of row 11: q/k/v = x·W + b (f32 accumulate,
    the bias in x's dtype added in f32, one rounding to x's dtype), qw =
    q·wblk over wblk's diagonal head blocks kept in f32, then row 9's
    geo-mean attention."""
    dt = x.dtype
    q, k, v = ((x.float() @ w.float() + b.float()).to(dt)
               for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    qw = _qw_plain(q, wblk, heads)
    return banded_transformer_fwd_plain(bias_noself, q, k, v, heads, qw=qw,
                                        geo=geo_band, pos=pos,
                                        mean_heads=True)


def banded_transformer_geo_mean_fused(bias_noself, geo_band, pos, x, wq, wk,
                                      wv, bq, bk, bv, wblk, heads):
    """Row 11: row 9's geo head-mean form with the q/k/v (and
    qw = q·wblk) projections in the launch → (out [N, C], s [N, H·4]).
    ``wq``, ``wk``, ``wv`` [F, H·C], ``bq``, ``bk``, ``bv`` [H·C] and
    ``wblk`` [H·C, H·4] in x's dtype (only its diagonal head blocks are
    read, as by :func:`transformer_project`).  Plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (or a raise)."""
    args = (bias_noself, geo_band, pos, x, wq, wk, wv, bq, bk, bv, wblk,
            heads)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wq, wk, wv, bq, bk, bv, wblk)):
        raise NotImplementedError(
            "banded_transformer_geo_mean_fused is an eval form (the JAX "
            "package gives it no gradient or dropout): training takes "
            "banded_transformer_geo_mean_projgrad")
    if x.device.type == "cpu":
        return banded_transformer_geo_mean_fused_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, f = x.shape
    hc = wq.shape[1]
    n_tiles, tile, width = bias_noself.shape
    named = (("bias_noself", bias_noself), ("geo", geo_band), ("pos", pos),
             ("wq", wq), ("wk", wk), ("wv", wv), ("bq", bq), ("bk", bk),
             ("bv", bv), ("wblk", wblk), ("x", x))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, not {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if geo_band.dtype != torch.float32 or pos.dtype != torch.float32:
        raise TypeError("geo and pos must be float32")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype
                                         for _, t in named[3:]):
        raise TypeError("x, the weights and the biases must share float32 "
                        "or bfloat16")
    c = _check_window(bias_noself, n, hc, heads)
    if (any(w.shape != (f, hc) for w in (wq, wk, wv))
            or any(b.shape != (hc,) for b in (bq, bk, bv))
            or wblk.shape != (hc, heads * 4)
            or geo_band.shape != (n_tiles, 2, tile, width)
            or pos.shape != (n, 4)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(wq.shape)}, wblk {tuple(wblk.shape)}, geo "
                         f"{tuple(geo_band.shape)}, pos {tuple(pos.shape)}, "
                         f"heads {heads}")
    vec = 16 // x.element_size()
    if any(t.data_ptr() % 16 for t in (x, wq, wk, wv, bq, bk, bv, wblk)) \
            or f % vec or hc % vec:
        raise ValueError(f"the projection loads 16-byte rows: F and H·C "
                         f"must be multiples of {vec} and x, the weights "
                         f"and the biases 16-byte aligned")
    # the projections land in one [N, 3·H·C] buffer, q | k | v per row
    qkv = torch.empty((n, 3 * hc), dtype=x.dtype, device=x.device)
    lib = _build.bind(TRANSFORMER_KERNEL,
                      "banded_transformer_geo_mean_fused_launch",
                      [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
                      + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty((n, c), dtype=x.dtype, device=x.device)
    s = torch.empty((n, heads * 4), dtype=torch.float32, device=x.device)
    rc = lib.banded_transformer_geo_mean_fused_launch(
        bias_noself.data_ptr(), x.data_ptr(), wq.data_ptr(), wk.data_ptr(),
        wv.data_ptr(), bq.data_ptr(), bk.data_ptr(), bv.data_ptr(),
        wblk.data_ptr(), geo_band.data_ptr(), pos.data_ptr(), qkv.data_ptr(),
        out.data_ptr(), s.data_ptr(), n, f, heads, c, tile, width,
        _DTYPE_CODE[x.dtype], 1.0 / (c ** 0.5),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "banded_transformer_geo_mean_fused")
    _build.LAUNCHES["banded_transformer_geo_mean_fused"] += 1
    return out, s
