"""The banded backward kernels (rows 5, 6, 7 and 10) and their plain
versions.

* ``banded_gat_bwd`` (row 5) replaces ``gnn_bfs_rans_tpu/kernels/
  banded_bwd.py::banded_gat_bwd`` with ``mean_expand`` True (the head-mean
  cotangent [N, C]) and False (the concat output's per-head cotangent
  [N, H·C]): softmax recompute, dropout replay, softmax VJP → dz [N, H·C]
  in z's dtype and the packed dα [N, 2H] f32.  Kernel:
  ``csrc/banded_gat_bwd.cu``.  The TPU kernel emits per-window dz partials
  for ``fold_project_bwd`` to fold; the CUDA kernel's receiver pass stores
  round(ẽ) and round(dpre) at the mask's nonzeros and its sender pass sums
  them into each sender's dz row and dα_src (through the transposed mask,
  ``transpose_mask``, which the band keeps), with one rounding instead of
  two (a few bf16 ulps apart in bf16).  It is the backward of kernel 1's op
  and of both row-4 ops (``banded_gat_mean_packed`` and
  ``banded_gat_packed``, the JAX package's ``_gatm_vjp_bwd`` and
  ``_gat_vjp_bwd``).
* ``fold_project_bwd`` (row 6) replaces ``banded_bwd.py::fold_project_bwd``
  (``with_bias`` False and True): dx = dz·Wᵀ in x's dtype, dW = xᵀ·dz and
  db = Σ_rows dz in f32, all in the kernel's own body.  Kernel:
  ``csrc/fold_project_bwd.cu``.  Here it takes dz rows (the GAT's from
  row 5, the Transformer's folded by row 7).
* ``banded_transformer_bwd`` (row 10) replaces ``banded_bwd.py::
  banded_transformer_bwd`` in its partials mode (``raw_kv_partials``):
  dq [N, H·C] in q's dtype, the dk/dv window partials [n_tiles, W_sub,
  sub, H·C] in k's / v's dtype and dqw [N, H·D_e] f32, every conditioning
  (none, edge, geo), head-mean or concat cotangent, with or without the
  cotangent of s, dropout replayed.  Kernel:
  ``csrc/banded_transformer_bwd.cu``.
* ``fold_partials`` (row 7) replaces ``banded_bwd.py::fold_partials``: the
  window partials folded into [N, F] rows (``combine_partials`` is its
  plain version).  Kernel: ``csrc/fold_partials.cu``.

The port runs one backward at every size; the TPU package's carry-based
modes (the GAT's direct-dz ``project_x``/``alpha_wa`` above 64 MB of dz,
the Transformer's in-kernel projection at H·C ≥ 128) are not carried over.
"""

from __future__ import annotations

import ctypes
import functools
import heapq

import torch

from . import _build
from . import dropout as _drop
from .banded import (_DTYPE_CODE, _by_head, _check_transformer,
                     _conditioning, _ptr, _softmax_parts, _tr_keep,
                     _tr_logits, _windows, attention_keep, inv_keep)


# the H100's shared memory per block (227 KB)
_SMEM_MAX = 227 * 1024


def _mm_round(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The TPU kernels' bf16 rounding point of a matmul operand."""
    return v.to(dt).float() if dt == torch.bfloat16 else v


def _gat_bwd_rows_plain(bias_self, z, alphas, g, heads, negative_slope=0.2,
                        dropout_rate=0.0, seed=None, mean_expand=True):
    """Row 5's receiver pass in plain PyTorch, dense over the window like
    the TPU kernel (masked entries contribute exactly 0), with its rounding
    points.  Returns (dα_dst [N, H] f32, round(ẽ), round(dpre), G' =
    round(gout·inv) [n_tiles, T, H, C]): the two planes [n_tiles, T, Wcols,
    H] (0 off the mask) the sender pass sums."""
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
    if mean_expand:        # every head receives g/H
        gout = (g.float().reshape(n_tiles, tile, 1, c) * (1.0 / heads)
                ).expand(n_tiles, tile, heads, c)
    else:                  # head h reads its own columns of g
        gout = g.float().reshape(n_tiles, tile, heads, c)
    dp = torch.einsum("nthc,nwhc->ntwh", _mm_round(gout, dt), win_z)
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
    g_s = _mm_round(gout * inv[:, :, 0, :, None], dt)         # [n, T, H, C]
    return dad, _mm_round(e_d, dt), _mm_round(dpre, dt), g_s


def _fold_windows(win, tile):
    """[n_tiles, Wcols, F] window rows → [N, F] sender rows (f32 sums);
    window rows outside [0, N) go to a spare row N that is dropped (no
    data-dependent shapes: no host sync)."""
    n_tiles, width, feat = win.shape
    n = n_tiles * tile
    pad = (width - tile) // 2
    rows = (torch.arange(n_tiles, device=win.device)[:, None] * tile - pad
            + torch.arange(width, device=win.device)[None, :]).reshape(-1)
    rows = torch.where((rows >= 0) & (rows < n), rows, n)
    out = torch.zeros(n + 1, feat, dtype=torch.float32, device=win.device)
    out.index_add_(0, rows, win.reshape(-1, feat))
    return out[:n]


def banded_gat_bwd_plain(bias_self, z, alphas, g, heads, negative_slope=0.2,
                         dropout_rate=0.0, seed=None, mean_expand=True):
    """Plain PyTorch version with the kernel's rounding points: the receiver
    pass (``_gat_bwd_rows_plain``), then each sender's dα_src and dz summed
    in f32 over every receiver of its window columns, dz rounded once."""
    n_tiles, tile, width = bias_self.shape
    n, hc = z.shape
    dad, ed_r, dpre_r, g_s = _gat_bwd_rows_plain(
        bias_self, z, alphas, g, heads, negative_slope, dropout_rate, seed,
        mean_expand)
    dz_win = torch.einsum("ntwh,nthc->nwhc", ed_r, g_s)
    dz = _fold_windows(dz_win.reshape(n_tiles, width, hc), tile)
    das = _fold_windows(dpre_r.sum(dim=1), tile)
    return dz.to(z.dtype), torch.cat([das, dad], dim=1)


def transpose_mask(bias_self: torch.Tensor) -> torch.Tensor:
    """The int8 attention mask [n_tiles, T, Wcols] transposed to
    [n_tiles, Wcols, T]: row 5's sender pass reads a window column's
    receivers contiguously.  ``Band.transposed('bias_self')`` keeps it."""
    return bias_self.transpose(1, 2).contiguous()


def banded_gat_bwd(bias_self, z, alphas, g, heads, negative_slope=0.2,
                   dropout_rate=0.0, seed=None, mean_expand=True, *,
                   mask_t):
    """(dz, dα) of the banded GAT given z (the forward's projection), the
    packed f32 α and the output cotangent ``g`` in z's dtype: [N, C] of the
    head mean (``mean_expand``) or [N, H·C] of the concat output.
    ``mask_t`` must be ``transpose_mask(bias_self)`` (the band's kept
    ``Band.transposed('bias_self')``): the sender pass reads the receiver
    pass's scratch wherever ``mask_t`` is 1, and the receiver pass writes it
    only where ``bias_self`` is 1, so any other mask sums unwritten memory
    (only its shape and dtype are checked).  CPU tensors take the plain
    version (``mask_t`` unread), CUDA tensors the kernel."""
    if z.device.type == "cpu":
        return banded_gat_bwd_plain(bias_self, z, alphas, g, heads,
                                    negative_slope, dropout_rate, seed,
                                    mean_expand)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    n_tiles, tile, width = bias_self.shape
    n, hc = z.shape
    c = hc // heads
    for name, t in (("bias_self", bias_self), ("mask_t", mask_t),
                    ("alphas", alphas), ("g", g)):
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")
    if z.dtype not in _DTYPE_CODE or g.dtype != z.dtype:
        raise TypeError(f"z and g must share float32 or bfloat16, got "
                        f"{z.dtype} / {g.dtype}")
    if (bias_self.dtype != torch.int8 or mask_t.dtype != torch.int8
            or alphas.dtype != torch.float32):
        raise TypeError("bias_self and mask_t must be int8 and alphas "
                        "float32")
    if (n != n_tiles * tile or hc != heads * c
            or g.shape != (n, c if mean_expand else hc)
            or alphas.shape != (n, 2 * heads) or width < tile
            or (width - tile) % 2 or mask_t.shape != (n_tiles, width, tile)):
        raise ValueError(f"shape mismatch: bias_self {tuple(bias_self.shape)}, "
                         f"mask_t {tuple(mask_t.shape)}, z {tuple(z.shape)}, "
                         f"alphas {tuple(alphas.shape)}, g {tuple(g.shape)}, "
                         f"heads {heads}")
    if c % 4 or z.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError(f"the passes move 4 columns or more per access: C "
                         f"must be a multiple of 4 and z, g 16-byte aligned "
                         f"(C {c})")
    if width % 4 or tile % 4 or width > 768 or tile > 256:
        raise ValueError(f"the passes read the mask in 4-byte words: Wcols "
                         f"(≤ 768) and T (≤ 256) must be multiples of 4, "
                         f"got {width} and {tile}")
    if 4 * (2 + heads) * width * 4 > _SMEM_MAX:
        raise ValueError(f"window width {width} at {heads} heads exceeds "
                         "the receiver pass's shared-memory budget")
    seed = _drop.check_seed(seed, dropout_rate, z.device)
    lib = _build.bind("banded_gat_bwd", "banded_gat_bwd_launch",
                      [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
                         ctypes.c_void_p])
    # scratch: 1/denominator per (row, head), and the receiver pass's
    # (round(ẽ), round(dpre)) pairs, written and read only at the nonzeros
    inv = torch.empty((n, heads), dtype=torch.float32, device=z.device)
    plane = torch.empty((n_tiles, width, tile, heads, 2), dtype=z.dtype,
                        device=z.device)
    dz = torch.empty_like(z)
    da = torch.empty((n, 2 * heads), dtype=torch.float32, device=z.device)
    rc = lib.banded_gat_bwd_launch(
        bias_self.data_ptr(), mask_t.data_ptr(), alphas.data_ptr(),
        z.data_ptr(), g.data_ptr(), inv.data_ptr(), plane.data_ptr(),
        dz.data_ptr(), da.data_ptr(), n, heads, c, tile, width,
        negative_slope, int(mean_expand), _DTYPE_CODE[z.dtype],
        None if seed is None else seed.data_ptr(),
        _drop.threshold(dropout_rate),
        inv_keep(dropout_rate) if seed is not None else 1.0,
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(lib, rc, "banded_gat_bwd")
    _build.LAUNCHES["banded_gat_bwd"] += 1
    return dz, da


def fold_project_bwd_plain(dz, x, w, with_bias=False):
    """(dx, dW[, db]): dx = dz·Wᵀ rounded to x's dtype, dW = xᵀ·dz and
    db = Σ_rows dz in f32."""
    dx = (dz.float() @ w.float().t()).to(x.dtype)
    dw = x.float().t() @ dz.float()
    return (dx, dw, dz.float().sum(0)) if with_bias else (dx, dw)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# the f32 dW slices of one call stay within a third of the H100's 50 MB L2
# (written by the products, read back by the fold)
_SLICE_BYTES = 16 << 20
# half the H100's 50 MB L2: a bf16 dz at least this large is read once by
# the dx product (tiles of 256 columns), a smaller one twice (128 columns,
# the second read from L2)
_DZ_ONCE_BYTES = 25 << 20


def _tiles(bf16: bool, n: int, hc: int):
    """Row 6's tiles (rows, columns, K step) of the dx and dW products and
    the operands' element size, as ``csrc/gemm_sm90.cuh`` defines them:
    bf16 dx 128 × 256 × 64 (dz of at least ``_DZ_ONCE_BYTES``) or
    128 × 128 × 64 and dW 256 × 128 × 64 (H·C a multiple of 64), else the
    narrow forms dx 128 × 256 × 16 and dW 256 × 16 × 64; f32 128 × 128 × 16
    for both."""
    if not bf16:
        return (128, 128, 16), (128, 128, 16), 4
    if hc % 64 == 0:
        cols = 256 if 2 * n * hc >= _DZ_ONCE_BYTES else 128
        return (128, cols, 64), (256, 128, 64), 2
    return (128, 256, 16), (256, 16, 64), 2


def _in_rounds(costs, grid):
    """The items, costliest first, dealt to the blocks in rounds: forward
    in even rounds, backward in odd ones."""
    order = sorted(range(len(costs)), key=lambda i: (-costs[i], i))
    lists = [[] for _ in range(grid)]
    for k, i in enumerate(order):
        r, b = divmod(k, grid)
        lists[grid - 1 - b if r & 1 else b].append(i)
    return lists


def _longest_first(costs, grid):
    """The items, costliest first, each to the least loaded block."""
    loads = [(0, b) for b in range(grid)]
    lists = [[] for _ in range(grid)]
    for i in sorted(range(len(costs)), key=lambda i: (-costs[i], i)):
        load, b = heapq.heappop(loads)
        lists[b].append(i)
        heapq.heappush(loads, (load + costs[i], b))
    return lists


@functools.lru_cache(maxsize=64)
def _plan(n: int, f: int, hc: int, bf16: bool, slots: int):
    """Row 6's work for one persistent launch: (splits, chunk, grid, the
    item ids of each block).

    Items are dx's output tiles (the first ids) and dW's (tile, K-chunk)
    pairs (the ids after them, column tile fastest, then row tile, then
    chunk), each costed by the bytes it loads and stores.  ``slots``
    blocks run at once (one per SM in bf16, two in f32).

    bf16: each dW chunk costs about a dx tile or 1/``slots`` of the whole
    call, whichever is larger, and the items are dealt in rounds
    (``_in_rounds``): the blocks running at once work on neighbouring
    items, which share x's and dz's rows in L2.  f32, bound by the SIMT
    arithmetic: for each chunk count the items go longest first to the
    least loaded block (``_longest_first``), and the count kept is the one
    whose most loaded block, plus the fold of its slices spread over the
    slots, costs least (the fewest chunks on a tie).  Either way the f32
    slices stay within ``_SLICE_BYTES``.
    """
    (xm, xn, xk), (wm, wn, wk), isz = _tiles(bf16, n, hc)
    x_items = _cdiv(n, xm) * _cdiv(f, xn)
    cost_x = _cdiv(hc, xk) * (xm + xn) * xk * isz + xm * xn * isz
    w_tiles = _cdiv(f, wm) * _cdiv(hc, wn)
    w_steps = _cdiv(n, wk)
    step_w, out_w = (wm + wn) * wk * isz, wm * wn * 4
    max_splits = max(1, _SLICE_BYTES // ((f + 1) * hc * 4))

    def work(want):
        chunk = _cdiv(w_steps, min(want, max_splits, w_steps))
        splits = _cdiv(w_steps, chunk)
        costs = [cost_x] * x_items + [
            min(chunk, w_steps - z * chunk) * step_w + out_w
            for z in range(splits) for _ in range(w_tiles)]
        return splits, chunk, costs, min(len(costs), slots)

    if bf16:
        total = x_items * cost_x + w_tiles * (w_steps * step_w + out_w)
        target = max(cost_x, total / slots)
        splits, chunk, costs, grid = work(
            _cdiv(w_steps, max(1, _cdiv(int(target) - out_w, step_w))))
        return splits, chunk, grid, tuple(map(tuple, _in_rounds(costs, grid)))
    best = None
    for want in range(1, min(w_steps, max_splits, 64) + 1):
        splits, chunk, costs, grid = work(want)
        lists = _longest_first(costs, grid)
        fold = 0 if splits == 1 else (splits + 1) * (f + 1) * hc * 4 / slots
        total = max(sum(costs[i] for i in items) for items in lists) + fold
        if best is None or total < best[0]:
            best = (total, splits, chunk, grid, tuple(map(tuple, lists)))
    return best[1:]


@functools.lru_cache(maxsize=64)
def _schedule(n: int, f: int, hc: int, bf16: bool, slots: int,
              device: torch.device) -> torch.Tensor:
    """``_plan``'s item lists as the kernel reads them: int32 [grid + 1 +
    items] on ``device``, block b's items at [grid + 1 + sched[b], grid +
    1 + sched[b + 1]).  Made once per shape and device (the first call of a
    shape copies it to the card; later calls, graph captures included,
    reuse it)."""
    lists = _plan(n, f, hc, bf16, slots)[3]
    offs = [0]
    for items in lists:
        offs.append(offs[-1] + len(items))
    return torch.tensor(offs + [i for items in lists for i in items],
                        dtype=torch.int32, device=device)


def fold_project_bwd(dz, x, w, with_bias=False):
    """Projection backward of z = x·W (+ b) from dz rows: (dx [N, F] in x's
    dtype, dW [F, H·C] f32[, db [H·C] f32 with ``with_bias``]).  x may be a
    column block of a wider buffer (row-major, any row stride).  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if dz.device.type == "cpu":
        return fold_project_bwd_plain(dz, x, w, with_bias)
    if dz.device.type != "cuda":
        raise ValueError(f"unsupported device {dz.device}")
    n, hc = dz.shape
    f = x.shape[1]
    for name, t in (("dz", dz), ("x", x), ("w", w)):
        if t.device != dz.device:
            raise ValueError(f"{name} is on {t.device}, dz on {dz.device}")
        if not (t.is_contiguous() or (name == "x" and t.stride(1) == 1)):
            raise ValueError(f"{name} must be contiguous (x: row-major)")
        if t.dtype != dz.dtype:
            raise TypeError(f"dz, x and w must share one dtype, got "
                            f"{dz.dtype} / {x.dtype} / {w.dtype}")
    if dz.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dz.dtype}")
    if x.shape[0] != n or w.shape != (f, hc):
        raise ValueError(f"shape mismatch: dz {tuple(dz.shape)}, x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    ldx = x.stride(0)
    bf16 = dz.dtype == torch.bfloat16
    vec = 8 if bf16 else 4
    if (f % vec or hc % vec or ldx % vec
            or any(t.data_ptr() % 16 for t in (dz, x, w))):
        raise ValueError(f"the products load 16-byte rows: F, H·C and x's "
                         f"row stride must be multiples of {vec} and dz, x, "
                         f"w 16-byte aligned")
    if bf16 and with_bias and hc % 64:
        raise ValueError("the bf16 bias form needs H·C a multiple of 64")
    lib = _build.bind("fold_project_bwd", "fold_project_bwd_launch",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                      + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                      + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
    sms = torch.cuda.get_device_properties(dz.device).multi_processor_count
    slots = sms * (1 if bf16 else 2)
    splits, chunk, grid, _ = _plan(n, f, hc, bf16, slots)
    sched = _schedule(n, f, hc, bf16, slots, dz.device)
    rows = f + int(with_bias)
    dx = torch.empty((n, f), dtype=x.dtype, device=dz.device)
    dw = torch.empty((rows, hc), dtype=torch.float32, device=dz.device)
    part = dw if splits == 1 else torch.empty(
        (splits, rows, hc), dtype=torch.float32, device=dz.device)
    rc = lib.fold_project_bwd_launch(
        dz.data_ptr(), x.data_ptr(), ldx, w.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), part.data_ptr(), n, f, hc, int(with_bias),
        _DTYPE_CODE[dz.dtype], splits, chunk, sched.data_ptr(), grid,
        _tiles(bf16, n, hc)[0][1],
        torch.cuda.current_stream(dz.device).cuda_stream)
    _build.check(lib, rc, "fold_project_bwd")
    _build.LAUNCHES["fold_project_bwd"] += 1
    return (dx, dw[:f], dw[f]) if with_bias else (dx, dw)


# ------------------------------------------------------------------ row 10
def _tr_bwd_rows_plain(bias_noself, q, k, v, g, heads, edge=None, qw=None,
                       gs=None, geo=None, pos=None, mean_expand=False,
                       dropout_rate=0.0, seed=None):
    """Row 10's receiver pass in plain PyTorch, dense over the window like
    the TPU kernel (masked entries contribute exactly 0), with its rounding
    points: g/H (head mean) rounded to the primal dtype for the dp product;
    rs and dl from the undropped e and the dropped dp.  Returns (dq, dqw or
    None, round(dl), round(ẽ), round(g·inv)): the two planes [n_tiles, H,
    T, Wcols] (0 off the mask) and G' [n_tiles, T, H, C] the partials pass
    sums."""
    n_tiles, tile, width = bias_noself.shape
    n, hc = q.shape
    c = hc // heads
    dt = q.dtype
    scale = 1.0 / (c ** 0.5)
    logits, planes = _tr_logits(bias_noself, q, k, heads, edge, qw, geo, pos)
    e, inv = _softmax_parts(logits)                           # inv [n, H, T, 1]
    if mean_expand:
        gh = (g.float() * (1.0 / heads)).reshape(n_tiles, tile, 1, c)
        gh = gh.expand(n_tiles, tile, heads, c)
    else:
        gh = g.float().reshape(n_tiles, tile, heads, c)
    win_k = _windows(k, tile, width).reshape(n_tiles, width, heads, c).float()
    win_v = _windows(v, tile, width).reshape(n_tiles, width, heads, c).float()
    dp = torch.einsum("nthc,nwhc->nhtw", _mm_round(gh, dt), win_v)
    if gs is not None and edge is not None:
        gs4 = gs.reshape(n_tiles, tile, heads, -1)
        for d in range(edge.shape[1]):
            dp = dp + _by_head(gs4[..., d]) * edge[:, d, None]
    if gs is not None and geo is not None:
        gs4 = gs.reshape(n_tiles, tile, heads, 4)
        pos_c, pos_w = planes["pos_c"], planes["pos_w"]
        gs_self = (gs4 * pos_c[:, :, None, :]).sum(-1)
        gsp = torch.einsum("nthd,nwd->nhtw", gs4, pos_w)
        dp = dp + (_by_head(gs_self) - gsp) * planes["invd"] \
            + _by_head(gs4[..., 3]) * planes["dist"]
    e_d = e
    if dropout_rate > 0:
        keep = _tr_keep(seed, bias_noself, heads, dropout_rate)
        kf = inv_keep(dropout_rate)
        e_d = torch.where(keep, e * kf, 0.0)
        dp = torch.where(keep, dp * kf, 0.0)
    rs = (e * dp).sum(-1, keepdim=True) * inv
    dl = (e * ((dp - rs) * inv)) * scale                      # [n, H, T, Wc]
    dl_r = _mm_round(dl, dt)
    dq = torch.einsum("nhtw,nwhc->nthc", dl_r, win_k).reshape(n, hc).to(dt)
    g_s = _mm_round(gh * inv.permute(0, 2, 1, 3), dt)          # [n, T, H, C]
    dqw = None
    if geo is not None:
        pos_c, pos_w = planes["pos_c"], planes["pos_w"]
        u = dl * planes["invd"]
        t13u = torch.einsum("nhtw,nwd->nthd", u, pos_w)
        t0u = u.sum(-1).permute(0, 2, 1)[..., None]            # [n, T, H, 1]
        dqw3 = (dl * planes["dist"]).sum(-1).permute(0, 2, 1)[..., None]
        dqw = torch.cat([(pos_c[:, :, None, :] * t0u - t13u)[..., :3], dqw3],
                        -1).reshape(n, heads * 4)
    elif edge is not None:
        dqw = torch.stack([(dl * edge[:, d, None]).sum(-1)
                           for d in range(edge.shape[1])], -1)  # [n, H, T, D]
        dqw = dqw.permute(0, 2, 1, 3).reshape(n, -1)
    return dq, dqw, dl_r, _mm_round(e_d, dt), g_s


def banded_transformer_bwd_plain(bias_noself, q, k, v, g, heads, edge=None,
                                 qw=None, gs=None, geo=None, pos=None,
                                 mean_expand=False, dropout_rate=0.0,
                                 seed=None):
    """Plain PyTorch version of row 10: the receiver pass
    (``_tr_bwd_rows_plain``), then the partials as the products of its
    planes with the receivers' q and G' rows, summed in f32 and rounded
    once.  Returns (dq, dk partials, dv partials[, dqw f32])."""
    n_tiles, tile, width = bias_noself.shape
    n, hc = q.shape
    c = hc // heads
    dq, dqw, dl_r, ed_r, g_s = _tr_bwd_rows_plain(
        bias_noself, q, k, v, g, heads, edge, qw, gs, geo, pos, mean_expand,
        dropout_rate, seed)
    q4 = q.reshape(n_tiles, tile, heads, c).float()
    parts = (n_tiles, width // (tile // 2), tile // 2, hc)
    dk = torch.einsum("nhtw,nthc->nwhc", dl_r, q4).reshape(parts).to(k.dtype)
    dv = torch.einsum("nhtw,nthc->nwhc", ed_r, g_s).reshape(parts).to(v.dtype)
    return (dq, dk, dv) if dqw is None else (dq, dk, dv, dqw)


def banded_transformer_bwd(bias_noself, q, k, v, g, heads, edge=None,
                           qw=None, gs=None, geo=None, pos=None,
                           mean_expand=False, dropout_rate=0.0, seed=None):
    """Row 10: the backward of row 9 given its inputs and the cotangents g
    of out (in q's dtype: [N, C] with ``mean_expand``, each head receiving
    g/H, else [N, H·C]) and ``gs`` of s (f32 [N, H·D_e] or None) →
    (dq [N, H·C] in q's dtype, dk and dv window partials [n_tiles, W_sub,
    sub, H·C] in k's / v's dtype[, dqw [N, H·D_e] f32 when conditioned]).
    q, k and v may be column blocks of one buffer.  CPU tensors take the
    plain version, CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return banded_transformer_bwd_plain(bias_noself, q, k, v, g, heads,
                                            edge, qw, gs, geo, pos,
                                            mean_expand, dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    n, hc = q.shape
    n_tiles, tile, width = bias_noself.shape
    mode, d_e, feat, extra = _conditioning(edge, qw, geo, pos, q, heads, tile,
                                           width)
    if gs is not None:
        extra = (*extra, ("gs", gs))
    c, ld = _check_transformer(bias_noself, q, k, v, heads,
                               (*extra, ("g", g)))
    if g.dtype != q.dtype or g.shape != (n, c if mean_expand else hc):
        raise ValueError(f"g must be [{n}, {c if mean_expand else hc}] in "
                         f"q's dtype, got {tuple(g.shape)} {g.dtype}")
    if gs is not None and (not mode or gs.shape != (n, heads * d_e)):
        raise ValueError(f"gs must be [{n}, {heads * d_e}] with conditioning")
    if g.data_ptr() % 16 or tile % 2 or tile > 256:
        raise ValueError("g must be 16-byte aligned and the tile even, at "
                         "most 256 rows")
    seed = _drop.check_seed(seed, dropout_rate, q.device)
    lib = _build.bind("banded_transformer_bwd", "banded_transformer_bwd_launch",
                      [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10
                      + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                         ctypes.c_uint, ctypes.c_float, ctypes.c_void_p])
    sub = tile // 2
    # scratch: 1/denominator per (row, head), and pass 1's (round(dl),
    # round(ẽ)) pairs, written and read only at the mask's nonzeros
    inv = torch.empty((n, heads), dtype=torch.float32, device=q.device)
    plane = torch.empty((n_tiles, heads, width, tile, 2),
                        dtype=torch.float32, device=q.device)
    dq = torch.empty((n, hc), dtype=q.dtype, device=q.device)
    dk = torch.empty((n_tiles, width // sub, sub, hc), dtype=k.dtype,
                     device=q.device)
    dv = torch.empty_like(dk)
    dqw = (torch.empty((n, heads * d_e), dtype=torch.float32, device=q.device)
           if mode else None)
    rc = lib.banded_transformer_bwd_launch(
        bias_noself.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(feat), _ptr(pos if mode == 2 else None),
        _ptr(qw if mode else None), g.data_ptr(), _ptr(gs), inv.data_ptr(),
        plane.data_ptr(), dq.data_ptr(), _ptr(dqw), dk.data_ptr(), dv.data_ptr(), n, ld, heads,
        c, tile, width, mode, d_e, int(mean_expand), _DTYPE_CODE[q.dtype],
        1.0 / (c ** 0.5), 1.0 / heads, _ptr(seed),
        _drop.threshold(dropout_rate),
        inv_keep(dropout_rate) if seed is not None else 1.0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "banded_transformer_bwd")
    _build.LAUNCHES["banded_transformer_bwd"] += 1
    return (dq, dk, dv, dqw) if mode else (dq, dk, dv)


# ------------------------------------------------------------------- row 7
def fold_partials_plain(part, tile, out=None):
    """Plain PyTorch version of :func:`fold_partials`: ``combine_partials``
    (W_sub/r shifted slices summed in f32 in ascending window block, blocks
    outside [0, n_tiles) dropped), rounded once to ``out``'s dtype."""
    out_dtype = part.dtype if out is None else out.dtype
    n_tiles, w_sub, sub, feat = part.shape
    r = tile // sub
    k0 = (w_sub - r) // 2
    pad = (w_sub + r - 1) // r + 1   # ≥ max |tile shift| over window blocks
    p = torch.nn.functional.pad(part.float(), (0, 0, 0, 0, 0, 0, pad, pad))
    rows = []
    for m in range(r):
        acc = None
        for k in range(w_sub):
            if (k - k0) % r != m:
                continue
            s = (k - k0) // r
            sl = p[pad - s:pad - s + n_tiles, k]
            acc = sl if acc is None else acc + sl
        rows.append(acc if acc is not None
                    else part.new_zeros((n_tiles, sub, feat), dtype=torch.float32))
    res = torch.stack(rows, 1).reshape(n_tiles * tile, feat).to(out_dtype)
    return res if out is None else out.copy_(res)


def fold_partials(part, tile, out=None):
    """Row 7: window partials [n_tiles, W_sub, sub, F] → [N, F] rows:
    window block (t, k) lands on sender sub-tile t·r + k − k0 (r = T/sub,
    k0 = (W_sub − r)/2); the f32 sum rounds once to the output's dtype.
    ``out``: an [N, F] row-major destination (a column block of a wider
    buffer, float32 or bfloat16), written and returned; by default a
    new buffer in the partials' dtype.  CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if part.device.type == "cpu":
        return fold_partials_plain(part, tile, out)
    n_tiles, w_sub, sub, feat = part.shape
    if part.device.type != "cuda":
        raise ValueError(f"unsupported device {part.device}")
    n = n_tiles * tile
    if out is None:
        out = torch.empty((n, feat), dtype=part.dtype, device=part.device)
    if part.dtype not in _DTYPE_CODE or out.dtype not in _DTYPE_CODE:
        raise TypeError(f"partials and output must be float32 or bfloat16, "
                        f"got {part.dtype} → {out.dtype}")
    if out.device != part.device or not part.is_contiguous():
        raise ValueError("part must be contiguous, out on its device")
    if (tile % sub or out.shape != (n, feat) or out.stride(1) != 1
            or feat % 4 or out.stride(0) % 4
            or part.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError(f"shape mismatch or misaligned: part "
                         f"{tuple(part.shape)}, tile {tile}, out "
                         f"{tuple(out.shape)} (F a multiple of 4, rows "
                         f"16-byte aligned)")
    r = tile // sub
    lib = _build.bind("fold_partials", "fold_partials_launch",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p])
    rc = lib.fold_partials_launch(
        part.data_ptr(), out.data_ptr(), out.stride(0), n_tiles, w_sub, sub,
        r, (w_sub - r) // 2, feat, _DTYPE_CODE[part.dtype],
        _DTYPE_CODE[out.dtype],
        torch.cuda.current_stream(part.device).cuda_stream)
    _build.check(lib, rc, "fold_partials")
    _build.LAUNCHES["fold_partials"] += 1
    return out
