"""MeshGraphNets' edge block (gather, 3-layer MLP, LayerNorm, residual and
the sum over receivers) and node block (the same MLP over [v, Σ e'] and
the residual), each fused, with their backwards.

Not a TPU function: the JAX package has no MeshGraphNets.  One processor
step of ``models/meshgraphnets.py::MeshGraphNet`` updates every directed
edge s→r of a receiver-sorted edge list:

    h0 = relu([v_s, v_r, e]·W0ᵀ + b0)      (384 → 128)
    h1 = relu(h0·W1ᵀ + b1)
    y  = h1·W2ᵀ + b2
    e' = LayerNorm(y)·γ + β                (statistics in f32, ε 1e-5)
    e_new = e + e'        agg[r] = Σ_{s→r} e'

:func:`mgn_edge` returns ``(e_new, agg)``, :func:`mgn_node` ``v + v'`` with
``v' = LayerNorm(MLP([v, agg]))``.  CPU tensors take the plain versions
(:func:`mgn_edge_plain`, :func:`mgn_node_plain`); CUDA tensors the kernels
of ``csrc/mgn_edge.cu`` (bf16 latents only) inside :class:`_EdgeBlock` and
:class:`_NodeBlock`, or they raise.  Rounding points, the kernels' and
the plain versions': each product accumulates in f32 and adds its f32
bias before one rounding to the latent dtype; the LayerNorm reads the
rounded y; e' is rounded once, e + e' once, agg is the f32 sum of the
rounded e' rounded once.

Forward (``mgn_edge_fwd``, one persistent launch, a block an SM): the
three weights stay in shared memory; each warp walks strips of 16 edge
rows on its own, gathers v_s, v_r and e one after another into its rows
and runs the first layer as three K=128 ``mma.sync`` products into one
f32 accumulator, so the [E, 384] input and the first layer's output
never reach device memory; then the two 128×128 layers and the
LayerNorm on the warp's rows in registers.  The strip's e' sums over
each receiver's run of edges, in edge order, with no atomics: a run
inside the strip is written whole; a run cut by a strip boundary leaves
a partial a side, which ``mgn_edge_fixup`` adds up in strip order.
Training saves h0, h1 (after the ReLU), y, and each row's mean and 1/σ.

Backward (``mgn_edge_bwd``): each warp's rows: the LayerNorm backward
from y and the saved statistics (cotangent of e' = that of e_new plus
that of agg at the edge's receiver), then dh1 = dy·W2 and dh0 = dh1·W1
with the ReLU masks, and de = g_new + dh0·W0_e, each product on
``mma.sync``; dy, dh1 and dh0 go out in bf16 for the weight gradients,
and the column sums of dh0, dh1, dy, g·x̂ and g (the biases', γ's and
β's gradients) stay per warp in registers until the launch ends.  The
cotangents of v_s and v_r are products of dh0 with the two 128-column
blocks of W0 summed over senders and over receivers; both sums come
first and the products after, on the nodes: Σ_{e: s_e = n} dh0_e · W0_s =
(Σ dh0_e) · W0_s.  The receiver sums of dh0 run in the tile as the
forward's do; the sender sums in ``mgn_edge_senders``, one warp a node
over its edges in the sender order (edge ids sorted by sender, stable).
The node products, dW0 = [S(dh0)ᵀ·v, R(dh0)ᵀ·v, dh0ᵀ·e], dW1 = dh1ᵀ·h0
and dW2 = dyᵀ·h1 run on cuBLAS in bf16.  Every sum runs in a fixed
order: two calls give the same bits.

The node block (``mgn_node_fwd``, ``mgn_node_bwd``) is the same code with
two gathered parts, v and agg, each its own row (no index), no sums over
receivers, and in the backward two input cotangents: dv = g + dh0·W0_v
(the residual) and dagg = dh0·W0_agg; dW0 = [dh0ᵀ·v, dh0ᵀ·agg].

What bounds it on an H100 at the cell's size (994,918 edges, latent 128,
bf16): a forward moves e, e_new, h0, h1, y (5 × 255 MB) and the gathers
(2 × 255 MB, mostly from L2: v is 64 MB), 0.38 ms at 3.35 TB/s, against
0.33 ms of products at 989 TFLOP/s; the backward moves 8 edge tensors,
about 0.6 ms.  The first version runs ``mma.sync`` from padded shared
memory; a warp waits for its own gathers while the SM's other warps
work.

``_build.LAUNCHES`` counts each launch where it is made:
``mgn_edge_fwd``, ``mgn_edge_bwd``, ``mgn_edge_fixup`` (once in each
direction), ``mgn_edge_senders``, ``mgn_node_fwd``, ``mgn_node_bwd``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

C = 128            # the latent width the kernels take
STRIP = 16         # edges a warp takes at a time
WARPS = 8          # warps a block
N_COLS = 5         # column sums of the backward: db0, db1, db2, dγ, dβ
EPS = 1e-5


def _mlp_ln_plain(x, w0, b0, w1, b1, w2, b2, gamma, beta, eps: float):
    """LayerNorm(MLP(x)) rounded to x's dtype at the kernels' points."""
    dt = x.dtype

    def lin(x, w, b):
        return (x.float() @ w.to(dt).float().t() + b.float()).to(dt)

    h0 = torch.relu(lin(x, w0, b0))
    h1 = torch.relu(lin(h0, w1, b1))
    y = lin(h1, w2, b2)
    return F.layer_norm(y.float(), (y.shape[1],), gamma.float(), beta.float(),
                        eps).to(dt)


def mgn_edge_plain(v, e, senders, receivers, w0, b0, w1, b1, w2, b2, gamma,
                   beta, eps: float = EPS):
    """The edge block in plain torch with the kernels' rounding points
    (see the module doc); differentiable.  ``v`` [N, C], ``e`` [E, C] in
    the latent dtype, ``senders`` / ``receivers`` [E] (receiver-sorted for
    the kernels; any order here), weights as ``nn.Linear`` keeps them."""
    x = torch.cat([v.index_select(0, senders), v.index_select(0, receivers),
                   e], dim=1)
    ep = _mlp_ln_plain(x, w0, b0, w1, b1, w2, b2, gamma, beta, eps)
    e_new = (e.float() + ep.float()).to(e.dtype)
    agg = torch.zeros((v.shape[0], e.shape[1]), dtype=torch.float32,
                      device=e.device).index_add(0, receivers.long(),
                                                 ep.float())
    return e_new, agg.to(e.dtype)


def mgn_node_plain(v, agg, w0, b0, w1, b1, w2, b2, gamma, beta,
                   eps: float = EPS):
    """The node block, v + LayerNorm(MLP([v, agg])), in plain torch with
    the kernels' rounding points; differentiable."""
    vp = _mlp_ln_plain(torch.cat([v, agg], dim=1), w0, b0, w1, b1, w2, b2,
                       gamma, beta, eps)
    return (v.float() + vp.float()).to(v.dtype)


def sender_order(senders: torch.Tensor, n_nodes: int):
    """(ptr [N + 1], edge ids [E]) int32: each node's out-edges in edge
    order, the backward's sender pass."""
    eid = torch.argsort(senders, stable=True)
    nodes = torch.arange(n_nodes + 1, dtype=senders.dtype,
                         device=senders.device)
    # no bincount: its size check would synchronize inside a graph capture
    ptr = torch.searchsorted(senders[eid], nodes)
    return ptr.to(torch.int32), eid.to(torch.int32)


def mgn_edge(v, e, senders, receivers, w0, b0, w1, b1, w2, b2, gamma, beta,
             s_order=None):
    """(e_new, agg): the plain version on the CPU, the kernels on CUDA
    (``s_order``: :func:`sender_order` of ``senders``, which a gradient on
    the card needs)."""
    if e.device.type == "cpu":
        return mgn_edge_plain(v, e, senders, receivers, w0, b0, w1, b1, w2,
                              b2, gamma, beta)
    if e.device.type != "cuda":
        raise ValueError(f"unsupported device {e.device}")
    if v.dtype != torch.bfloat16 or e.dtype != torch.bfloat16:
        raise TypeError("the mgn_edge kernels take bf16 latents, got "
                        f"{v.dtype} and {e.dtype}")
    if (v.dim() != 2 or e.dim() != 2 or v.shape[1] != C or e.shape[1] != C
            or w0.shape != (C, 3 * C) or w1.shape != (C, C)
            or w2.shape != (C, C)
            or senders.shape != (e.shape[0],)
            or receivers.shape != senders.shape):
        raise ValueError(f"shape mismatch: v {tuple(v.shape)}, e "
                         f"{tuple(e.shape)}, w0 {tuple(w0.shape)}, senders "
                         f"{tuple(senders.shape)}: the kernels take latent "
                         f"{C}")
    for t in (v, senders, receivers, w0, w1, w2):
        if t.device != e.device:
            raise ValueError("all inputs must be on one device")
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32:
        raise TypeError("senders and receivers must be int32")
    if s_order is None:
        if torch.is_grad_enabled():
            raise ValueError("a gradient of mgn_edge on the card needs "
                             "s_order (sender_order of the senders)")
        s_order = (senders[:0],) * 2
    return _EdgeBlock.apply(v, e, w0, b0, w1, b1, w2, b2, gamma, beta,
                            senders, receivers, *s_order)


def mgn_node(v, agg, w0, b0, w1, b1, w2, b2, gamma, beta):
    """v + LayerNorm(MLP([v, agg])): the plain version on the CPU, the
    kernels on CUDA (bf16 latents of width 128)."""
    if v.device.type == "cpu":
        return mgn_node_plain(v, agg, w0, b0, w1, b1, w2, b2, gamma, beta)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    if v.dtype != torch.bfloat16 or agg.dtype != torch.bfloat16:
        raise TypeError("the mgn_node kernels take bf16 latents, got "
                        f"{v.dtype} and {agg.dtype}")
    if (v.dim() != 2 or v.shape[1] != C or agg.shape != v.shape
            or w0.shape != (C, 2 * C) or w1.shape != (C, C)
            or w2.shape != (C, C)):
        raise ValueError(f"shape mismatch: v {tuple(v.shape)}, agg "
                         f"{tuple(agg.shape)}, w0 {tuple(w0.shape)}: the "
                         f"kernels take latent {C}")
    if agg.device != v.device or w0.device != v.device:
        raise ValueError("all inputs must be on one device")
    return _NodeBlock.apply(v, agg, w0, b0, w1, b1, w2, b2, gamma, beta)


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _grid(device, n_strips: int) -> int:
    return max(1, min(_sm_count(device), -(-n_strips // WARPS)))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _bf16(t):
    return t.to(torch.bfloat16).contiguous()


def _saved(n_rows: int, like: torch.Tensor, save: bool):
    """(h0, h1, y, mean, rstd) for the backward, or None."""
    if not save:
        return None
    dev = like.device
    return (torch.empty_like(like), torch.empty_like(like),
            torch.empty_like(like),
            torch.empty(n_rows, dtype=torch.float32, device=dev),
            torch.empty(n_rows, dtype=torch.float32, device=dev))


def _weights(w0, b0, w1, b1, w2, b2, gamma, beta):
    """The kernels' copies: bf16 weights, f32 vectors."""
    def f32(t):
        return t.float().contiguous()

    return (_bf16(w0), f32(b0), _bf16(w1), f32(b1), _bf16(w2), f32(b2),
            f32(gamma), f32(beta))


def edge_block_fwd(v, e, senders, receivers, w0, b0, w1, b1, w2, b2, gamma,
                   beta, save: bool):
    """The edge block's forward launches: (e_new, agg, saved) with
    ``saved`` (h0, h1, y, mean, rstd) when ``save``, else None."""
    dev = e.device
    n_edges = e.shape[0]
    n_strips = -(-n_edges // STRIP)
    v, e = v.contiguous(), e.contiguous()
    e_new = torch.empty_like(e)
    agg = torch.zeros_like(v)
    part = torch.empty((max(n_strips, 1), 2, C), dtype=torch.float32,
                       device=dev)
    saved = _saved(n_edges, e, save)
    keep = _weights(w0, b0, w1, b1, w2, b2, gamma, beta)
    lib = _build.bind("mgn_edge", "mgn_edge_fwd_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 8 + [ctypes.c_float]
                      + [ctypes.c_void_p] * 8 + [ctypes.c_int,
                                                 ctypes.c_void_p])
    rc = lib.mgn_edge_fwd_launch(
        v.data_ptr(), e.data_ptr(), senders.data_ptr(), receivers.data_ptr(),
        n_edges, *(t.data_ptr() for t in keep), EPS, e_new.data_ptr(),
        agg.data_ptr(), part.data_ptr(),
        *(_ptr(t) for t in (saved or (None,) * 5)), _grid(dev, n_strips),
        _stream(dev))
    _build.check(lib, rc, "mgn_edge_fwd")
    if n_edges:
        _build.LAUNCHES["mgn_edge_fwd"] += 1
        _build.LAUNCHES["mgn_edge_fixup"] += 1
    return e_new, agg, saved


def node_block_fwd(v, agg, w0, b0, w1, b1, w2, b2, gamma, beta, save: bool):
    """The node block's forward launch: (v_new, saved)."""
    dev = v.device
    n_nodes = v.shape[0]
    v, agg = v.contiguous(), agg.contiguous()
    v_new = torch.empty_like(v)
    saved = _saved(n_nodes, v, save)
    keep = _weights(w0, b0, w1, b1, w2, b2, gamma, beta)
    lib = _build.bind("mgn_edge", "mgn_node_fwd_launch",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 8 + [ctypes.c_float]
                      + [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                 ctypes.c_void_p])
    rc = lib.mgn_node_fwd_launch(
        v.data_ptr(), agg.data_ptr(), n_nodes,
        *(t.data_ptr() for t in keep), EPS, v_new.data_ptr(),
        *(_ptr(t) for t in (saved or (None,) * 5)),
        _grid(dev, -(-n_nodes // STRIP)), _stream(dev))
    _build.check(lib, rc, "mgn_node_fwd")
    if n_nodes:
        _build.LAUNCHES["mgn_node_fwd"] += 1
    return v_new, saved


def edge_block_bwd(g_new, g_agg, receivers, s_ptr, s_eid, saved, w0, w1, w2,
                   gamma):
    """The edge block's backward launches: (dy, dh1, dh0, de, rsum, ssum,
    column sums [5, C]) in the order of the module doc."""
    h0, h1, y, mean, rstd = saved
    dev = g_new.device
    n_edges, n_nodes = g_new.shape[0], g_agg.shape[0]
    n_strips = -(-n_edges // STRIP)
    grid = _grid(dev, n_strips)
    dy, dh1, dh0, de = (torch.empty_like(g_new) for _ in range(4))
    rsum = torch.zeros((n_nodes, C), dtype=torch.float32, device=dev)
    ssum = torch.empty((n_nodes, C), dtype=torch.float32, device=dev)
    part = torch.empty((max(n_strips, 1), 2, C), dtype=torch.float32,
                       device=dev)
    cols = torch.empty((grid * WARPS, N_COLS, C), dtype=torch.float32,
                       device=dev)
    w2t, w1t = _bf16(w2.t()), _bf16(w1.t())
    w0et = _bf16(w0[:, 2 * C:].t())
    gamma = gamma.float().contiguous()
    lib = _build.bind("mgn_edge", "mgn_edge_bwd_launch",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 16 + [ctypes.c_int,
                                                  ctypes.c_void_p])
    rc = lib.mgn_edge_bwd_launch(
        g_new.data_ptr(), g_agg.data_ptr(), receivers.data_ptr(), n_edges,
        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), h0.data_ptr(),
        h1.data_ptr(), w2t.data_ptr(), w1t.data_ptr(), w0et.data_ptr(),
        gamma.data_ptr(), dy.data_ptr(), dh1.data_ptr(), dh0.data_ptr(),
        de.data_ptr(), rsum.data_ptr(), part.data_ptr(), cols.data_ptr(),
        grid, _stream(dev))
    _build.check(lib, rc, "mgn_edge_bwd")
    if n_edges:
        _build.LAUNCHES["mgn_edge_bwd"] += 1
        _build.LAUNCHES["mgn_edge_fixup"] += 1
    lib = _build.bind("mgn_edge", "mgn_edge_senders_launch",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 2)
    rc = lib.mgn_edge_senders_launch(dh0.data_ptr(), s_ptr.data_ptr(),
                                     s_eid.data_ptr(), n_nodes,
                                     ssum.data_ptr(), _stream(dev))
    _build.check(lib, rc, "mgn_edge_senders")
    if n_nodes:
        _build.LAUNCHES["mgn_edge_senders"] += 1
    return dy, dh1, dh0, de, rsum, ssum, cols.sum(0)


def node_block_bwd(g_new, saved, w0, w1, w2, gamma):
    """The node block's backward launch: (dy, dh1, dh0, dv, dagg, column
    sums [5, C])."""
    h0, h1, y, mean, rstd = saved
    dev = g_new.device
    n_nodes = g_new.shape[0]
    grid = _grid(dev, -(-n_nodes // STRIP))
    dy, dh1, dh0, dv, dagg = (torch.empty_like(g_new) for _ in range(5))
    cols = torch.empty((grid * WARPS, N_COLS, C), dtype=torch.float32,
                       device=dev)
    w2t, w1t = _bf16(w2.t()), _bf16(w1.t())
    w0vt, w0at = _bf16(w0[:, :C].t()), _bf16(w0[:, C:].t())
    gamma = gamma.float().contiguous()
    lib = _build.bind("mgn_edge", "mgn_node_bwd_launch",
                      [ctypes.c_void_p] + [ctypes.c_int]
                      + [ctypes.c_void_p] * 16 + [ctypes.c_int,
                                                  ctypes.c_void_p])
    rc = lib.mgn_node_bwd_launch(
        g_new.data_ptr(), n_nodes, y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), h0.data_ptr(), h1.data_ptr(), w2t.data_ptr(),
        w1t.data_ptr(), w0vt.data_ptr(), w0at.data_ptr(), gamma.data_ptr(),
        dy.data_ptr(), dh1.data_ptr(), dh0.data_ptr(), dv.data_ptr(),
        dagg.data_ptr(), cols.data_ptr(), grid, _stream(dev))
    _build.check(lib, rc, "mgn_node_bwd")
    if n_nodes:
        _build.LAUNCHES["mgn_node_bwd"] += 1
    return dy, dh1, dh0, dv, dagg, cols.sum(0)


def _mlp_weight_grads(dy, dh1, h0, h1, cols):
    """dW1, dW2 (cuBLAS, bf16) and the vectors' gradients from the column
    sums: (dW1, dW2, db0, db1, db2, dγ, dβ)."""
    db0, db1, db2, dgamma, dbeta = cols
    return ((dh1.t() @ h0).float(), (dy.t() @ h1).float(), db0, db1, db2,
            dgamma, dbeta)


class _EdgeBlock(torch.autograd.Function):
    """:func:`mgn_edge` on the card; saves h0, h1, y and the LayerNorm's
    statistics (and the inputs v and e) when a gradient is asked for."""

    @staticmethod
    def forward(ctx, v, e, w0, b0, w1, b1, w2, b2, gamma, beta, senders,
                receivers, s_ptr, s_eid):
        save = any(ctx.needs_input_grad[:10])
        e_new, agg, saved = edge_block_fwd(v, e, senders, receivers, w0, b0,
                                           w1, b1, w2, b2, gamma, beta, save)
        if save:
            ctx.save_for_backward(v, e, w0, w1, w2, gamma, receivers, s_ptr,
                                  s_eid, *saved)
        return e_new, agg

    @staticmethod
    def backward(ctx, g_new, g_agg):
        v, e, w0, w1, w2, gamma, receivers, s_ptr, s_eid, *saved = \
            ctx.saved_tensors
        g_new = (torch.zeros_like(e) if g_new is None
                 else g_new.to(e.dtype).contiguous())
        g_agg = (torch.zeros_like(v) if g_agg is None
                 else g_agg.to(v.dtype).contiguous())
        dy, dh1, dh0, de, rsum, ssum, cols = edge_block_bwd(
            g_new, g_agg, receivers, s_ptr, s_eid, saved, w0, w1, w2, gamma)
        w0b = w0.to(torch.bfloat16)
        sb, rb = ssum.to(torch.bfloat16), rsum.to(torch.bfloat16)
        dv = torch.addmm(sb @ w0b[:, :C], rb, w0b[:, C:2 * C])
        dw0 = torch.cat([sb.t() @ v, rb.t() @ v, dh0.t() @ e], dim=1).float()
        dw1, dw2, db0, db1, db2, dgamma, dbeta = _mlp_weight_grads(
            dy, dh1, saved[0], saved[1], cols)
        return (dv, de, dw0, db0, dw1, db1, dw2, db2, dgamma, dbeta,
                None, None, None, None)


class _NodeBlock(torch.autograd.Function):
    """:func:`mgn_node` on the card; saves as :class:`_EdgeBlock` does."""

    @staticmethod
    def forward(ctx, v, agg, w0, b0, w1, b1, w2, b2, gamma, beta):
        save = any(ctx.needs_input_grad)
        v_new, saved = node_block_fwd(v, agg, w0, b0, w1, b1, w2, b2, gamma,
                                      beta, save)
        if save:
            ctx.save_for_backward(v, agg, w0, w1, w2, gamma, *saved)
        return v_new

    @staticmethod
    def backward(ctx, g_new):
        v, agg, w0, w1, w2, gamma, *saved = ctx.saved_tensors
        g_new = g_new.to(v.dtype).contiguous()
        dy, dh1, dh0, dv, dagg, cols = node_block_bwd(g_new, saved, w0, w1,
                                                      w2, gamma)
        dw0 = torch.cat([dh0.t() @ v, dh0.t() @ agg], dim=1).float()
        dw1, dw2, db0, db1, db2, dgamma, dbeta = _mlp_weight_grads(
            dy, dh1, saved[0], saved[1], cols)
        return dv, dagg, dw0, db0, dw1, db1, dw2, db2, dgamma, dbeta
