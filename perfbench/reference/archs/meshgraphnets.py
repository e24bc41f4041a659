"""MeshGraphNets (Pfaff, Fortunato, Sanchez-Gonzalez, Battaglia, ICLR 2021,
arXiv:2010.03409; deepmind-research ``meshgraphnets/core_model.py``,
``EncodeProcessDecode`` and ``GraphNetBlock``), plain PyTorch in float32.

* ``MLP_ln(x)``: Linear(d_in → L), ReLU, Linear(L → L), ReLU, Linear(L →
  L), LayerNorm(L) with scale and offset, ε 1e-5 (L = ``hidden_dim``);
* encoder: ``v = MLP_ln(node_in)``, ``e = MLP_ln(edge_in)``;
* ``num_layers`` processor steps, each with its own weights: for every
  directed edge s→r ``e'_sr = MLP_ln([v_s, v_r, e_sr])`` (384 wide in
  sender, receiver, edge order); for every node ``v'_r = MLP_ln([v_r,
  Σ_{s→r} e'_sr])``; then ``v ← v + v'`` and ``e ← e + e'``;
* decoder: Linear(L → L), ReLU, Linear(L → L), ReLU, Linear(L → 7), no
  LayerNorm.

Departures from the published model, which are the system's task and
not the architecture:

* node inputs are the 3 cell-centre coordinates (published: velocity and
  node type);
* edge inputs are the 4 features ``[unit direction, distance]``
  (published: the displacement and its norm, the same information);
* the output is the 7 steady fields, with no rollout, no training noise
  and no online normaliser;
* the loss and the optimiser are the port's ``Trainer``'s
  (``reference/train.py``);
* initialisation is uniform ±1/√fan_in (weights and biases), LayerNorms at
  the identity, not truncated normal.

A training forward recomputes each processor step in its backward
(``torch.utils.checkpoint``): at the grid's size (994,918 edges) the f32
activations of 15 steps would not fit beside what the check holds.  The
names are the port's ``state_dict``'s
(``gnn_bfs_rans_tpu_torch/models/meshgraphnets.py``).  No BatchNorm, no
dropout: ``mode`` and ``gen`` change nothing.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..model import linear, products, quantizer
from ...yardstick.weights import Leaf
from ._flowgnn import dtype_bytes, lin, mm

EDGE_IN = 4
LN_EPS = 1e-5


def _mlp_leaves(name: str, d_in: int, h: int, d_out: int,
                layer_norm: bool = True) -> list[Leaf]:
    out = (lin(f"{name}.lin_0", d_in, h) + lin(f"{name}.lin_1", h, h)
           + lin(f"{name}.lin_2", h, d_out))
    if layer_norm:
        out += [Leaf(f"{name}.norm.weight", (d_out,), "ones"),
                Leaf(f"{name}.norm.bias", (d_out,), "zeros")]
    return out


def param_shapes(cfg: dict) -> list[Leaf]:
    h = cfg["hidden_dim"]
    out = (_mlp_leaves("node_encoder", cfg["input_dim"], h, h)
           + _mlp_leaves("edge_encoder", EDGE_IN, h, h))
    for i in range(cfg["num_layers"]):
        out += (_mlp_leaves(f"processor.{i}.edge_mlp", 3 * h, h, h)
                + _mlp_leaves(f"processor.{i}.node_mlp", 2 * h, h, h))
    return out + _mlp_leaves("decoder", h, h, cfg["output_dim"],
                             layer_norm=False)


class Forward:
    def __init__(self, cfg: dict, graph, quant: str = "f32"):
        self.cfg = cfg
        self.g = graph
        self.q = quantizer(quant)
        self.mm = products(quant)

    def mlp(self, p, name, x, layer_norm=True):
        q = self.q
        h = torch.relu(linear(p, f"{name}.lin_0", x, q, mm=self.mm))
        h = torch.relu(linear(p, f"{name}.lin_1", h, q, mm=self.mm))
        y = linear(p, f"{name}.lin_2", h, q, mm=self.mm)
        if not layer_norm:
            return y
        return q(F.layer_norm(y, y.shape[-1:], p[f"{name}.norm.weight"],
                              p[f"{name}.norm.bias"], LN_EPS))

    def step(self, p, i, v, e):
        s, r = self.g.senders, self.g.receivers
        ep = self.mlp(p, f"processor.{i}.edge_mlp",
                      torch.cat([v[s], v[r], e], dim=1))
        agg = self.q(torch.zeros_like(v).index_add(0, r, ep))
        vp = self.mlp(p, f"processor.{i}.node_mlp", torch.cat([v, agg], 1))
        return self.q(v + vp), self.q(e + ep)

    def __call__(self, p, stats, x, mode: str, gen=None) -> torch.Tensor:
        v = self.mlp(p, "node_encoder", x)
        e = self.mlp(p, "edge_encoder", self.g.edge_feat)
        for i in range(self.cfg["num_layers"]):
            step = functools.partial(self.step, p, i)
            if torch.is_grad_enabled():
                v, e = checkpoint(step, v, e, use_reentrant=False)
            else:
                v, e = step(v, e)
        return self.mlp(p, "decoder", v, layer_norm=False)


def _forward_flops(cfg: dict, n: float, e: float) -> dict[str, float]:
    """Matmul FLOPs of a forward by part, the 384-wide first edge layer
    counted as published."""
    h, steps = cfg["hidden_dim"], cfg["num_layers"]

    def mlp(rows, d_in, d_out):
        return mm(rows, d_in, h) + mm(rows, h, h) + mm(rows, h, d_out)

    return {"node_encoder": mlp(n, cfg["input_dim"], h),
            "edge_encoder": mlp(e, EDGE_IN, h),
            "edge": steps * mlp(e, 3 * h, h),
            "node": steps * mlp(n, 2 * h, h),
            "decoder": mlp(n, h, cfg["output_dim"])}


def model_flops(cfg: dict, n_nodes: int, n_edges: int, train: bool) -> float:
    """The model's matmul FLOPs of a forward, or of a training step (three
    forwards)."""
    fl = sum(_forward_flops(cfg, float(n_nodes), float(n_edges)).values())
    return 3.0 * fl if train else fl


def step_ops(cfg: dict, n_nodes: int, n_edges: int, train: bool
             ) -> list[tuple[str, float, float]]:
    """``(operation, FLOPs, bytes)``; bytes are each input read once and
    each output written once (latents in the compute dtype, weights in it
    and their gradients in f32, an edge's sender and receiver 8 bytes).
    ``mgn_edge`` / ``mgn_edge_bwd``: the processor's edge blocks (the
    gather, MLP, LayerNorm, residual and receiver sum; the backward's
    cotangents on the edges: three h × h products an edge and the
    LayerNorm), ``edge_mlp_nodes`` the backward's products on the nodes
    (the cotangent of v from the node sums of dh0, and dW0's sender and
    receiver blocks), ``edge_mlp_wgrad`` the weight gradients on the
    edges, ``node_mlp`` the node blocks with their residual."""
    n, e = float(n_nodes), float(n_edges)
    h, steps, out = cfg["hidden_dim"], cfg["num_layers"], cfg["output_dim"]
    b = dtype_bytes(cfg)
    fl = _forward_flops(cfg, n, e)
    ln = 8.0 * h            # a LayerNorm row: statistics and affine

    def n_weights(d_in, d_out, layer_norm=True):
        return (d_in * h + h + h * h + h + h * d_out + d_out
                + (2 * d_out if layer_norm else 0))

    w_enc_n = n_weights(cfg["input_dim"], h)
    w_enc_e = n_weights(EDGE_IN, h)
    w_edge, w_node = n_weights(3 * h, h), n_weights(2 * h, h)
    w_dec = n_weights(h, out, layer_norm=False)
    n_params = w_enc_n + w_enc_e + steps * (w_edge + w_node) + w_dec
    lat_n, lat_e = n * h * b, e * h * b
    ops: list[tuple[str, float, float]] = []

    def op(name, flops, by, bwd_by=None):
        ops.append((name, flops, by))
        if train and bwd_by is not None:
            ops.append((name + ".bwd", 2.0 * flops, bwd_by))

    # encoders: f32 inputs in, latents out
    op("node_encoder", fl["node_encoder"] + n * ln,
       n * cfg["input_dim"] * 4 + w_enc_n * b + lat_n,
       lat_n + n * cfg["input_dim"] * 4 + w_enc_n * (b + 4))
    op("edge_encoder", fl["edge_encoder"] + e * ln,
       e * EDGE_IN * 4 + w_enc_e * b + lat_e,
       lat_e + e * EDGE_IN * 4 + w_enc_e * (b + 4))
    # edge blocks: v, e, the adjacency and the weights in; e + e' and the
    # receiver sums out
    ops.append(("mgn_edge", fl["edge"] + steps * e * (ln + 2.0 * h),
                steps * (lat_n + lat_e + 8.0 * e + w_edge * b
                         + lat_e + lat_n)))
    if train:
        # the cotangents on the edges: dh1 = dy·W2, dh0 = dh1·W1, de = g +
        # dh0·W0_e; those of e_new and agg, v and e in; those of v and e
        # out
        ops.append(("mgn_edge_bwd",
                    steps * (3 * mm(e, h, h) + e * 2.0 * ln),
                    steps * (2 * lat_e + 2 * lat_n + 8.0 * e + w_edge * b
                             + lat_e + lat_n)))
        # on the nodes: dv = S(dh0)·W0_s + R(dh0)·W0_r and dW0's blocks
        # S(dh0)ᵀ·v, R(dh0)ᵀ·v; the two f32 sums and v in, dv and the
        # blocks (f32) out
        ops.append(("edge_mlp_nodes", steps * 4 * mm(n, h, h),
                    steps * (2 * n * h * 4 + lat_n + 2 * h * h * b + lat_n
                             + 2 * h * h * 4)))
        # dW0_e = dh0ᵀ·e, dW1 = dh1ᵀ·h0, dW2 = dyᵀ·h1: six edge tensors in,
        # dW (f32) out
        ops.append(("edge_mlp_wgrad", steps * 3 * mm(e, h, h),
                    steps * (6 * lat_e + 3 * h * h * 4)))
    # node blocks: v and agg in, v + v' out
    op("node_mlp", fl["node"] + steps * n * (ln + h),
       steps * (3 * lat_n + w_node * b),
       steps * (5 * lat_n + w_node * (b + 4)))
    # decoder: the last layer in f32
    op("decoder", fl["decoder"], lat_n + w_dec * b + n * out * 4,
       n * out * 4 + lat_n + w_dec * (b + 4) + lat_n)
    # the loss reads the prediction and the target
    ops.append(("loss", 4.0 * n * out, 2.0 * n * out * 4))
    if train:
        # global-norm clip reads the gradients; Adam reads p, g, m, v and
        # writes p, m, v (f32)
        ops.append(("clip", 2.0 * n_params, 4.0 * n_params))
        ops.append(("adam", 12.0 * n_params, 28.0 * n_params))
    return ops
