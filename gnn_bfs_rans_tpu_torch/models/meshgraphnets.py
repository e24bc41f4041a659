"""MeshGraphNets (Pfaff et al., "Learning Mesh-Based Simulation with Graph
Networks", ICLR 2021, arXiv:2010.03409): encode, process, decode.

The equations of the published ``meshgraphnets/core_model.py``
(``EncodeProcessDecode``, ``GraphNetBlock``), latent ``L`` =
``hidden_dim``, ``num_layers`` message-passing steps:

* ``MLP_ln(x)``: Linear(d_in → L), ReLU, Linear(L → L), ReLU, Linear(L →
  L), LayerNorm(L) with scale and offset (ε 1e-5);
* encoder: ``v = MLP_ln(node_feat)`` (the 3 cell-centre coordinates),
  ``e = MLP_ln(edge_feat)`` (``[unit direction, distance]``);
* each step, with its own weights: for every directed edge s→r
  ``e'_sr = MLP_ln([v_s, v_r, e_sr])``; for every node ``v'_r =
  MLP_ln([v_r, Σ_{s→r} e'_sr])``; then ``v ← v + v'``, ``e ← e + e'``;
* decoder: Linear(L → L), ReLU, Linear(L → L), ReLU, Linear(L → 7), no
  LayerNorm, in f32 (as FlowGNN's head).

The model reads the graph's receiver-sorted COO edges (``senders``,
``receivers``, ``edge_feat``) up to ``n_edges``: padded edges take no
part, and padded rows receive no message.  On ``pallas`` the edge and
node blocks are ``kernels/mgn.py::mgn_edge`` and ``mgn_node``
(``csrc/mgn_edge.cu`` on the card; bf16 only; their plain versions on the
CPU); on ``segment`` and ``dense`` they are those plain versions,
``mgn_edge_plain`` and ``mgn_node_plain`` (``index_select``, ``cat``, the
products in f32 on inputs in the latent dtype, ``F.layer_norm`` and
``index_add``).  The encoders and the decoder are products through
``convs.dense`` and ``F.layer_norm`` on every backend.

Dtypes (``compute_dtype``): ``float32``; ``bfloat16``: parameters f32,
products in bf16 with f32 accumulation, node and edge latents stored in
bf16, LayerNorm statistics in f32, the decoder's last layer in f32.
``mixed`` is refused.  So are ``use_batch_norm`` (the LayerNorms belong
to the architecture), a nonzero ``dropout`` and ``remat``; partitioned,
multi-topology and surrogate training, and the reference's ``.pt``
export, take ``FlowGNN`` only.

Traced (``utils/trace.py``): ``mgn.forward`` (``train``; counters) with
children ``mgn.encode``, ``mgn.process``, ``mgn.decode``; counters
``mgn.edge_rows`` (E × steps a forward) and ``mgn.saved_bytes`` (the
bytes autograd keeps for the backward of the processor's edge and node
blocks, each tensor once, counted by a saved-tensors hook where they are
saved).
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.structs import Graph
from ..kernels.mgn import (mgn_edge, mgn_edge_plain, mgn_node,
                           mgn_node_plain, sender_order)
from ..utils import trace
from .convs import dense, lecun_init_

LAYER_TYPE = "MeshGraphNets"
LN_EPS = 1e-5


class MLP(nn.Module):
    """Three linear layers with ReLU between them, then (``layer_norm``)
    a LayerNorm: ``lin_0``, ``lin_1``, ``lin_2``, ``norm``."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int,
                 layer_norm: bool = True):
        super().__init__()
        lin = functools.partial(nn.utils.skip_init, nn.Linear)
        self.lin_0 = lin(d_in, d_hidden)
        self.lin_1 = lin(d_hidden, d_hidden)
        self.lin_2 = lin(d_hidden, d_out)
        self.norm = nn.LayerNorm(d_out, eps=LN_EPS) if layer_norm else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.lin_0, self.lin_1, self.lin_2):
            lecun_init_(layer, generator)
        if self.norm is not None:
            self.norm.reset_parameters()

    def forward(self, x: torch.Tensor, dtype=None,
                last_f32: bool = False) -> torch.Tensor:
        """Products in ``dtype`` (None: x's); the LayerNorm in f32, its
        output rounded to ``dtype``; ``last_f32``: the last layer in f32."""
        h = torch.relu(dense(self.lin_0, x, dtype))
        h = torch.relu(dense(self.lin_1, h, dtype))
        if last_f32:
            return dense(self.lin_2, h.float(), None)
        y = dense(self.lin_2, h, dtype)
        if self.norm is None:
            return y
        out = F.layer_norm(y.float(), self.norm.normalized_shape,
                           self.norm.weight, self.norm.bias, self.norm.eps)
        return out.to(y.dtype)


class Step(nn.Module):
    """One message-passing step: ``edge_mlp`` (input [v_s, v_r, e]) and
    ``node_mlp`` (input [v, Σ e'])."""

    def __init__(self, h: int):
        super().__init__()
        self.edge_mlp = MLP(3 * h, h, h)
        self.node_mlp = MLP(2 * h, h, h)

    @staticmethod
    def _params(m: MLP) -> tuple:
        return (m.lin_0.weight, m.lin_0.bias, m.lin_1.weight, m.lin_1.bias,
                m.lin_2.weight, m.lin_2.bias, m.norm.weight, m.norm.bias)

    def edge_params(self) -> tuple:
        return self._params(self.edge_mlp)

    def node_params(self) -> tuple:
        return self._params(self.node_mlp)


class MeshGraphNet(nn.Module):
    """Parameters are initialized from ``generator`` (a fixed seed when
    None): uniform ±1/√fan_in weights and zero biases, LayerNorms at the
    identity."""

    bn = False    # no BatchNorm statistics to recalibrate

    def __init__(self, config, generator: torch.Generator | None = None):
        super().__init__()
        cfg = config
        if cfg.layer_type != LAYER_TYPE:
            raise ValueError(f"MeshGraphNet takes layer_type {LAYER_TYPE!r}, "
                             f"got {cfg.layer_type!r}")
        if cfg.use_batch_norm:
            raise ValueError("MeshGraphNets takes use_batch_norm=False: its "
                             "LayerNorms belong to the architecture")
        if cfg.dropout:
            raise ValueError("MeshGraphNets takes dropout=0, got "
                             f"{cfg.dropout}")
        if cfg.remat:
            raise ValueError("MeshGraphNets has no remat option")
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("MeshGraphNets takes compute_dtype float32 or "
                             f"bfloat16, got {cfg.compute_dtype!r}")
        if cfg.backend not in ("segment", "dense", "pallas"):
            raise ValueError(f"unknown backend {cfg.backend!r}")
        self.config = cfg
        h = cfg.hidden_dim
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else None)
        self.node_encoder = MLP(cfg.input_dim, h, h)
        self.edge_encoder = MLP(4, h, h)
        self.processor = nn.ModuleList(Step(h) for _ in range(cfg.num_layers))
        self.decoder = MLP(h, h, cfg.output_dim, layer_norm=False)
        self.reset_parameters(
            generator or torch.Generator().manual_seed(0))

    @property
    def head(self) -> nn.Linear:
        """The last linear layer (the trainer's pressure column)."""
        return self.decoder.lin_2

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        mlps = [self.node_encoder, self.edge_encoder]
        for step in self.processor:
            mlps += [step.edge_mlp, step.node_mlp]
        for mlp in mlps + [self.decoder]:
            mlp.reset_parameters(generator)

    def forward(self, graph: Graph, exact_bn: bool = False,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """[N_pad, output_dim]; ``exact_bn`` and ``generator`` are
        FlowGNN's and change nothing here (no BatchNorm, no dropout)."""
        with trace.span("mgn.forward", counters=True, train=train):
            return self._forward(graph)

    def _forward(self, graph: Graph) -> torch.Tensor:
        cfg, dt = self.config, self.dtype
        ne = graph.n_edges
        senders, receivers = graph.senders[:ne], graph.receivers[:ne]
        kernel = cfg.backend == "pallas"
        with trace.span("mgn.encode"):
            v = self.node_encoder(graph.node_feat, dt)
            e = self.edge_encoder(graph.edge_feat[:ne], dt)
        with trace.span("mgn.process"), _SavedBytes(self) as saved:
            s_order = (sender_order(senders, graph.n_pad)
                       if kernel and e.is_cuda and torch.is_grad_enabled()
                       else None)
            for step in self.processor:
                if kernel:
                    e, agg = mgn_edge(v, e, senders, receivers,
                                      *step.edge_params(), s_order=s_order)
                    v = mgn_node(v, agg, *step.node_params())
                else:
                    e, agg = mgn_edge_plain(v, e, senders, receivers,
                                            *step.edge_params())
                    v = mgn_node_plain(v, agg, *step.node_params())
            trace.count("mgn.edge_rows", ne * len(self.processor))
        if saved.bytes:
            trace.count("mgn.saved_bytes", saved.bytes)
        with trace.span("mgn.decode"):
            return self.decoder(v, dt, last_f32=True)


class _SavedBytes(contextlib.AbstractContextManager):
    """Counts the bytes autograd saves for the backward inside the
    context, each storage once and the model's parameters not at all;
    nothing while tracing is off or no gradient is recorded."""

    def __init__(self, model: nn.Module):
        self.bytes = 0
        self._model = model
        self._seen: set = set()
        self._hooks = None

    def _pack(self, t: torch.Tensor):
        if isinstance(t, torch.Tensor):
            key = (t.untyped_storage().data_ptr(), t.device)
            if key not in self._seen:
                self._seen.add(key)
                self.bytes += t.untyped_storage().nbytes()
        return t

    def __enter__(self):
        if torch.is_grad_enabled() and trace.counting():
            # the parameters are kept whatever the backward needs
            self._seen = {(p.untyped_storage().data_ptr(), p.device)
                          for p in self._model.parameters()}
            self._hooks = torch.autograd.graph.saved_tensors_hooks(
                self._pack, lambda t: t)
            self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        if self._hooks is not None:
            self._hooks.__exit__(*exc)
        return False
