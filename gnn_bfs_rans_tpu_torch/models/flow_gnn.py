"""FlowGNN — the flow-surrogate model.

Counterpart of ``gnn_bfs_rans_tpu/models/flow_gnn.py::FlowGNN``:
``Linear(3→H)`` input projection, ``L`` blocks of {conv, residual add,
normalization, ReLU, dropout}, and the output MLP ``H→H→H→H/2→out``.  The
conv is ``GCNConv``, ``GATConv``, ``GINConv`` or ``TransformerConv`` by
``layer_type`` (dispatch as in ``flow_gnn.py:130-153``; GCN and GIN take no
training flag or seed; the Transformer is edge-conditioned with
``use_edge_attr``, takes ``fuse_eval`` and, as GAT, the attention dropout),
each on ``backend`` (``pallas``, ``dense`` or ``segment``, the convs'
routing).  Output layout is ``[U(3), p, k, epsilon, nut]``.  Dtype rules
are the JAX module's (``flow_gnn.py:56-66, 108-153``): ``bfloat16`` runs
everything but the final head in bf16 (the convs' products; a dense or
segment conv's f32 output turns the residual stream f32, as in JAX);
``mixed`` runs the convs and the MLP in bf16 on an f32 residual stream;
parameters stay f32.

The block's epilogue is the fused kernel op (``norm.MaskedBatchNorm``'s
``train_forward`` in training, ``batch_forward`` under ``exact_bn``)
exactly where the JAX module's ``fused_ep`` holds: BatchNorm,
``fuse_epilogue`` and ``backend='pallas'``.  Everywhere else it is the
unfused chain of ``flow_gnn.py:170-190``: the residual add, then
BatchNorm (running statistics in eval, the batch statistics of the real
rows in training and under ``exact_bn``), LayerNorm (``norm_type='layer'``,
in f32 under ``mixed``) or nothing, then ReLU and dropout.

``forward(graph, exact_bn=True)`` is the deterministic train-mode forward
the JAX package's ``make_forward(exact_bn=True)`` runs: batch statistics of
the input graph, running statistics untouched.  ``forward(graph,
train=True, generator=g)`` is the training forward (``flow_gnn.py:100-202``
with ``train=True``): the differentiable conv ops and epilogue with their
dropout, each layer's kernel seeds, the dense and segment convs' attention
masks and the flax-style dropout masks drawn from the explicit ``g``
(never the global RNG), and the running BatchNorm statistics updated.
Without a generator the training forward is deterministic (the JAX
package's dropout-free train-mode forward of the recalibration).

``remat`` (the JAX module's ``nn.remat`` of each conv,
``flow_gnn.py:122-128``): in a training forward that records gradients
each conv runs under ``torch.utils.checkpoint`` (non-reentrant), which
keeps its input and recomputes its activations in the backward.  The
kernel convs take their dropout seed as an input, drawn before the conv,
so the recompute sees it again; the dense and segment convs draw their
attention masks inside the conv, so they draw through a
``kernels/dropout.py::MaskTape``, which replays the forward's masks in the
recompute.  The step then equals the step without remat, and leaves the
generator where that step leaves it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..graph.structs import Graph
from ..kernels.dropout import MaskTape, draw_seed
from .convs import (GATConv, GCNConv, GINConv, TransformerConv, dense,
                    lecun_init_)
from .norm import LayerNorm, MaskedBatchNorm

# the edge features every graph of the system carries: [unit dir xyz, dist]
EDGE_DIM = 4
FIELD_SLICES = {"U": (0, 3), "p": (3, 4), "k": (4, 5), "epsilon": (5, 6), "nut": (6, 7)}
FIELD_NAMES = tuple(FIELD_SLICES)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX package's ``ModelConfig`` fields, so its meta files parse."""

    input_dim: int = 3
    hidden_dim: int = 256
    output_dim: int = 7
    num_layers: int = 6
    layer_type: str = "GCN"
    heads: int = 4
    dropout: float = 0.1
    use_batch_norm: bool = True
    norm_type: str = "batch"
    use_edge_attr: bool = True
    backend: str = "dense"
    compute_dtype: str = "float32"
    fuse_eval: bool = False
    fuse_train: bool = True
    fuse_epilogue: bool = True
    # each conv rematerialized in training (torch.utils.checkpoint, the JAX
    # package's nn.remat): its activations recomputed in the backward
    remat: bool = False

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class FlowGNN(nn.Module):
    """Parameters are initialized from ``generator`` (a fixed seed when
    None), never from the global RNG."""

    def __init__(self, config: ModelConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = config
        if cfg.layer_type == "MeshGraphNets":
            raise ValueError(
                "MeshGraphNets is not a FlowGNN conv: build it with "
                "models.build_model; partitioned, multi-topology and "
                "surrogate models take FlowGNN layers only")
        if cfg.layer_type not in ("GCN", "GAT", "GIN", "Transformer"):
            raise ValueError(f"unknown layer_type {cfg.layer_type!r}")
        self.bn = cfg.use_batch_norm and cfg.norm_type == "batch"
        self.ln = cfg.use_batch_norm and cfg.norm_type == "layer"
        if cfg.use_batch_norm and cfg.norm_type not in ("batch", "layer",
                                                        "none"):
            raise ValueError(f"unknown norm_type {cfg.norm_type!r}")
        if cfg.compute_dtype not in ("float32", "bfloat16", "mixed"):
            raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
        if cfg.backend not in ("segment", "dense", "pallas"):
            raise ValueError(f"unknown backend {cfg.backend!r}")
        self.config = cfg
        # the fused epilogue runs where the JAX module's fused_ep holds (in
        # training and under exact_bn)
        self.fused_ep = (self.bn and cfg.fuse_epilogue
                         and cfg.backend == "pallas")
        h = cfg.hidden_dim
        mixed = cfg.compute_dtype == "mixed"
        # the products' dtype (the flax modules' ``dtype``): None is f32
        self.dtype = dtype = (torch.bfloat16 if cfg.compute_dtype
                              in ("bfloat16", "mixed") else None)
        lin = functools.partial(nn.utils.skip_init, nn.Linear)
        self.input_proj = lin(cfg.input_dim, h)
        common = dict(backend=cfg.backend, dtype=dtype)

        def conv():
            if cfg.layer_type == "GAT":
                return GATConv(h, heads=cfg.heads, dropout=cfg.dropout,
                               fuse_train=cfg.fuse_train, **common)
            if cfg.layer_type == "Transformer":
                return TransformerConv(
                    h, heads=cfg.heads, concat=False,
                    edge_dim=EDGE_DIM if cfg.use_edge_attr else None,
                    fuse_eval=cfg.fuse_eval, dropout=cfg.dropout, **common)
            return (GCNConv(h, **common) if cfg.layer_type == "GCN"
                    else GINConv(h, **common))

        self.convs = nn.ModuleList(conv() for _ in range(cfg.num_layers))
        n_norms = cfg.num_layers if (self.bn or self.ln) else 0
        self.norms = nn.ModuleList(
            MaskedBatchNorm(h) if self.bn
            else LayerNorm(h, dtype=None if mixed else dtype)
            for _ in range(n_norms))
        self.out_0 = lin(h, h)
        self.out_1 = lin(h, h)
        self.out_2 = lin(h, h // 2)
        self.out_3 = lin(h // 2, cfg.output_dim)
        self.reset_parameters(
            generator or torch.Generator().manual_seed(0))

    @property
    def head(self) -> nn.Linear:
        """The last linear layer (the trainer's pressure column)."""
        return self.out_3

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's init for the linear layers (uniform ±1/√fan_in,
        zero bias); BatchNorm starts at the identity affine."""
        for layer in (self.input_proj, self.out_0, self.out_1, self.out_2,
                      self.out_3):
            lecun_init_(layer, generator)
        for conv in self.convs:
            conv.reset_parameters(generator)

    def forward(self, graph: Graph, exact_bn: bool = False,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.config
        if (cfg.layer_type == "Transformer" and cfg.use_edge_attr
                and graph.edge_feat.shape[1] != EDGE_DIM):
            raise ValueError(f"the Transformer takes {EDGE_DIM} edge "
                             f"features, got {graph.edge_feat.shape[1]}")
        rate = cfg.dropout if (train and generator is not None) else 0.0
        mixed = cfg.compute_dtype == "mixed"
        dtype = self.dtype
        dev = graph.node_feat.device

        def seed():
            return draw_seed(generator, dev) if rate > 0 else None

        # the dense and segment convs' attention masks
        conv_gen = generator if rate > 0 else None

        x = dense(self.input_proj, graph.node_feat, dtype)
        if mixed:
            # f32 residual stream; convs see bf16, their outputs rejoin in f32
            x = x.float()
        remat = cfg.remat and train and torch.is_grad_enabled()
        for i, conv in enumerate(self.convs):
            x_in = x.to(torch.bfloat16) if mixed else x
            if cfg.layer_type == "GAT":
                kw = dict(train=train, seed=seed(), generator=conv_gen)
            elif cfg.layer_type == "Transformer":
                # the JAX package runs exact_bn (and the recalibration) in
                # train mode, where fuse_eval does not apply
                kw = dict(train=train, seed=seed(),
                          fused_ok=not (train or exact_bn),
                          generator=conv_gen)
            else:
                kw = {}
            x_new = (_remat(conv, x_in, graph, kw) if remat
                     else conv(x_in, graph, **kw))
            if mixed:
                x_new = x_new.float()
            if self.fused_ep and train:
                x = self.norms[i].train_forward(x, x_new, graph.n_nodes, rate,
                                                seed())
                continue
            if self.fused_ep and exact_bn:
                x = self.norms[i].batch_forward(x, x_new, graph.n_nodes)
                continue
            x = x + x_new
            if self.bn and (train or exact_bn):
                x = self.norms[i].batch_norm(x, graph.node_mask, update=train)
            elif self.bn or self.ln:
                x = self.norms[i](x)
            x = self._dropout(torch.relu(x), rate, generator)
        h = torch.relu(dense(self.out_0, x, dtype))
        h = self._dropout(h, rate, generator)
        h = torch.relu(dense(self.out_1, h, dtype))
        h = self._dropout(h, rate, generator)
        h = torch.relu(dense(self.out_2, h, dtype))
        # the final head always runs in float32
        return dense(self.out_3, h.float(), None)

    @staticmethod
    def _dropout(h: torch.Tensor, rate: float,
                 generator: torch.Generator | None) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability 1 − rate, scale by
        1/(1 − rate) (the divisor rounded to h's dtype, as flax's weakly
        typed scalar is), masks from ``generator``."""
        if rate <= 0:
            return h
        keep = 1.0 - rate
        mask = torch.rand(h.shape, generator=generator,
                          device=h.device) < keep
        div = float(torch.tensor(keep).to(h.dtype))
        return torch.where(mask, h / div, torch.zeros_like(h))


def _remat(conv: nn.Module, x: torch.Tensor, graph: Graph,
           kw: dict) -> torch.Tensor:
    """``conv(x, graph, **kw)`` under ``torch.utils.checkpoint``, its
    attention masks drawn through a :class:`MaskTape` (see the module
    doc)."""
    gen = kw.get("generator")
    tape = MaskTape(gen) if gen is not None else None

    def run(x):
        if tape is None:
            return conv(x, graph, **kw)
        tape.rewind()
        return conv(x, graph, **{**kw, "generator": tape})

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def surrogate_configs(config: ModelConfig
                      ) -> tuple[ModelConfig, ModelConfig]:
    """The encoder's and the decoder's configs of a
    :class:`FlowGNNSurrogate` (JAX ``flow_gnn.py:228-235``): ``num_layers
    // 2`` blocks each (at least one); the encoder emits ``hidden_dim``
    features, the decoder takes them."""
    half = max(config.num_layers // 2, 1)
    return (dataclasses.replace(config, output_dim=config.hidden_dim,
                                num_layers=half),
            dataclasses.replace(config, input_dim=config.hidden_dim,
                                num_layers=half))


class FlowGNNSurrogate(nn.Module):
    """Encoder-decoder surrogate with an optional additive boundary
    embedding: the counterpart of ``flow_gnn.py:213-243``
    (``FlowGNNSurrogate``, the reference's ``gnn_model.py:223-291``).

    Two :class:`FlowGNN` stages of :func:`surrogate_configs`;
    ``boundary_conditions`` [N_pad, hidden_dim] is added to the encoder's
    output, and the decoder runs on the same graph with that output as its
    node features (band planes and all: the Transformer's geo planes come
    from the mesh).  The encoder's head emits f32, so in bf16 and
    ``mixed`` the decoder's input projection takes an f32 input.
    ``exact_bn``, ``train`` and ``generator`` are :meth:`FlowGNN.forward`'s,
    passed to both stages; both are initialized from ``generator`` (a
    fixed seed when None), the encoder first."""

    def __init__(self, config: ModelConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        gen = generator or torch.Generator().manual_seed(0)
        enc, dec = surrogate_configs(config)
        self.encoder = FlowGNN(enc, gen)
        self.decoder = FlowGNN(dec, gen)

    def forward(self, graph: Graph,
                boundary_conditions: torch.Tensor | None = None,
                exact_bn: bool = False, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        kw = dict(exact_bn=exact_bn, train=train, generator=generator)
        encoded = self.encoder(graph, **kw)
        if boundary_conditions is not None:
            encoded = encoded + boundary_conditions
        return self.decoder(dataclasses.replace(graph, node_feat=encoded),
                            **kw)


def split_fields(output):
    """Slice model output into named fields (tensor or numpy)."""
    fields = {name: output[:, a:b] for name, (a, b) in FIELD_SLICES.items()}
    if output.shape[1] > 7:
        fields["residual"] = output[:, 7:8]
    return fields
