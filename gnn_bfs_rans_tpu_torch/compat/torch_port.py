"""The reference's ``.pt`` checkpoint format, read and written by the port.

Counterpart of ``gnn_bfs_rans_tpu/compat/torch_port.py``.  A checkpoint
that the reference's ``train.py`` saves (``train.py:453-461``: a dict with
``epoch``, ``model_state_dict``, ``optimizer_state_dict``, ``val_loss``,
``config`` and ``normalizer``) is served by the port, and a port
checkpoint is written back in that format for the reference's
``inference.py`` (``:20-59``) to load.

One name mapping serves both directions.  The PyG state dict maps onto the
JAX package's parameter tree by a numpy copy of that package's mapping
(:func:`flax_tree_from_reference`, :func:`reference_from_flax_tree`), and
the tree maps onto the port's ``FlowGNN`` state dict by
:mod:`.from_jax`.  PyG names (``gnn_model.py``):

* ``input_proj.weight|bias``            → ``input_proj.kernel|bias``
* ``gnn_layers.{i}.…`` by conv type:
  - GCNConv: ``lin.weight``, ``bias``
  - GATConv: ``lin.weight`` (``lin_src.weight`` in older PyG),
    ``att_src``, ``att_dst``, ``bias``
  - GINConv: ``nn.0.weight|bias``, ``nn.2.weight|bias`` (``eps`` a buffer)
  - TransformerConv: ``lin_query|lin_key|lin_value|lin_skip.weight|bias``
    (+ ``lin_edge.weight`` when ``edge_dim`` is set)
* ``batch_norms.{i}.module.weight|bias|running_mean|running_var``
  → ``bn_{i}`` and its batch statistics
* ``output_proj.{0,3,6,8}.weight|bias`` → ``out_0..out_3``

``Linear.weight`` is ``[out, in]``; the tree's ``kernel`` is ``[in, out]``.

What the format cannot express raises: a LayerNorm model
(``norm_type='layer'``; the reference has BatchNorm or nothing) and a
nonzero GIN ``eps`` (the reference builds ``GINConv`` with ``eps`` fixed
at 0, and so does the port).  A Transformer with edge attributes
(``use_edge_attr``, the ``ModelConfig`` default) is written with its
``lin_edge`` weights and ``config['edge_dim']``: the reference's
``inference.py`` builds ``TransformerConv`` without ``edge_dim``, so it
loads such a file strictly only when it passes that ``edge_dim`` on
(as ``RefFlowGNN(edge_dim=...)`` does).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models.flow_gnn import ModelConfig
from ..train.normalization import FieldNormalizer
from .from_jax import flax_tree_from_state_dict, state_dict_from_flax

# the output MLP's Linear layers: Sequential indices 0, 3, 6, 8
OUT_LAYERS = (("out_0", 0), ("out_1", 3), ("out_2", 6), ("out_3", 8))
TRANSFORMER_LINEARS = ("lin_query", "lin_key", "lin_value", "lin_skip")


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, dtype=np.float32).T)


def _a(w) -> np.ndarray:
    return np.asarray(w, dtype=np.float32)


def _get(sd: dict, *names: str):
    for n in names:
        if n in sd:
            return sd[n]
    raise KeyError(f"none of {names} in state dict (have {sorted(sd)[:8]}...)")


def _layer_type(config: ModelConfig) -> str:
    if config.layer_type == "MeshGraphNets":
        raise ValueError("MeshGraphNets has no reference .pt format: "
                         "export-torch takes FlowGNN layers only")
    if config.layer_type not in ("GCN", "GAT", "GIN", "Transformer"):
        raise ValueError(f"unknown layer type {config.layer_type}")
    return config.layer_type


def flax_tree_from_reference(state_dict: dict[str, Any], config: ModelConfig
                             ) -> tuple[dict, dict]:
    """PyG state dict → (params, batch_stats) numpy trees in the JAX
    package's layout (its ``convert_state_dict``)."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    layer_type = _layer_type(config)
    params: dict[str, Any] = {"input_proj": {
        "kernel": _t(sd["input_proj.weight"]),
        "bias": _a(sd["input_proj.bias"])}}
    batch_stats: dict[str, Any] = {}
    for i in range(config.num_layers):
        p = f"gnn_layers.{i}."
        layer_sd = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
        if layer_type == "GCN":
            conv = {"lin": {"kernel": _t(_get(layer_sd, "lin.weight"))},
                    "bias": _a(layer_sd["bias"])}
        elif layer_type == "GAT":
            lin_w = _get(layer_sd, "lin.weight", "lin_src.weight",
                         "lin_l.weight")
            conv = {"lin": {"kernel": _t(lin_w)},
                    "att_src": _a(layer_sd["att_src"]),
                    "att_dst": _a(layer_sd["att_dst"]),
                    "bias": _a(layer_sd["bias"])}
        elif layer_type == "GIN":
            conv = {f"mlp_{j}": {"kernel": _t(layer_sd[f"nn.{k}.weight"]),
                                 "bias": _a(layer_sd[f"nn.{k}.bias"])}
                    for j, k in ((0, 0), (1, 2))}
            if "eps" in layer_sd and abs(float(_a(layer_sd["eps"]).reshape(
                    ()))) > 0:
                raise ValueError(f"gnn_layers.{i}.eps is nonzero: the "
                                 "port's GINConv fixes eps at 0, as the "
                                 "reference builds it")
        else:
            conv = {name: {"kernel": _t(layer_sd[f"{name}.weight"]),
                           "bias": _a(layer_sd[f"{name}.bias"])}
                    for name in TRANSFORMER_LINEARS}
            if "lin_edge.weight" in layer_sd:
                conv["lin_edge"] = {"kernel": _t(layer_sd["lin_edge.weight"])}
        params[f"conv_{i}"] = conv

        bnp = f"batch_norms.{i}."
        bn_sd = {k[len(bnp):]: v for k, v in sd.items() if k.startswith(bnp)}
        if bn_sd:
            params[f"bn_{i}"] = {
                "scale": _a(_get(bn_sd, "module.weight", "weight")),
                "bias": _a(_get(bn_sd, "module.bias", "bias"))}
            batch_stats[f"bn_{i}"] = {
                "mean": _a(_get(bn_sd, "module.running_mean",
                                "running_mean")),
                "var": _a(_get(bn_sd, "module.running_var", "running_var"))}
    for name, idx in OUT_LAYERS:
        params[name] = {"kernel": _t(sd[f"output_proj.{idx}.weight"]),
                        "bias": _a(sd[f"output_proj.{idx}.bias"])}
    return params, batch_stats


def reference_from_flax_tree(params: dict, batch_stats: dict,
                             config: ModelConfig) -> dict[str, np.ndarray]:
    """(params, batch_stats) trees → PyG state dict (the JAX package's
    ``export_state_dict``), with the ``eps`` buffer a reference GIN carries,
    so the result loads into the reference model with ``strict=True``."""
    layer_type = _layer_type(config)
    if config.use_batch_norm and config.norm_type == "layer":
        raise ValueError("the reference format has no LayerNorm "
                         "(norm_type='layer')")
    sd: dict[str, np.ndarray] = {
        "input_proj.weight": _t(params["input_proj"]["kernel"]),
        "input_proj.bias": _a(params["input_proj"]["bias"]),
    }
    for i in range(config.num_layers):
        conv = params[f"conv_{i}"]
        p = f"gnn_layers.{i}."
        if layer_type in ("GCN", "GAT"):
            sd[p + "lin.weight"] = _t(conv["lin"]["kernel"])
            if layer_type == "GAT":
                sd[p + "att_src"] = _a(conv["att_src"])
                sd[p + "att_dst"] = _a(conv["att_dst"])
            sd[p + "bias"] = _a(conv["bias"])
        elif layer_type == "GIN":
            for j, k in ((0, 0), (1, 2)):
                sd[p + f"nn.{k}.weight"] = _t(conv[f"mlp_{j}"]["kernel"])
                sd[p + f"nn.{k}.bias"] = _a(conv[f"mlp_{j}"]["bias"])
            sd[p + "eps"] = np.zeros(1, np.float32)
        else:
            for lin in TRANSFORMER_LINEARS:
                sd[p + f"{lin}.weight"] = _t(conv[lin]["kernel"])
                sd[p + f"{lin}.bias"] = _a(conv[lin]["bias"])
            if "lin_edge" in conv:
                sd[p + "lin_edge.weight"] = _t(conv["lin_edge"]["kernel"])
        if f"bn_{i}" in params:
            bp = f"batch_norms.{i}.module."
            bs = batch_stats.get(f"bn_{i}", {})
            sd[bp + "weight"] = _a(params[f"bn_{i}"]["scale"])
            sd[bp + "bias"] = _a(params[f"bn_{i}"]["bias"])
            sd[bp + "running_mean"] = _a(
                bs.get("mean", np.zeros(config.hidden_dim)))
            sd[bp + "running_var"] = _a(
                bs.get("var", np.ones(config.hidden_dim)))
            # BatchNorm1d's batch counter, which only momentum=None reads
            sd[bp + "num_batches_tracked"] = np.zeros((), np.int64)
    for name, idx in OUT_LAYERS:
        sd[f"output_proj.{idx}.weight"] = _t(params[name]["kernel"])
        sd[f"output_proj.{idx}.bias"] = _a(params[name]["bias"])
    return sd


def convert_state_dict(state_dict: dict[str, Any], config: ModelConfig
                       ) -> dict[str, torch.Tensor]:
    """PyG state dict → the port's ``FlowGNN`` state dict (CPU, f32)."""
    return state_dict_from_flax(*flax_tree_from_reference(state_dict, config),
                                config)


def export_state_dict(state_dict: dict[str, torch.Tensor],
                      config: ModelConfig) -> dict[str, torch.Tensor]:
    """The port's ``FlowGNN`` state dict → PyG state dict of CPU tensors
    (inverse of :func:`convert_state_dict`)."""
    params, stats = flax_tree_from_state_dict(state_dict, config)
    return {k: torch.from_numpy(np.array(v))
            for k, v in reference_from_flax_tree(params, stats,
                                                 config).items()}


def save_torch_checkpoint(
    path: str | Path,
    state_dict: dict[str, torch.Tensor],
    config: ModelConfig,
    normalizer: FieldNormalizer | None = None,
    epoch: int = 0,
    val_loss: float = float("nan"),
    train_config: Any = None,
) -> None:
    """Write a reference-format ``.pt`` (``train.py:453-461``), loadable by
    the reference's ``load_model`` (``inference.py:20-59``) on a machine
    without a card, and by :func:`load_torch_checkpoint`.

    ``optimizer_state_dict`` is written empty: Adam's moments have no
    positional mapping onto the reference's parameter-id keyed state, and no
    reference loader reads it.  A Transformer with ``lin_edge`` gets
    ``config['edge_dim']``, the width its ``TransformerConv`` must be built
    with (see the module docstring).
    """
    sd = export_state_dict(state_dict, config)
    cfg = {"hidden_dim": config.hidden_dim, "num_layers": config.num_layers,
           "layer_type": config.layer_type, "dropout": config.dropout}
    if "gnn_layers.0.lin_edge.weight" in sd:
        cfg["edge_dim"] = int(sd["gnn_layers.0.lin_edge.weight"].shape[1])
    if train_config is not None:
        t = (train_config.to_dict() if hasattr(train_config, "to_dict")
             else dict(train_config))
        for k in ("lr", "weight_decay", "batch_size", "epochs",
                  "pressure_ref_weight", "curriculum_epochs", "save_every"):
            if k in t:
                cfg[k] = t[k]
    norm_data = None
    if normalizer is not None:
        norm_data = {"field_stats": normalizer.field_stats,
                     "scalers": normalizer.scalers}
    torch.save({
        "epoch": int(epoch),
        "model_state_dict": sd,
        "optimizer_state_dict": {},
        "val_loss": float(val_loss),
        "config": cfg,
        "normalizer": norm_data,
    }, path)


def load_torch_checkpoint(path: str | Path) -> tuple[
        dict[str, torch.Tensor], ModelConfig, FieldNormalizer | None]:
    """A reference ``.pt`` → (the port's ``FlowGNN`` state dict, its
    ``ModelConfig``, the normalizer or None).

    The reference's config dict (``vars(args)``, ``train.py:300``) lacks
    some architecture facts; they are read from the weights, as the JAX
    package does: input and output width, heads (from ``att_src`` or
    ``lin_query``) and ``use_edge_attr`` (``lin_edge`` present: the reference
    builds ``TransformerConv`` without ``edge_dim``, so its checkpoints have
    none).  Dropout is 0 for serving.  The file holds numpy arrays (the
    normalizer's scalers), so it is read with ``weights_only=False``: load
    only checkpoints you trust.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    cfg_dict = ckpt.get("config", {})
    sd = {k: _np(v) for k, v in ckpt["model_state_dict"].items()}
    hidden = int(cfg_dict.get("hidden_dim", 256))
    heads = 4
    if "gnn_layers.0.att_src" in sd:
        heads = int(sd["gnn_layers.0.att_src"].shape[1])
    elif "gnn_layers.0.lin_query.weight" in sd:
        heads = int(sd["gnn_layers.0.lin_query.weight"].shape[0]) // hidden
    config = ModelConfig(
        input_dim=int(sd["input_proj.weight"].shape[1]),
        hidden_dim=hidden,
        output_dim=int(sd["output_proj.8.weight"].shape[0]),
        num_layers=int(cfg_dict.get("num_layers", 6)),
        layer_type=cfg_dict.get("layer_type", "GCN"),
        heads=heads,
        use_edge_attr="gnn_layers.0.lin_edge.weight" in sd,
        dropout=0.0,
    )
    state = convert_state_dict(sd, config)
    normalizer = None
    norm_data = ckpt.get("normalizer")
    if norm_data:
        normalizer = FieldNormalizer()
        normalizer.field_stats = norm_data.get("field_stats", {})
        normalizer.scalers = norm_data.get("scalers", {})
    return state, config, normalizer
