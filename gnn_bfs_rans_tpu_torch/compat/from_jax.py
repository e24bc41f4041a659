"""Carry FlowGNN weights between the JAX package's trees and the port.

``state_dict_from_flax`` takes the flax ``params`` / ``batch_stats`` trees
as numpy arrays (nested dicts; any array type convertible by
``numpy.asarray``) and returns the state dict of
:class:`..models.flow_gnn.FlowGNN`; ``flax_tree_from_state_dict`` is its
inverse (numpy trees), e.g. to compare gradients or updated parameters
leaf by leaf.  ``conv_state_dict_from_flax`` and
``conv_flax_from_state_dict`` do the same for one conv's tree, so a conv
built alone (the concat GAT, a conv on one backend) carries its weights.
Layouts:

* flax ``Dense.kernel`` is ``[in, out]``; ``nn.Linear.weight`` is its
  transpose;
* GAT ``conv_i/lin/kernel`` is ``W [F, H·C]`` → ``convs.i.lin.weight``
  ``[H·C, F]``; ``att_src`` / ``att_dst`` ``[1, H, C]`` and ``bias`` (``[C]``,
  or ``[H·C]`` for the concat conv) carry as they are;
* GCN ``conv_i/lin/kernel`` → ``convs.i.lin.weight`` and ``conv_i/bias`` →
  ``convs.i.bias``;
* GIN ``conv_i/mlp_0`` and ``conv_i/mlp_1`` (``kernel``, ``bias``) →
  ``convs.i.nn.0`` and ``convs.i.nn.2`` (PyG's ``Sequential(Linear, ReLU,
  Linear)``);
* Transformer ``conv_i/lin_query|lin_key|lin_value|lin_skip`` (``kernel``,
  ``bias``) and ``conv_i/lin_edge/kernel`` (``use_edge_attr``) →
  ``convs.i.<name>.weight`` (transposed) and ``.bias``;
* BatchNorm ``bn_i`` ``scale`` / ``bias`` and ``batch_stats`` ``mean`` /
  ``var`` → ``norms.i.weight`` / ``bias`` / ``running_mean`` /
  ``running_var``; LayerNorm (``norm_type='layer'``) ``bn_i`` ``scale`` /
  ``bias`` → ``norms.i.scale`` / ``bias``.

``surrogate_state_dict_from_flax`` and ``surrogate_flax_from_state_dict``
do the same for a ``FlowGNNSurrogate``, whose trees hold one FlowGNN tree
under ``encoder`` and one under ``decoder`` (``encoder.`` / ``decoder.``
state-dict prefixes, each stage on its own config).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.flow_gnn import ModelConfig, surrogate_configs


PORTED = ("GCN", "GAT", "GIN", "Transformer")
TRANSFORMER_LINEARS = ("lin_query", "lin_key", "lin_value", "lin_skip")
# GIN's flax MLP layer → the port's Sequential index
GIN_MLP = {"mlp_0": "nn.0", "mlp_1": "nn.2"}


def _check(config: ModelConfig) -> None:
    if config.layer_type not in PORTED:
        raise ValueError(f"unknown layer_type {config.layer_type!r}")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = _t(p["kernel"]).t().contiguous()
    sd[f"{name}.bias"] = _t(p["bias"])


def _kernel(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = _t(p["kernel"]).t().contiguous()


def conv_state_dict_from_flax(layer_type: str, conv: dict,
                              prefix: str = "",
                              edge: bool = False) -> dict[str, torch.Tensor]:
    """One conv's flax tree → its state dict, keys under ``prefix``
    (``"convs.0."`` in a FlowGNN, ``""`` for a conv alone).  ``edge``: the
    Transformer carries ``lin_edge``."""
    if layer_type not in PORTED:
        raise ValueError(f"unknown layer_type {layer_type!r}")
    sd: dict[str, torch.Tensor] = {}
    if layer_type == "GIN":
        for flax_name, name in GIN_MLP.items():
            _linear(sd, f"{prefix}{name}", conv[flax_name])
    elif layer_type == "Transformer":
        for name in TRANSFORMER_LINEARS:
            _linear(sd, f"{prefix}{name}", conv[name])
        if edge:
            _kernel(sd, f"{prefix}lin_edge", conv["lin_edge"])
    else:
        _kernel(sd, f"{prefix}lin", conv["lin"])
        sd[f"{prefix}bias"] = _t(conv["bias"])
    if layer_type == "GAT":
        sd[f"{prefix}att_src"] = _t(conv["att_src"])
        sd[f"{prefix}att_dst"] = _t(conv["att_dst"])
    return sd


def _a(sd: dict, name: str) -> np.ndarray:
    return sd[name].detach().float().cpu().numpy()


def conv_flax_from_state_dict(layer_type: str, sd: dict, prefix: str = "",
                              edge: bool = False) -> dict:
    """Inverse of :func:`conv_state_dict_from_flax`: one conv's numpy tree
    from the state dict entries under ``prefix``."""
    if layer_type not in PORTED:
        raise ValueError(f"unknown layer_type {layer_type!r}")

    def linear(name):
        return {"kernel": _a(sd, f"{prefix}{name}.weight").T.copy(),
                "bias": _a(sd, f"{prefix}{name}.bias")}

    if layer_type == "GIN":
        return {flax_name: linear(name) for flax_name, name in GIN_MLP.items()}
    if layer_type == "Transformer":
        conv = {name: linear(name) for name in TRANSFORMER_LINEARS}
        if edge:
            conv["lin_edge"] = {
                "kernel": _a(sd, f"{prefix}lin_edge.weight").T.copy()}
        return conv
    conv = {"lin": {"kernel": _a(sd, f"{prefix}lin.weight").T.copy()},
            "bias": _a(sd, f"{prefix}bias")}
    if layer_type == "GAT":
        conv["att_src"] = _a(sd, f"{prefix}att_src")
        conv["att_dst"] = _a(sd, f"{prefix}att_dst")
    return conv


def _norm_type(config: ModelConfig) -> str | None:
    """"batch", "layer" or None: the normalization each block carries."""
    if config.use_batch_norm and config.norm_type in ("batch", "layer"):
        return config.norm_type
    return None


def state_dict_from_flax(params: dict, batch_stats: dict,
                         config: ModelConfig) -> dict[str, torch.Tensor]:
    _check(config)
    sd: dict[str, torch.Tensor] = {}
    _linear(sd, "input_proj", params["input_proj"])
    edge = config.layer_type == "Transformer" and config.use_edge_attr
    norm = _norm_type(config)
    for i in range(config.num_layers):
        sd.update(conv_state_dict_from_flax(
            config.layer_type, params[f"conv_{i}"], f"convs.{i}.", edge))
        if norm == "batch":
            bn, st = params[f"bn_{i}"], batch_stats[f"bn_{i}"]
            sd[f"norms.{i}.weight"] = _t(bn["scale"])
            sd[f"norms.{i}.bias"] = _t(bn["bias"])
            sd[f"norms.{i}.running_mean"] = _t(st["mean"])
            sd[f"norms.{i}.running_var"] = _t(st["var"])
        elif norm == "layer":
            sd[f"norms.{i}.scale"] = _t(params[f"bn_{i}"]["scale"])
            sd[f"norms.{i}.bias"] = _t(params[f"bn_{i}"]["bias"])
    for k in range(4):
        _linear(sd, f"out_{k}", params[f"out_{k}"])
    return sd


def flax_tree_from_state_dict(sd: dict, config: ModelConfig
                              ) -> tuple[dict, dict]:
    """(params, batch_stats) numpy trees in the JAX package's layout from a
    port state dict (or a dict of per-parameter gradients)."""
    _check(config)

    def linear(name):
        return {"kernel": _a(sd, f"{name}.weight").T.copy(),
                "bias": _a(sd, f"{name}.bias")}

    params = {"input_proj": linear("input_proj")}
    stats = {}
    edge = config.layer_type == "Transformer" and config.use_edge_attr
    norm = _norm_type(config)
    for i in range(config.num_layers):
        params[f"conv_{i}"] = conv_flax_from_state_dict(
            config.layer_type, sd, f"convs.{i}.", edge)
        if norm == "batch":
            params[f"bn_{i}"] = {"scale": _a(sd, f"norms.{i}.weight"),
                                 "bias": _a(sd, f"norms.{i}.bias")}
            if f"norms.{i}.running_mean" in sd:
                stats[f"bn_{i}"] = {"mean": _a(sd, f"norms.{i}.running_mean"),
                                    "var": _a(sd, f"norms.{i}.running_var")}
        elif norm == "layer":
            params[f"bn_{i}"] = {"scale": _a(sd, f"norms.{i}.scale"),
                                 "bias": _a(sd, f"norms.{i}.bias")}
    for k in range(4):
        params[f"out_{k}"] = linear(f"out_{k}")
    return params, stats


SURROGATE_STAGES = ("encoder", "decoder")


def surrogate_state_dict_from_flax(params: dict, batch_stats: dict,
                                   config: ModelConfig
                                   ) -> dict[str, torch.Tensor]:
    """A ``FlowGNNSurrogate``'s flax trees → its state dict."""
    sd: dict[str, torch.Tensor] = {}
    for stage, cfg in zip(SURROGATE_STAGES, surrogate_configs(config)):
        sd.update({f"{stage}.{k}": v for k, v in state_dict_from_flax(
            params[stage], batch_stats.get(stage, {}), cfg).items()})
    return sd


def surrogate_flax_from_state_dict(sd: dict, config: ModelConfig
                                   ) -> tuple[dict, dict]:
    """Inverse of :func:`surrogate_state_dict_from_flax`: (params,
    batch_stats) numpy trees (a stage without statistics has none)."""
    params, stats = {}, {}
    for stage, cfg in zip(SURROGATE_STAGES, surrogate_configs(config)):
        prefix = f"{stage}."
        p, b = flax_tree_from_state_dict(
            {k[len(prefix):]: v for k, v in sd.items()
             if k.startswith(prefix)}, cfg)
        params[stage] = p
        if b:
            stats[stage] = b
    return params, stats
