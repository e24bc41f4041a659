"""Carry FlowGNN weights between the JAX package's trees and the port.

``state_dict_from_flax`` takes the flax ``params`` / ``batch_stats`` trees
as numpy arrays (nested dicts; any array type convertible by
``numpy.asarray``) and returns the state dict of
:class:`..models.flow_gnn.FlowGNN`; ``flax_tree_from_state_dict`` is its
inverse (numpy trees), e.g. to compare gradients or updated parameters
leaf by leaf.  Layouts:

* flax ``Dense.kernel`` is ``[in, out]``; ``nn.Linear.weight`` is its
  transpose;
* GAT ``conv_i/lin/kernel`` is ``W [F, H·C]`` → ``convs.i.lin.weight``
  ``[H·C, F]``; ``att_src`` / ``att_dst`` ``[1, H, C]`` and ``bias`` ``[C]``
  carry as they are;
* GCN ``conv_i/lin/kernel`` → ``convs.i.lin.weight`` and ``conv_i/bias`` →
  ``convs.i.bias``;
* GIN ``conv_i/mlp_0`` and ``conv_i/mlp_1`` (``kernel``, ``bias``) →
  ``convs.i.nn.0`` and ``convs.i.nn.2`` (PyG's ``Sequential(Linear, ReLU,
  Linear)``);
* Transformer ``conv_i/lin_query|lin_key|lin_value|lin_skip`` (``kernel``,
  ``bias``) and ``conv_i/lin_edge/kernel`` (``use_edge_attr``) →
  ``convs.i.<name>.weight`` (transposed) and ``.bias``;
* ``bn_i`` ``scale`` / ``bias`` and ``batch_stats`` ``mean`` / ``var`` →
  ``norms.i.weight`` / ``bias`` / ``running_mean`` / ``running_var``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.flow_gnn import ModelConfig


PORTED = ("GCN", "GAT", "GIN", "Transformer")
TRANSFORMER_LINEARS = ("lin_query", "lin_key", "lin_value", "lin_skip")
# GIN's flax MLP layer → the port's Sequential index
GIN_MLP = {"mlp_0": "nn.0", "mlp_1": "nn.2"}


def _check(config: ModelConfig) -> None:
    if config.layer_type not in PORTED:
        raise NotImplementedError(
            f"layer_type {config.layer_type!r} is not ported yet (GCN, GAT, "
            "GIN and Transformer are)")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = _t(p["kernel"]).t().contiguous()
    sd[f"{name}.bias"] = _t(p["bias"])


def state_dict_from_flax(params: dict, batch_stats: dict,
                         config: ModelConfig) -> dict[str, torch.Tensor]:
    _check(config)
    sd: dict[str, torch.Tensor] = {}
    _linear(sd, "input_proj", params["input_proj"])
    for i in range(config.num_layers):
        conv = params[f"conv_{i}"]
        if config.layer_type == "GIN":
            for flax_name, name in GIN_MLP.items():
                _linear(sd, f"convs.{i}.{name}", conv[flax_name])
        elif config.layer_type == "Transformer":
            for name in TRANSFORMER_LINEARS:
                _linear(sd, f"convs.{i}.{name}", conv[name])
            if config.use_edge_attr:
                sd[f"convs.{i}.lin_edge.weight"] = _t(
                    conv["lin_edge"]["kernel"]).t().contiguous()
        else:
            sd[f"convs.{i}.lin.weight"] = _t(conv["lin"]["kernel"]).t().contiguous()
            sd[f"convs.{i}.bias"] = _t(conv["bias"])
        if config.layer_type == "GAT":
            sd[f"convs.{i}.att_src"] = _t(conv["att_src"])
            sd[f"convs.{i}.att_dst"] = _t(conv["att_dst"])
        if config.use_batch_norm and config.norm_type == "batch":
            bn, st = params[f"bn_{i}"], batch_stats[f"bn_{i}"]
            sd[f"norms.{i}.weight"] = _t(bn["scale"])
            sd[f"norms.{i}.bias"] = _t(bn["bias"])
            sd[f"norms.{i}.running_mean"] = _t(st["mean"])
            sd[f"norms.{i}.running_var"] = _t(st["var"])
    for k in range(4):
        _linear(sd, f"out_{k}", params[f"out_{k}"])
    return sd


def flax_tree_from_state_dict(sd: dict, config: ModelConfig
                              ) -> tuple[dict, dict]:
    """(params, batch_stats) numpy trees in the JAX package's layout from a
    port state dict (or a dict of per-parameter gradients)."""
    _check(config)

    def a(name):
        return sd[name].detach().float().cpu().numpy()

    def linear(name):
        return {"kernel": a(f"{name}.weight").T.copy(),
                "bias": a(f"{name}.bias")}

    params = {"input_proj": linear("input_proj")}
    stats = {}
    for i in range(config.num_layers):
        if config.layer_type == "GIN":
            conv = {flax_name: linear(f"convs.{i}.{name}")
                    for flax_name, name in GIN_MLP.items()}
        elif config.layer_type == "Transformer":
            conv = {name: linear(f"convs.{i}.{name}")
                    for name in TRANSFORMER_LINEARS}
            if config.use_edge_attr:
                conv["lin_edge"] = {
                    "kernel": a(f"convs.{i}.lin_edge.weight").T.copy()}
        else:
            conv = {"lin": {"kernel": a(f"convs.{i}.lin.weight").T.copy()},
                    "bias": a(f"convs.{i}.bias")}
        if config.layer_type == "GAT":
            conv["att_src"] = a(f"convs.{i}.att_src")
            conv["att_dst"] = a(f"convs.{i}.att_dst")
        params[f"conv_{i}"] = conv
        if config.use_batch_norm and config.norm_type == "batch":
            params[f"bn_{i}"] = {"scale": a(f"norms.{i}.weight"),
                                 "bias": a(f"norms.{i}.bias")}
            if f"norms.{i}.running_mean" in sd:
                stats[f"bn_{i}"] = {"mean": a(f"norms.{i}.running_mean"),
                                    "var": a(f"norms.{i}.running_var")}
    for k in range(4):
        params[f"out_{k}"] = linear(f"out_{k}")
    return params, stats
