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
* ``bn_i`` ``scale`` / ``bias`` and ``batch_stats`` ``mean`` / ``var`` →
  ``norms.i.weight`` / ``bias`` / ``running_mean`` / ``running_var``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.flow_gnn import ModelConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = _t(p["kernel"]).t().contiguous()
    sd[f"{name}.bias"] = _t(p["bias"])


def state_dict_from_flax(params: dict, batch_stats: dict,
                         config: ModelConfig) -> dict[str, torch.Tensor]:
    if config.layer_type != "GAT":
        raise NotImplementedError(
            f"layer_type {config.layer_type!r} is not ported yet (GAT only)")
    sd: dict[str, torch.Tensor] = {}
    _linear(sd, "input_proj", params["input_proj"])
    for i in range(config.num_layers):
        conv = params[f"conv_{i}"]
        sd[f"convs.{i}.lin.weight"] = _t(conv["lin"]["kernel"]).t().contiguous()
        sd[f"convs.{i}.att_src"] = _t(conv["att_src"])
        sd[f"convs.{i}.att_dst"] = _t(conv["att_dst"])
        sd[f"convs.{i}.bias"] = _t(conv["bias"])
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
    if config.layer_type != "GAT":
        raise NotImplementedError(
            f"layer_type {config.layer_type!r} is not ported yet (GAT only)")

    def a(name):
        return sd[name].detach().float().cpu().numpy()

    def linear(name):
        return {"kernel": a(f"{name}.weight").T.copy(),
                "bias": a(f"{name}.bias")}

    params = {"input_proj": linear("input_proj")}
    stats = {}
    for i in range(config.num_layers):
        params[f"conv_{i}"] = {
            "lin": {"kernel": a(f"convs.{i}.lin.weight").T.copy()},
            "att_src": a(f"convs.{i}.att_src"),
            "att_dst": a(f"convs.{i}.att_dst"),
            "bias": a(f"convs.{i}.bias"),
        }
        if config.use_batch_norm and config.norm_type == "batch":
            params[f"bn_{i}"] = {"scale": a(f"norms.{i}.weight"),
                                 "bias": a(f"norms.{i}.bias")}
            if f"norms.{i}.running_mean" in sd:
                stats[f"bn_{i}"] = {"mean": a(f"norms.{i}.running_mean"),
                                    "var": a(f"norms.{i}.running_var")}
    for k in range(4):
        params[f"out_{k}"] = linear(f"out_{k}")
    return params, stats
