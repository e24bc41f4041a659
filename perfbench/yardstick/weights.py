"""Model weights made from the seed, on the device, for both sides.

:func:`param_shapes` lists every parameter and buffer of a FlowGNN
configuration under the names of the reference's PyTorch Geometric layout
(the names the port's ``state_dict`` keeps: ``input_proj``, ``convs.<i>``,
``norms.<i>``, ``out_0`` .. ``out_3``).  :func:`make_weights` draws all of
them in one ``torch.rand`` call on the device's generator and scales each
leaf: a linear layer's weight and bias uniform in ±1/√fan_in (PyTorch's
``nn.Linear`` default), a GAT attention vector in ±1/√heads, BatchNorm's
affine at (1, 0) and its running statistics at (0, 1).
"""

from __future__ import annotations

import torch


def param_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """``(name, shape, kind, fan)``; kinds: ``w`` and ``b`` (a linear
    layer's, fan = fan_in), ``att``, ``bn_w``, ``bn_b``, ``bn_mean``,
    ``bn_var``."""
    h, heads = cfg["hidden_dim"], cfg["heads"]
    hc = heads * h
    out: list = []

    def lin(name, n_in, n_out, bias=True):
        out.append((f"{name}.weight", (n_out, n_in), "w", n_in))
        if bias:
            out.append((f"{name}.bias", (n_out,), "b", n_in))

    lin("input_proj", cfg["input_dim"], h)
    for i in range(cfg["num_layers"]):
        p = f"convs.{i}"
        if cfg["layer_type"] == "GAT":
            lin(f"{p}.lin", h, hc, bias=False)
            out.append((f"{p}.att_src", (1, heads, h), "att", heads))
            out.append((f"{p}.att_dst", (1, heads, h), "att", heads))
            out.append((f"{p}.bias", (h,), "b", h))
        elif cfg["layer_type"] == "Transformer":
            for m in ("lin_query", "lin_key", "lin_value"):
                lin(f"{p}.{m}", h, hc)
            lin(f"{p}.lin_edge", cfg["edge_dim"], hc, bias=False)
            lin(f"{p}.lin_skip", h, h)
        else:
            raise ValueError(f"no reference for {cfg['layer_type']!r}")
    for i in range(cfg["num_layers"]):
        out += [(f"norms.{i}.weight", (h,), "bn_w", 0),
                (f"norms.{i}.bias", (h,), "bn_b", 0),
                (f"norms.{i}.running_mean", (h,), "bn_mean", 0),
                (f"norms.{i}.running_var", (h,), "bn_var", 0)]
    lin("out_0", h, h)
    lin("out_1", h, h)
    lin("out_2", h, h // 2)
    lin("out_3", h // 2, cfg["output_dim"])
    return out


BUFFER_KINDS = ("bn_mean", "bn_var")


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter and buffer (f32) of ``cfg`` from ``seed``."""
    spec = param_shapes(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for (name, shape, kind, fan), chunk in zip(spec, u.split(sizes)):
        chunk = chunk.view(shape)
        if kind in ("w", "b", "att"):
            t = chunk * fan ** -0.5
        elif kind in ("bn_w", "bn_var"):
            t = torch.ones_like(chunk)
        else:
            t = torch.zeros_like(chunk)
        out[name] = t.contiguous()
    return out
