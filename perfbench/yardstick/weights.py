"""Model weights made from the seed, on the device, for both sides.

:func:`param_shapes` lists every parameter and buffer of a configuration
as its architecture's module (``reference/archs/``) gives them, under the
names the port's ``state_dict`` keeps.  Each is a :class:`Leaf` of a
generic kind, so that an architecture brings its own layers (a LayerNorm,
an edge MLP) with no edit here.  :func:`make_weights` draws all of them in
one ``torch.rand`` call on the device's generator and sets each leaf by
its kind: ``uniform`` in ±1/√fan (PyTorch's ``nn.Linear`` default with
fan = fan_in), ``ones`` or ``zeros`` (its share of the draw unused).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..reference import archs


class Leaf(NamedTuple):
    """A parameter, or with ``buffer`` a running statistic."""

    name: str
    shape: tuple[int, ...]
    init: str
    fan: float = 0
    buffer: bool = False


def param_shapes(cfg: dict) -> list[Leaf]:
    return archs.load(cfg).param_shapes(cfg)


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter and buffer (f32) of ``cfg`` from ``seed``."""
    spec = param_shapes(cfg)
    sizes = [int(torch.Size(leaf.shape).numel()) for leaf in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for leaf, chunk in zip(spec, u.split(sizes)):
        chunk = chunk.view(leaf.shape)
        if leaf.init == "uniform":
            t = chunk * leaf.fan ** -0.5
        elif leaf.init == "ones":
            t = torch.ones_like(chunk)
        elif leaf.init == "zeros":
            t = torch.zeros_like(chunk)
        else:
            raise ValueError(f"{leaf.name}: unknown init {leaf.init!r}")
        out[leaf.name] = t.contiguous()
    return out
