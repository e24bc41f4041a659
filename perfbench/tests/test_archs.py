"""The architectures as plug-ins: a configuration's ``layer_type`` finds
its module by file name, and an architecture is added by adding its file
(``reference/archs/``)."""

from __future__ import annotations

import importlib
import math
import sys

import pytest
import torch

from perfbench.reference import archs
from perfbench.reference import graph as ref_graph
from perfbench.reference.train import reference_steps
from perfbench.yardstick import flops, meshes, weights

from perfbench.tests import tiny

TOY = '''
"""A toy architecture: Linear(3→H), LayerNorm, ReLU, a sum over each
receiver's senders and itself, Linear(H→7)."""

import torch

from perfbench.reference.model import linear, products, quantizer
from perfbench.yardstick.weights import Leaf


def param_shapes(cfg):
    h = cfg["hidden_dim"]
    return [Leaf("enc.weight", (h, 3), "uniform", 3),
            Leaf("enc.bias", (h,), "uniform", 3),
            Leaf("ln.weight", (h,), "ones"), Leaf("ln.bias", (h,), "zeros"),
            Leaf("dec.weight", (7, h), "uniform", h),
            Leaf("dec.bias", (7,), "uniform", h)]


class Forward:
    def __init__(self, cfg, graph, quant="f32"):
        self.g, self.q, self.mm = graph, quantizer(quant), products(quant)

    def __call__(self, p, stats, x, mode, gen=None):
        h = linear(p, "enc", x, self.q, mm=self.mm)
        h = torch.relu(torch.nn.functional.layer_norm(
            h, h.shape[-1:], p["ln.weight"], p["ln.bias"]))
        h = h.index_add(0, self.g.receivers, h[self.g.senders])
        return linear(p, "dec", h, self.q, mm=self.mm)


def model_flops(cfg, n, e, train):
    f = 2.0 * n * 10 * cfg["hidden_dim"] + e * cfg["hidden_dim"]
    return 3.0 * f if train else f


def step_ops(cfg, n, e, train):
    return [("toy", model_flops(cfg, n, e, train), 4.0 * n * 20)]
'''


@pytest.mark.parametrize("name", tiny.configs())
def test_every_configuration_finds_its_module(name):
    cfg = tiny.config(name)
    mod = archs.load(cfg)
    assert mod.__name__.endswith("." + cfg["layer_type"].lower())
    for attr in ("param_shapes", "Forward", "model_flops", "step_ops"):
        assert hasattr(mod, attr), attr


@pytest.mark.parametrize("layer_type", ["NoSuch", "_flowgnn", "GAT.x"])
def test_an_unknown_layer_type_raises(layer_type):
    cfg = {"layer_type": layer_type, "hidden_dim": 8}
    with pytest.raises(ValueError, match=r"looked for .*\.py"):
        archs.load(cfg)
    with pytest.raises(ValueError):
        weights.param_shapes(cfg)
    with pytest.raises(ValueError):
        flops.step_ops(cfg, 10, 30, True)


def test_a_dropped_in_module_is_found_weighted_counted_and_run(
        tmp_path, monkeypatch):
    (tmp_path / "toymlp.py").write_text(TOY)
    monkeypatch.setattr(archs, "__path__", [*archs.__path__, str(tmp_path)])
    importlib.invalidate_caches()
    name = f"{archs.__name__}.toymlp"
    try:
        cfg = {"layer_type": "ToyMLP", "hidden_dim": 16}
        w = weights.make_weights(cfg, 3, "cpu")
        assert list(w) == ["enc.weight", "enc.bias", "ln.weight", "ln.bias",
                           "dec.weight", "dec.bias"]
        assert torch.equal(w["ln.weight"], torch.ones(16))
        assert float(w["enc.weight"].abs().max()) <= 3 ** -0.5
        assert flops.model_flops(cfg, 10, 30, True) == 3 * (3200 + 480)
        assert flops.step_ops(cfg, 10, 30, False) == [("toy", 3680.0, 800.0)]

        g = ref_graph.build(meshes.box_mesh(6, 4, 1))
        targets = torch.rand((2, g.n, 7), generator=torch.Generator()
                             .manual_seed(1))
        tcfg = {"lr": 1e-3, "weight_decay": 0.0, "grad_clip": 1.0,
                "pressure_ref_weight": 0.1}
        got = reference_steps(cfg, tcfg, g, g.coords, targets, w, seed=7,
                              eval_mode="eval")
        assert len(got["losses"]) == 4 and all(map(math.isfinite,
                                                   got["losses"]))
        assert set(got["change"]) == set(w)
        assert all(v > 0 for v in got["change"].values())
    finally:
        sys.modules.pop(name, None)
