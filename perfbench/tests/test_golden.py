"""The yardstick's numbers for the GAT and Transformer configurations,
held bit for bit against ``golden.json``.

``golden.json`` was written by ``python -m perfbench.tests.test_golden``
on the tree before the architectures became plug-ins
(``reference/archs/``), on the CPU with one torch thread: each
configuration's ``make_weights`` on one seed, ``model_flops`` and
``step_ops`` at each cell's graph size, a tiny reference forward in
every mode and in the 8-bit control, and every number of a tiny run's
check of each cell on one seed.  The registry must give the same
numbers, so that the cells' checks, MFU and rooflines read what they
read before.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

GOLDEN = Path(__file__).with_name("golden.json")
SEED = 2 ** 31 + 5
CONFIGS = ("gat4x256-bf16", "transformer8x256-bf16")
# each cell's graph: the real cells and directed edges of its mesh
CELLS = {"gat4x256-bf16.train-box12k": (12000, 47140),
         "transformer8x256-bf16.train-box12k": (12000, 47140),
         "gat4x256-bf16.train-grid250k": (250080, 994918)}
MODES = ("train", "exact", "eval", "train.fp8")


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.detach().contiguous().float().numpy().tobytes())
    return h.hexdigest()


def _config(name: str) -> dict:
    from perfbench import run

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    path = next(c["file"] for c in bench["configs"] if c["name"] == name)
    return run.load_json(run.ROOT / path)


def _forwards(cfg: dict) -> dict[str, str]:
    from perfbench.reference import graph as ref_graph
    from perfbench.reference.model import Forward
    from perfbench.reference.train import split_weights
    from perfbench.yardstick import meshes, weights

    cfg = dict(cfg, num_layers=2)
    g = ref_graph.build(meshes.box_mesh(40, 6, 1))
    w = weights.make_weights(cfg, 9, "cpu")
    gen = torch.Generator().manual_seed(5)
    for k, v in w.items():
        if k.startswith("norms."):
            w[k] = v + 0.25 * torch.rand(v.shape, generator=gen)
    out = {}
    for mode in MODES:
        p, s = split_weights(cfg, {k: v.clone() for k, v in w.items()})
        kind, _, quant = mode.partition(".")
        y = Forward(cfg, g, quant or "f32")(
            p, s, g.coords, kind, torch.Generator().manual_seed(4))
        out[mode] = _digest([("out", y), *sorted(s.items())])
    return out


def _checks(cell: str) -> dict[str, float]:
    import importlib
    import tempfile

    from perfbench.core.context import Context
    from perfbench.tests import tiny

    f = tiny.files(cell)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(workload=f["workload"], config=f["config"],
                      traffic=f["traffic"], limits=f["limits"],
                      seed=2 ** 31 + 43, seconds=0.2, trace=False,
                      device="cpu", out_dir=Path(tmp))
        driver = importlib.import_module(
            f"perfbench.drivers.{f['traffic']['kind']}")
        state = driver.setup(ctx)
        driver.window(ctx, state)
        driver.release(state)
        return driver.check(ctx, state)


def compute() -> dict:
    """Every number the file holds, from the tree as it stands."""
    from perfbench.yardstick import flops, weights

    torch.set_num_threads(1)
    out = {}
    for name in CONFIGS:
        cfg = _config(name)
        w = weights.make_weights(cfg, SEED, "cpu")
        counts = {}
        for cell, (n, e) in CELLS.items():
            if not cell.startswith(name + "."):
                continue
            for train in (True, False):
                counts[f"{cell}.{'train' if train else 'eval'}"] = {
                    "model_flops": flops.model_flops(cfg, n, e, train),
                    "step_ops": [list(op) for op in
                                 flops.step_ops(cfg, n, e, train)]}
        out[name] = {"weights": list(w), "weights_sha256": _digest(w.items()),
                     "counts": counts, "forward_sha256": _forwards(cfg)}
    out["checks"] = {cell: _checks(cell) for cell in CELLS}
    return out


@pytest.fixture(scope="module")
def now():
    return compute()


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_the_recorded_draw(name, now):
    want = json.loads(GOLDEN.read_text())[name]
    assert now[name]["weights"] == want["weights"]
    assert now[name]["weights_sha256"] == want["weights_sha256"]


@pytest.mark.parametrize("name", CONFIGS)
def test_operation_counts_are_the_recorded_ones(name, now):
    want = json.loads(GOLDEN.read_text())[name]["counts"]
    assert now[name]["counts"] == want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_forward_is_the_recorded_one(name, mode, now):
    want = json.loads(GOLDEN.read_text())[name]["forward_sha256"]
    assert now[name]["forward_sha256"][mode] == want[mode]


@pytest.mark.parametrize("cell", CELLS)
def test_check_numbers_are_the_recorded_ones(cell, now):
    """The program's tiny CPU run against the reference: every number of
    the check, compared or read out, as before."""
    want = json.loads(GOLDEN.read_text())["checks"][cell]
    assert {k: now["checks"][cell][k] for k in want} == want


if __name__ == "__main__":
    json.dump(compute(), sys.stdout, indent=1)
    print()
