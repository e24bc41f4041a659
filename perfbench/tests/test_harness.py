"""The harness on the CPU at a tiny size: the JAX guard, the reference's
independence, a whole run of every cell, and the check against planted
faults and the 8-bit control."""

from __future__ import annotations

import ast
import importlib
import json
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import faults, run
from perfbench.core.context import Context
from perfbench.reference.model import control_precision
from perfbench.tests import tiny


def test_forbidden_modules_compares_top_level_names_whole():
    names = ["gnn_bfs_rans_tpu_torch", "gnn_bfs_rans_tpu_torch.train",
             "numpy", "jaxlib.xla_client", "flaxen", "jax_like"]
    assert run.forbidden_modules(names) == ["jaxlib"]
    assert run.forbidden_modules(["gnn_bfs_rans_tpu.models"]) == \
        ["gnn_bfs_rans_tpu"]
    assert run.forbidden_modules(["jax", "flax.linen"]) == ["flax", "jax"]


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from perfbench.tests import tiny\n"
        "from perfbench import run\n"
        "tiny.run_tiny('gat4x256-bf16.train-box12k', Path(%r))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(run.ROOT), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1]
                        .replace("'", '"'))
    assert "gnn_bfs_rans_tpu_torch" in loaded
    assert not set(loaded) & set(run.FORBIDDEN)


@pytest.mark.parametrize("folder", ["reference", "yardstick"])
def test_the_yardstick_imports_nothing_of_the_program(folder):
    for path in (run.HERE / folder).rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]] \
                    if node.level == 0 else []
            else:
                continue
            banned = {"gnn_bfs_rans_tpu_torch", *run.FORBIDDEN}
            assert not set(tops) & banned, f"{path.name} imports {tops}"


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "gat4x256-bf16.train-box12k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=run.ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_bare_checkout_no_result(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "gat4x256-bf16.train-box12k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.parametrize("name", tiny.configs())
@pytest.mark.parametrize("mode", ["train", "exact", "eval"])
def test_reference_is_the_plain_program_in_f32(name, mode):
    """In f32 the reference and the port's plain versions compute one
    forward: dropout streams, BatchNorm and attention alike."""
    from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN

    from perfbench.core import program
    from perfbench.reference import graph as ref_graph
    from perfbench.reference.model import Forward
    from perfbench.reference.train import split_weights
    from perfbench.yardstick import meshes, weights

    cfg = dict(tiny.config(name), compute_dtype="float32")
    mesh = meshes.box_mesh(40, 6, 1)
    g = program.program_graph(mesh, cfg["layer_type"])
    model = FlowGNN(program.model_config(cfg))
    w = weights.make_weights(cfg, 9, "cpu")
    if mode == "eval":
        # running statistics and affine away from (0, 1), as trained
        gen = torch.Generator().manual_seed(5)
        for k, v in w.items():
            if k.startswith("norms."):
                w[k] = v + 0.25 * torch.rand(v.shape, generator=gen)
    model.load_state_dict(w)
    rg = ref_graph.build(mesh)
    assert (rg.order == program.rows(g)).all()
    p, s = split_weights(cfg, {k: v.clone() for k, v in w.items()})
    if mode == "train":
        out = model(g, train=True, generator=torch.Generator().manual_seed(4))
        ref = Forward(cfg, rg)(p, s, rg.coords, "train",
                               torch.Generator().manual_seed(4))
    else:
        model.eval()
        out = model(g, exact_bn=mode == "exact")
        ref = Forward(cfg, rg)(p, s, rg.coords, mode)
    torch.testing.assert_close(out[:rg.n], ref, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", tiny.cells())
def test_a_tiny_run_is_correct(cell, trace, tmp_path):
    res = tiny.run_tiny(cell, tmp_path, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if not trace:
        assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "checks"


def _numbers(files: dict, seed: int, out_dir, quant: str = "f32") -> dict:
    """Every number of a tiny run's check, compared or read out."""
    ctx = Context(workload=files["workload"], config=files["config"],
                  traffic=files["traffic"], limits=files["limits"],
                  seed=seed, seconds=0.4, trace=False, device="cpu",
                  out_dir=out_dir)
    driver = importlib.import_module(
        f"perfbench.drivers.{files['traffic']['kind']}")
    state = driver.setup(ctx)
    driver.window(ctx, state)
    driver.release(state)
    return driver.check(ctx, state, quant=quant)


def test_the_reference_follows_the_program_in_f32(tmp_path):
    """In f32 the program's two epochs (the second through the epoch
    graph's path) and the reference's agree to rounding in every number."""
    files = tiny.files("gat4x256-bf16.train-box12k")
    files["config"] = dict(files["config"], compute_dtype="float32")
    nums = _numbers(files, 2 ** 31 + 37, tmp_path)
    for k in ("loss", "val", "pred", "grad", "change_median",
              "moment_median"):
        assert nums[k] < 1e-4, nums
    assert nums["unstepped"] == 0


def _faulted(cell: str, fault: str, tmp_path) -> bool:
    files = tiny.files(cell)
    with faults.planted(fault):
        res = run.run_cell(files, [], 2 ** 31 + 29, 0.4, False, "cpu",
                           tmp_path / cell)
    return res["correct"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", tiny.cells())
def test_a_planted_training_fault_is_not_correct(cell, fault, tmp_path):
    assert not _faulted(cell, fault, tmp_path)


@pytest.mark.parametrize("cell", tiny.cells())
def test_the_control_is_not_correct(cell, tmp_path):
    """The reference in the precision below the configuration's (8-bit
    floats for bfloat16, TF32 for float32) put in the program's place
    fails a number of the cell's check."""
    files = tiny.files(cell)
    nums = _numbers(files, 2 ** 31 + 31, tmp_path / cell,
                    quant=control_precision(files["config"]))
    assert any(nums[k] > lim for k, lim in files["limits"].items()), nums


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.cells())
def test_a_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 41), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
