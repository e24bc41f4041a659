"""The port's bench harness (``gnn_bfs_rans_tpu_torch/utils/bench.py``,
``utils/roofline.py``, CLI ``bench``, ``gnn_bfs_rans_tpu_torch.bench``)
against the JAX package's, on the CPU.

* the FLOP and byte formulas and ``analyze`` equal the JAX module's
  exactly (tolerance 0: the same Python arithmetic), for every layer type,
  several shapes and ``use_edge_attr`` on and off; ``analyze`` on the CPU
  and, with the JAX module's peak lookup given the same card's peaks, on
  an H100 name;
* ``graph_static_bytes`` equals the JAX module's on the same case;
* ``run_benchmark`` (``dense``, forward) returns the JAX result's keys and
  its counts (nodes, edges, parameters, FLOPs, estimated bytes: exactly);
  ``pallas`` and ``mode='train'`` on the port alone;
* the JAX harness's methodology tests (``tests/test_bench_harness.py``)
  mirrored in torch;
* the CLI ``bench`` and the headline entry, in process, with ``--device
  cpu``.

Small sizes: generated box cases of 96–336 cells, hidden ≤ 16.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.graph.band import LAYER_COMPONENTS as JAX_COMPONENTS
from gnn_bfs_rans_tpu.train import load_dataset as jax_load_dataset
from gnn_bfs_rans_tpu.utils import bench as jax_bench
from gnn_bfs_rans_tpu.utils import roofline as jax_roofline
from gnn_bfs_rans_tpu_torch import bench as headline
from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
from gnn_bfs_rans_tpu_torch.foam import drifting_box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
from gnn_bfs_rans_tpu_torch.graph.structs import build_padded_graph
from gnn_bfs_rans_tpu_torch.train.data import load_dataset
from gnn_bfs_rans_tpu_torch.utils import roofline
from gnn_bfs_rans_tpu_torch.utils.bench import (
    MarginalTiming,
    _chain,
    _cross_check,
    _marginal_from_times,
    chained_marginal_time,
    run_benchmark,
    steady_state_time,
    time_fn,
)

REPO = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"
LAYER_TYPES = ["GCN", "GAT", "GIN", "Transformer"]
# (n_nodes, n_edges, hidden, heads, layers): the 400×30 box, a small
# graph, the 1M-cell grid, an odd hidden width
SHAPES = [(12000, 47140, 256, 4, 4), (1000, 3000, 32, 2, 1),
          (999936, 3998976, 256, 4, 6), (17, 40, 9, 3, 2)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "case"
    generate_box_case(path, 12, 8, 1, time_dirs=("100", "200"),
                      time_field_fn=drifting_box_fields)
    return path


# ------------------------------------------------------ roofline vs JAX
@pytest.mark.parametrize("use_edge_attr", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_flop_counts_equal_jax(layer_type, shape, use_edge_attr):
    n, e, h, heads, layers = shape
    kw = dict(heads=heads, use_edge_attr=use_edge_attr)
    for fn in ("forward_matmul_flops", "train_matmul_flops"):
        got = getattr(roofline, fn)(layer_type, layers, h, n, e, **kw)
        want = getattr(jax_roofline, fn)(layer_type, layers, h, n, e, **kw)
        assert got == want, fn


@pytest.mark.parametrize("mode", ["forward", "train"])
@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_hbm_bytes_estimate_equals_jax(layer_type, mode):
    for n, _, h, _, layers in SHAPES:
        for params, graph_bytes, el in ((0, 0, 2), (123457, 9876543, 4)):
            args = (layer_type, layers, h, n, params)
            kw = dict(bytes_per_el=el, graph_bytes=graph_bytes, mode=mode)
            assert (roofline.hbm_bytes_estimate(*args, **kw)
                    == jax_roofline.hbm_bytes_estimate(*args, **kw))


@pytest.mark.parametrize("card", ["cpu", H100, "NVIDIA H100 PCIe"])
@pytest.mark.parametrize("mode", ["forward", "train"])
@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_analyze_equals_jax(monkeypatch, layer_type, mode, card):
    """The whole report, key for key; on a card's name the JAX lookup
    (TPU names only) is given the port's peaks for that card."""
    peak = roofline.device_peak(card)
    if card == "cpu":
        jax_device = jax.devices("cpu")[0]
    else:
        assert peak.flops is not None
        jax_device = None
        monkeypatch.setattr(jax_roofline, "device_peak",
                            lambda device=None: jax_roofline.DevicePeak(
                                peak.kind, peak.flops, peak.hbm))
    for n, e, h, heads, layers in SHAPES:
        for time_s in (4e-4, 1e-6, 2.5):
            kw = dict(layer_type=layer_type, num_layers=layers,
                      hidden_dim=h, n_nodes=n, n_edges=e, time_s=time_s,
                      mode=mode, heads=heads, param_count=1_000_000,
                      graph_bytes=10_000_000, use_edge_attr=layers != 1)
            got = roofline.analyze(**kw, device=card)
            want = jax_roofline.analyze(**kw, device=jax_device)
            assert got == want


def test_device_peaks():
    sxm = roofline.device_peak(H100)
    assert (sxm.kind, sxm.flops, sxm.hbm) == (H100.lower(), 989e12, 3.35e12)
    pcie = roofline.device_peak("NVIDIA H100 PCIe")
    assert (pcie.flops, pcie.hbm) == (756e12, 2.0e12)
    for other in ("cpu", torch.device("cpu"), "NVIDIA A100-SXM4-80GB"):
        assert roofline.device_peak(other).flops is None
    assert roofline.device_peak("cpu").kind == "cpu"


@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_graph_static_bytes_equals_jax(case, layer_type):
    """The same case's graph with its band planes: the same bytes; the
    port's transposed-plane cache is not counted."""
    comps = LAYER_COMPONENTS[layer_type]
    port = load_dataset(case, with_band=True, band_components=comps).graph
    ref = jax_load_dataset(case, with_band=True,
                           band_components=JAX_COMPONENTS[layer_type]).graph
    assert port.band is not None and ref.band is not None
    want = jax_roofline.graph_static_bytes(ref)
    assert roofline.graph_static_bytes(port) == want
    # the plane the layer's backward transposes (the Transformer's none)
    plane = {"GAT": "bias_self", "GCN": "gcn", "GIN": "adj"}.get(layer_type)
    if plane is not None:
        assert port.band.transposed(plane).numel() > 0
    assert roofline.graph_static_bytes(port) == want


# --------------------------------------------------- run_benchmark vs JAX
def _retry_collapse(fn, attempts=4):
    """µs-scale CPU timings can collapse (T(full) ≤ T(base)) under host
    contention — both harnesses refuse to report then; retry a few times
    rather than flake (as ``tests/test_bench_harness.py`` does)."""
    for attempt in range(attempts):
        try:
            return fn()
        except RuntimeError as e:
            if "resolution collapse" not in str(e) or attempt == attempts - 1:
                raise


def test_run_benchmark_forward_matches_jax(case):
    kw = dict(layer_type="GAT", num_layers=2, hidden_dim=32,
              backend="dense", steps=1, mode="forward",
              compute_dtype="float32", cross_check=False)
    got = _retry_collapse(lambda: run_benchmark(case, **kw, device="cpu"))
    want = _retry_collapse(lambda: jax_bench.run_benchmark(case, **kw))
    assert set(got) == set(want)
    for key in ("n_nodes", "n_edges", "n_params", "matmul_flops",
                "hbm_bytes_est", "metric", "unit", "mode", "timing"):
        assert got[key] == want[key], key
    assert got["platform"] == "cpu" and got["hbm_bytes_xla"] is None
    assert got["bytes_basis"] == "estimate" and got["mfu"] is None
    assert got["value"] == 2 * got["n_edges"] / got["step_median_s"]


@pytest.mark.parametrize("layer_type", ["GAT", "GCN"])
def test_run_benchmark_pallas_forward_and_train(case, layer_type):
    """The banded path, forward and train (dropout 0.1 on every
    snapshot): the same keys, the same counts, train FLOPs 3× forward,
    the forward's cross-check and the train step's trace block present."""
    kw = dict(layer_type=layer_type, num_layers=1, hidden_dim=8,
              backend="pallas", steps=1, compute_dtype="float32",
              device="cpu")
    fwd = _retry_collapse(lambda: run_benchmark(case, mode="forward", **kw))
    train = _retry_collapse(lambda: run_benchmark(
        case, mode="train", trace=True, cross_check=False, **kw))
    assert set(train) == set(fwd) | {"trace"}
    for key in ("n_nodes", "n_edges", "n_params"):
        assert train[key] == fwd[key]
    assert train["matmul_flops"] == 3 * fwd["matmul_flops"]
    assert train["mode"] == "train" and train["step_median_s"] > 0
    assert fwd["cross_check"]["steady_available"]
    assert {"trace_over_chained", "agreement_15pct",
            "top_ops_us_per_step"} <= set(train["trace"])


# ---------------------------------------- methodology (test_bench_harness)
def _tiny_graph():
    src = np.array([0, 1, 1, 2], dtype=np.int32)
    dst = np.array([1, 0, 2, 1], dtype=np.int32)
    feat = np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)
    ef = np.zeros((4, 4), dtype=np.float32)
    return build_padded_graph(src, dst, ef, feat, node_align=8, edge_align=8)


def test_chained_marginal_time_positive_and_sane():
    g = _tiny_graph()

    def apply_fn(graph):
        return torch.tanh(graph.node_feat @ graph.node_feat.T)

    # µs-scale CPU timings can collapse under host contention — the harness
    # refuses to report then; retry a few times rather than flake
    for attempt in range(4):
        try:
            t = chained_marginal_time(apply_fn, g, reps=8, base=2, trials=2,
                                      min_snr=0.0)
            break
        except RuntimeError:
            if attempt == 3:
                raise
    assert isinstance(t, MarginalTiming)
    assert 0 < t.step_s < 1.0
    assert t.snr > 0 and t.reps > t.base


def test_chained_full_output_consumed():
    """Every output element is live in the chain, and each call reads the
    buffer the previous one updated: an output nonzero only in its LAST
    element, (feat[0,0] + 1)·1e30, moves feat[0,0] to 2·feat[0,0] + 1 a
    call (2^k − 1 after k calls).  A chain that consumed out[0] only would
    leave feat at 0; one that read a copy of node_feat would give k."""
    g = _tiny_graph()
    g = type(g)(**{**g.__dict__, "node_feat": torch.zeros_like(g.node_feat)})

    def apply_fn(graph):
        out = torch.zeros(5, 7)
        out[-1, -1] = (graph.node_feat[0, 0] + 1) * 1e30
        return out

    step, _ = _chain(apply_fn, g)       # two calls: warm-up, capture
    for _ in range(3):
        feat = step()
    assert feat[0, 0].item() == 2 ** 5 - 1
    assert torch.equal(feat, torch.full_like(feat, 2 ** 5 - 1))


def test_chained_collapse_raises():
    """A zero/negative delta (resolution collapse) must refuse to report."""
    with pytest.raises(RuntimeError, match="resolution collapse"):
        _marginal_from_times(1.0, 1.0, 8, 64, 1e-3, 5)
    with pytest.raises(RuntimeError, match="resolution collapse"):
        _marginal_from_times(1.0, 0.9, 8, 64, 1e-3, 5)
    ok = _marginal_from_times(1.0, 2.12, 8, 64, 1e-3, 5)
    assert abs(ok.step_s - 0.02) < 1e-9


def test_steady_state_time_measures_dispatch():
    x = torch.ones(32, 32)
    t = steady_state_time(lambda i: x * 2.0 + 1.0, steps=16, base=4, depth=2)
    assert 0 < t < 1.0


def test_cross_check_impossible_direction_raises():
    with pytest.raises(RuntimeError, match="cross-check"):
        _cross_check(chained_s=1e-3, steady_s=1e-4)


def test_cross_check_reports_without_raising_off_the_card():
    """Host-clock times of the plain versions (run_benchmark on the CPU):
    the impossible direction is reported, not raised."""
    out = _cross_check(chained_s=1e-3, steady_s=1e-4, strict=False)
    assert out["steady_over_chained"] == pytest.approx(0.1)
    assert out["agreement_2x"] is True


def test_cross_check_dispatch_bound_reported_not_fatal():
    out = _cross_check(chained_s=1e-3, steady_s=5e-3)
    assert out["steady_dispatch_bound"] is True
    assert out["agreement_2x"] is False
    out2 = _cross_check(chained_s=1e-3, steady_s=1.5e-3)
    assert out2["agreement_2x"] is True
    assert _cross_check(1e-3, None) == {"steady_available": False}


def test_roofline_guard_rejects_impossible_time():
    """41 µs for a 50-GFLOP forward exceeds the H100's peak → must raise."""
    with pytest.raises(RuntimeError, match="roofline violation"):
        roofline.check_roofline(50e9, 41e-6, device=H100)
    # a sane time passes
    roofline.check_roofline(50e9, 400e-6, device=H100)


def test_roofline_guard_noop_on_cpu():
    roofline.check_roofline(1e15, 1e-9, device="cpu")


def test_time_fn_returns_stats():
    x = torch.ones(8, 8)
    stats = time_fn(lambda a: a * 2.0, x, steps=6, warmup=1, chunk=3)
    assert set(stats) >= {"median_s", "mean_s", "min_s"}
    assert stats["min_s"] > 0


# ----------------------------------------------------- CLI and headline
def _json_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_cli_bench_on_a_case(case, capsys):
    assert _retry_collapse(lambda: cli_main(
        ["bench", "--case_path", str(case), "--num_layers", "1",
         "--hidden_dim", "8", "--steps", "1", "--device", "cpu"])) == 0
    res = _json_line(capsys)
    assert res["backend"] == "pallas" and res["compute_dtype"] == "float32"
    assert res["layer_type"] == "GAT" and res["platform"] == "cpu"
    assert res["cross_check"]["steady_available"]


def test_cli_bench_synthetic(capsys):
    assert _retry_collapse(lambda: cli_main(
        ["bench", "--synthetic", "3000", "--num_layers", "1",
         "--hidden_dim", "8", "--steps", "1", "--device", "cpu"])) == 0
    res = _json_line(capsys)
    # the keys of the JAX package's run_scale_benchmark result
    assert set(res) == {
        "metric", "value", "unit", "mode", "remat", "n_nodes", "n_edges",
        "layer_type", "backend", "compute_dtype", "hidden_dim",
        "num_layers", "step_median_s", "platform"}
    # 96 × 31 cells: 2·(95·31) + 2·(96·30) directed edges
    assert res["n_nodes"] == 96 * 31
    assert res["n_edges"] == 2 * 95 * 31 + 2 * 96 * 30
    assert res["mode"] == "forward" and res["backend"] == "pallas"


def test_bench_defaults_to_the_card(case):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        run_benchmark(case)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        cli_main(["bench", "--case_path", str(case)])


def test_headline_line_equals_the_root_bench(monkeypatch, capsys):
    """The headline entry runs the root bench.py's configuration and prints
    its line: both run on a stand-in run_benchmark that returns one fixed
    result, and both lines must be equal."""
    result = {k: f"<{k}>" for k in headline.DETAIL_KEYS}
    result.update(metric="edge_messages_per_sec_per_chip", value=2e8,
                  unit="msgs/s", vs_baseline=2.0, mfu=0.1, n_nodes=12000,
                  device="stand-in")
    calls = []

    def stand_in(**kw):
        calls.append(kw)
        return result

    from gnn_bfs_rans_tpu_torch.utils import bench as port_bench

    monkeypatch.setattr(port_bench, "run_benchmark", stand_in)
    monkeypatch.setattr(jax_bench, "run_benchmark", stand_in)
    # the root bench.py turns on JAX's persistent compilation cache
    monkeypatch.setenv("GNN_BFS_RANS_TPU_NO_CACHE", "1")
    assert headline.main(["--case_path", "somecase", "--device", "cpu"]) == 0
    port_line = _json_line(capsys)
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  REPO / "bench.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    assert root.main() == 0
    assert port_line == _json_line(capsys)
    port_kw, jax_kw = calls
    assert port_kw.pop("device") == "cpu"
    assert port_kw.pop("case_path") == "somecase"
    jax_kw.pop("case_path")
    assert port_kw == jax_kw
