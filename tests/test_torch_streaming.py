"""The port's streamed case loader (``train/streaming.py``), streamed
multi-case training and the geometry-generalization report
(``parallel/generalization.py``), CLI ``train-multicase``, ``bench --mode
dp`` (``utils/dp_bench.py``) and ``run_partition_shard_benchmark``, on the
CPU against the JAX package.

* ``Prefetcher``: the cases of the JAX module's tests (order, an error at
  its position, overlap with a slow source, depth), a caller's ``put``,
  and ``close`` unblocking the producer;
* ``perturbed_case_source`` chunk for chunk equal to JAX's (and the same
  case whatever the chunking); ``foam_case_source`` on two generated box
  cases equal to JAX's, and its topology-mismatch error;
* ``train_multicase_streamed`` on 1 rank (an in-process gloo group) from
  the JAX package's own initial weights: the first epoch's loss within
  1e-4 of JAX's; ``run_geometry_generalization`` and ``train-multicase``
  (both modes) with the JAX keys and schema;
* ``bench --mode dp --device cpu --devices 1`` and
  ``run_partition_shard_benchmark`` at a few hundred cells: the JAX keys
  and counts.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gnn_bfs_rans_tpu.foam import FoamCase as JaxFoamCase
from gnn_bfs_rans_tpu.graph.build import build_graph as jax_build_graph
from gnn_bfs_rans_tpu.models.flow_gnn import FlowGNN as JaxFlowGNN
from gnn_bfs_rans_tpu.models.flow_gnn import ModelConfig as JaxModelConfig
from gnn_bfs_rans_tpu.parallel import generalization as jgen
from gnn_bfs_rans_tpu.train import streaming as jstream
from gnn_bfs_rans_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_bfs_rans_tpu.train.loop import init_state
from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
from gnn_bfs_rans_tpu_torch.compat.from_jax import state_dict_from_flax
from gnn_bfs_rans_tpu_torch.foam import (FoamCase, box_fields,
                                         drifting_box_fields,
                                         generate_box_case)
from gnn_bfs_rans_tpu_torch.graph.build import build_graph
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.parallel import generalization as gen
from gnn_bfs_rans_tpu_torch.parallel.distributed import launch
from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig
from gnn_bfs_rans_tpu_torch.train.streaming import (Prefetcher, Staged,
                                                    foam_case_source,
                                                    perturbed_case_source)
from gnn_bfs_rans_tpu_torch.utils.synthetic import (
    run_partition_shard_benchmark,
)

# the JAX package's result keys (utils/dp_bench.py, utils/synthetic.py,
# parallel/generalization.py)
DP_KEYS = {"metric", "value", "unit", "vs_baseline", "mode", "n_devices",
           "snapshots_per_device", "step_s_1dev", "step_s_ndev",
           "global_snapshots_per_sec_ndev", "edge_messages_per_sec_global",
           "layer_type", "num_layers", "hidden_dim", "backend",
           "compute_dtype", "n_edges", "platform", "note", "timing"}
SHARD_KEYS = {"metric", "value", "unit", "mode", "global_nodes", "n_shards",
              "shard_nodes", "n_edges", "halo", "layer_type", "backend",
              "compute_dtype", "hidden_dim", "num_layers", "step_median_s",
              "platform", "timing"}
GEN_KEYS = {"train_errors", "heldout_errors", "generalization_ratio",
            "history", "n_train_cases", "n_test_cases", "amplitude",
            "devices"}
FIELDS = ("U", "p", "k", "epsilon", "nut")




@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes run fastest on one thread, and leave the cores to the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields2(centers, t):
    """A second case's fields: the box's, drifted."""
    return drifting_box_fields(centers, 300.0)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("streaming")
    generate_box_case(root / "a", 24, 16, 1, time_dirs=("282",),
                      field_fn=box_fields)
    generate_box_case(root / "b", 24, 16, 1, time_dirs=("282",),
                      time_field_fn=_fields2)
    generate_box_case(root / "wide", 26, 16, 1, time_dirs=("282",))
    return root


@pytest.fixture(scope="module")
def graphs(cases):
    return (build_graph(FoamCase(cases / "a").load_mesh()),
            jax_build_graph(JaxFoamCase(cases / "a").load_mesh()))


# --------------------------------------------------------------- Prefetcher
def test_prefetcher_order_and_completion():
    items = [np.full((4,), i, np.float32) for i in range(7)]
    out = list(Prefetcher(iter(items), device="cpu", depth=3))
    assert len(out) == 7
    for i, a in enumerate(out):
        assert isinstance(a, torch.Tensor) and float(a[0]) == i


def test_prefetcher_source_error_in_position():
    def src():
        yield np.ones(2, np.float32)
        raise RuntimeError("disk on fire")

    pf = Prefetcher(src(), device="cpu", depth=2)
    next(pf)
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(pf)


def test_prefetcher_overlaps_slow_consumer():
    """While the consumer works, the producer thread keeps loading."""
    produced = []

    def src():
        for i in range(4):
            produced.append(i)
            yield np.full((2,), i, np.float32)

    pf = Prefetcher(src(), device="cpu", depth=2)
    next(pf)
    time.sleep(0.2)
    assert len(produced) >= 3
    assert len(list(pf)) == 3
    assert pf.wait_s >= 0.0


def test_prefetcher_put_and_depth():
    out = list(Prefetcher(iter(range(3)), put=lambda i: i * 10))
    assert out == [0, 10, 20]
    staged = list(Prefetcher(iter([1]), put=lambda i: Staged(i + 1, None)))
    assert staged == [2]
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter([]), device="cpu", depth=0)


def test_prefetcher_stages_to_the_card_by_default():
    """Without a device the default put stages on the card: with no card it
    raises rather than handing out CPU tensors."""
    if torch.cuda.is_available():
        pf = Prefetcher(iter([np.ones(2, np.float32)]))
        assert next(pf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            Prefetcher(iter([np.ones(2, np.float32)]))


def test_prefetcher_close_unblocks_the_producer():
    pf = Prefetcher(iter(range(100)), device="cpu", depth=1)
    next(pf)
    pf.close()
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()


# ------------------------------------------------------------- case sources
def test_perturbed_case_source_matches_jax(graphs):
    g, jg = graphs

    def tf(cid, coords):
        return np.full((coords.shape[0], 7), float(cid), np.float32)

    for chunk in (4, 3):
        got = list(perturbed_case_source(g, 6, chunk, amplitude=0.05,
                                         seed=3, targets_for=tf))
        want = list(jstream.perturbed_case_source(
            jg, 6, chunk, amplitude=0.05, seed=3, targets_for=tf))
        assert [b.n_cases for b in got] == [b.n_cases for b in want]
        for b, w in zip(got, want):
            for f in ("node_feats", "edge_feats", "targets"):
                np.testing.assert_array_equal(getattr(b, f),
                                              np.asarray(getattr(w, f)))
    a = list(perturbed_case_source(g, 6, 4, seed=3))
    b = list(perturbed_case_source(g, 6, 2, seed=3))
    np.testing.assert_array_equal(a[1].node_feats[1], b[2].node_feats[1])


def test_foam_case_source_matches_jax(cases):
    paths = [str(cases / "a"), str(cases / "b")]
    g, norm, it = foam_case_source(paths, chunk=2, time_dir="282")
    jg, jnorm, jit = jstream.foam_case_source(paths, chunk=2, time_dir="282")
    assert json.dumps(norm.to_dict()) == json.dumps(jnorm.to_dict())
    np.testing.assert_array_equal(g.perm.numpy(), np.asarray(jg.perm))
    (b,), (w,) = list(it), list(jit)
    for f in ("node_feats", "edge_feats", "targets"):
        np.testing.assert_array_equal(getattr(b, f), np.asarray(getattr(w, f)))
    assert not np.array_equal(b.targets[0], b.targets[1])


def test_foam_case_source_topology_mismatch(cases):
    paths = [str(cases / "a"), str(cases / "wide")]
    _, _, it = foam_case_source(paths, chunk=1, time_dir="282")
    next(it)
    with pytest.raises(ValueError, match="mesh topology differs"):
        next(it)
    with pytest.raises(ValueError, match="no case paths"):
        foam_case_source([], chunk=1, time_dir="282")


# ------------------------------------------------- streamed multi-case
SMALL = dict(hidden_dim=16, num_layers=2, layer_type="GCN", dropout=0.0,
             norm_type="layer", backend="dense")


def test_streamed_first_epoch_loss_matches_jax(graphs):
    """One rank: the JAX trainer's own initial weights (PRNGKey(0)), the
    same 4 chunks of one case; the first epoch's loss within 1e-4."""
    g, jg = graphs
    jcfg = JaxModelConfig(**SMALL)
    jtcfg = JaxTrainConfig(lr=3e-3, seed=0)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))

    def jsource():
        return jstream.perturbed_case_source(
            jg, 4, chunk=1, amplitude=0.05, seed=0,
            targets_for=jgen.analytic_targets)

    _, jhist = jgen.train_multicase_streamed(
        JaxFlowGNN(jcfg), jtcfg, mesh, jg, jsource, epochs=1, lr=3e-3)
    init = init_state(JaxFlowGNN(jcfg), jg.to_device(), jtcfg,
                      jax.random.PRNGKey(0))
    cfg = ModelConfig(**SMALL)
    model = FlowGNN(cfg)
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, init.params), {}, cfg))

    def source():
        return perturbed_case_source(g, 4, chunk=1, amplitude=0.05, seed=0,
                                     targets_for=gen.analytic_targets)

    def rank(r, world):
        return gen.train_multicase_streamed(model, TrainConfig(lr=3e-3),
                                            g, source, epochs=1, lr=3e-3)[1]

    (hist,) = launch(rank, 1, device="cpu")
    assert set(hist[0]) == set(jhist[0]) == {"epoch", "loss", "seconds"}
    assert hist[0]["loss"] == pytest.approx(jhist[0]["loss"], rel=1e-4)


def test_analytic_targets_match_jax(graphs):
    coords = graphs[0].node_feat.numpy()
    np.testing.assert_array_equal(gen.analytic_targets(3, coords),
                                  jgen.analytic_targets(3, coords))


def test_geometry_generalization_schema(graphs):
    g, _ = graphs
    res = gen.run_geometry_generalization(
        g, n_train_cases=2, n_test_cases=2, epochs=2, amplitude=0.05,
        model_cfg=ModelConfig(**SMALL), device="cpu")
    assert set(res) == GEN_KEYS
    for k in ("train_errors", "heldout_errors", "generalization_ratio"):
        assert set(res[k]) == set(FIELDS)
        assert all(np.isfinite(v) for v in res[k].values())
    assert [h["epoch"] for h in res["history"]] == [1, 2]
    assert res["devices"] == 1 and res["n_train_cases"] == 2


def test_cli_train_multicase_synthetic(cases, tmp_path):
    out = tmp_path / "mc"
    assert cli_main(["train-multicase", "--case_path", str(cases / "a"),
                     "--output_dir", str(out), "--n_cases", "2",
                     "--n_test_cases", "2", "--epochs", "2",
                     "--hidden_dim", "8", "--num_layers", "1",
                     "--device", "cpu"]) == 0
    res = json.loads((out / "generalization.json").read_text())
    assert set(res) == GEN_KEYS and res["devices"] == 1
    assert len(res["history"]) == 2


def test_cli_train_multicase_cases(cases, tmp_path):
    out = tmp_path / "mc"
    assert cli_main(["train-multicase", "--case_paths", str(cases / "a"),
                     str(cases / "b"), "--output_dir", str(out),
                     "--epochs", "2", "--hidden_dim", "8", "--num_layers",
                     "1", "--backend", "pallas", "--layer_type", "GAT",
                     "--norm_type", "batch", "--device", "cpu"]) == 0
    hist = json.loads((out / "history.json").read_text())
    assert [set(h) for h in hist] == [{"epoch", "loss", "seconds"}] * 2
    assert all(np.isfinite(h["loss"]) for h in hist)
    # the first case's fit, as the JAX CLI writes it
    want = foam_case_source([str(cases / "a")], chunk=1, time_dir="282")[1]
    assert (out / "normalizer.json").read_text() == json.dumps(
        want.to_dict(), indent=2)


# ------------------------------------------------------------ benches
def test_cli_bench_dp_on_one_cpu_rank(cases, capsys):
    assert cli_main(["bench", "--mode", "dp", "--case_path", str(cases / "a"),
                     "--layer_type", "GCN", "--num_layers", "1",
                     "--hidden_dim", "8", "--backend", "dense", "--steps",
                     "4", "--device", "cpu", "--devices", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert DP_KEYS <= set(res) and set(res) - DP_KEYS == {"device"}
    assert res["value"] == 1.0 and res["n_devices"] == 1
    assert res["platform"] == "cpu" and res["timing"] == "marginal_eager"
    assert "by construction" in res["note"]
    assert res["step_s_1dev"] > 0 and res["n_edges"] > 0


def test_partition_shard_benchmark_keys_and_counts():
    res = run_partition_shard_benchmark(
        global_nodes=2 * 24 * 16, n_shards=2, num_layers=1, hidden_dim=8,
        nx=24, steps=2, compute_dtype="float32", device="cpu")
    assert set(res) == SHARD_KEYS
    assert res["shard_nodes"] == 24 * 16
    assert res["n_edges"] == 2 * 23 * 16 + 2 * 24 * 15
    assert res["value"] == res["n_edges"] / res["step_median_s"]
    assert res["mode"] == "partitioned_shard_forward"


def test_dp_bench_defaults_to_the_card(cases):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from gnn_bfs_rans_tpu_torch.utils.dp_bench import run_dp_scaling_benchmark

    with pytest.raises(RuntimeError, match="CUDA was requested"):
        run_dp_scaling_benchmark(case_path=str(cases / "a"))
