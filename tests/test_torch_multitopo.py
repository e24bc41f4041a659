"""Multi-topology training (``gnn_bfs_rans_tpu_torch/train/multitopo.py``,
CLI ``train-multitopo``) against the JAX package's ``train/multitopo.py``.

The three generated boxes of ``tests/test_multitopo.py`` (48, 192 and 60
cells; ``node_align=128``, ``edge_align=512``): the 48- and 60-cell meshes
share the 128-row bucket, the 192-cell mesh has its own.

* the datasets agree: buckets and their cases, true counts, graphs,
  targets and the one normalizer fitted over all cases;
* a 3-epoch run (GCN 2×16, LayerNorm, ``dense``, dropout 0, f32) from
  JAX's initial state (``init_state`` on the largest bucket with the split
  of ``PRNGKey(seed)``, as the JAX trainer makes it) agrees with the JAX
  ``MultiTopoTrainer``: train, val and per-case losses within 1e-4
  relative, final parameters within 1e-4 of the largest entry, and
  ``predict_case`` (original cell order) within 1e-4 of the largest
  output;
* the ``best`` checkpoint serves through the port's ``Predictor`` as the
  JAX one does through JAX's;
* three cases in two buckets make exactly two step graphs (the
  counterpart of ``test_bucket_sharing_avoids_recompiles``);
* ``train-multitopo --device cpu`` exits 0 and writes the history and
  the checkpoints; ``foam_case_source`` rejects the two topologies.
"""

import json

import jax
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.infer import Predictor as JaxPredictor
from gnn_bfs_rans_tpu.models.flow_gnn import FlowGNN as JaxFlowGNN
from gnn_bfs_rans_tpu.models.flow_gnn import ModelConfig as JaxModelConfig
from gnn_bfs_rans_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_bfs_rans_tpu.train.loop import init_state
from gnn_bfs_rans_tpu.train.multitopo import (
    MultiTopoTrainer as JaxMultiTopoTrainer,
)
from gnn_bfs_rans_tpu.train.multitopo import (
    load_multitopo_dataset as jax_load_multitopo,
)
from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
from gnn_bfs_rans_tpu_torch.compat.from_jax import (
    flax_tree_from_state_dict,
    state_dict_from_flax,
)
from gnn_bfs_rans_tpu_torch.foam import generate_box_case
from gnn_bfs_rans_tpu_torch.infer import Predictor
from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig
from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig
from gnn_bfs_rans_tpu_torch.train.multitopo import (
    MultiTopoTrainer,
    load_multitopo_dataset,
)
from gnn_bfs_rans_tpu_torch.train.streaming import foam_case_source

ALIGN = dict(node_align=128, edge_align=512)
MODEL = dict(hidden_dim=16, num_layers=2, layer_type="GCN", dropout=0.0,
             norm_type="layer", backend="dense")
EPOCHS, LR, SEED = 3, 5e-3, 0
TOL = 1e-4


@pytest.fixture(scope="module")
def boxes(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_multitopo")
    paths = []
    for name, dims in (("case_small", (4, 4, 3)), ("case_big", (8, 6, 4)),
                       ("case_small2", (5, 4, 3))):
        generate_box_case(root / name, *dims, time_dirs=("282",))
        paths.append(root / name)
    return paths


@pytest.fixture(scope="module")
def datasets(boxes):
    return (load_multitopo_dataset(boxes, time_dir="282", **ALIGN),
            jax_load_multitopo(boxes, time_dir="282", **ALIGN))


@pytest.fixture(scope="module")
def runs(datasets, tmp_path_factory):
    """The JAX trainer and the port's (CPU) after EPOCHS epochs from the
    same initial state."""
    ds, jds = datasets
    root = tmp_path_factory.mktemp("torch_multitopo_runs")
    jcfg = JaxModelConfig(**MODEL)
    jtcfg = JaxTrainConfig(lr=LR, epochs=EPOCHS, seed=SEED)
    jtr = JaxMultiTopoTrainer(jds, jcfg, jtcfg, output_dir=root / "jax",
                              log_fn=lambda *_: None)
    jtr.train()
    # the JAX trainer's initial state: init_state on the largest bucket
    # with the first split of PRNGKey(seed)
    big = max(jds.cases, key=lambda c: c.graph.n_pad)
    _, init_rng = jax.random.split(jax.random.PRNGKey(SEED))
    start = init_state(JaxFlowGNN(jcfg), big.graph, jtcfg, init_rng)
    cfg = ModelConfig(**MODEL)
    sd = state_dict_from_flax(jax.tree.map(np.asarray, start.params),
                              jax.tree.map(np.asarray, start.batch_stats),
                              cfg)
    tr = MultiTopoTrainer(ds, cfg, TrainConfig(lr=LR, epochs=EPOCHS,
                                               seed=SEED),
                          output_dir=root / "port", log_fn=lambda *_: None,
                          device="cpu", init_state=sd)
    tr.train()
    return jtr, tr, root


def test_buckets_and_normalizer_match_jax(datasets):
    ds, jds = datasets
    assert ds.buckets == jds.buckets
    assert sorted(len(v) for v in ds.buckets.values()) == [1, 2]
    assert ds.normalizer.to_dict() == jds.normalizer.to_dict()
    for c, jc in zip(ds.cases, jds.cases):
        assert (c.name, c.n_nodes, c.n_edges) == (jc.name, jc.n_nodes,
                                                  jc.n_edges)
        assert c.graph.n_nodes == c.graph.n_pad == jc.graph.n_nodes
        assert c.graph.n_edges == c.graph.e_pad == jc.graph.n_edges
        assert c.graph.band is None
        np.testing.assert_array_equal(c.targets, np.asarray(jc.targets))
        for name in ("node_feat", "senders", "receivers", "edge_feat",
                     "node_mask", "nbr_idx", "nbr_mask", "perm"):
            np.testing.assert_array_equal(
                getattr(c.graph, name).numpy(),
                np.asarray(getattr(jc.graph, name)), err_msg=name)
    assert [c.n_nodes for c in ds.cases] == [48, 192, 60]


def test_three_epochs_match_jax(runs):
    jtr, tr, _ = runs
    jh, h = jtr.history, tr.history
    assert h["epoch"] == jh["epoch"] == list(range(1, EPOCHS + 1))
    assert h["learning_rate"] == pytest.approx(jh["learning_rate"])
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(h[key], jh[key], rtol=TOL, err_msg=key)
    np.testing.assert_allclose(h["per_case_loss"], jh["per_case_loss"],
                               rtol=TOL)
    assert h["train_loss"][-1] < h["train_loss"][0]
    got, _ = flax_tree_from_state_dict(tr.model.state_dict(), tr.model_config)
    want = jax.tree_util.tree_flatten_with_path(jtr.state.params)[0]
    got = dict((jax.tree_util.keystr(k), v) for k, v in
               jax.tree_util.tree_flatten_with_path(got)[0])
    assert sorted(got) == sorted(jax.tree_util.keystr(k) for k, _ in want)
    p_max = max(np.abs(np.asarray(v)).max() for _, v in want)
    for k, v in want:
        err = np.abs(got[jax.tree_util.keystr(k)] - np.asarray(v)).max()
        assert err <= TOL * p_max, (jax.tree_util.keystr(k), err)


def test_predict_case_in_cell_order_matches_jax(runs, datasets):
    jtr, tr, _ = runs
    for i, c in enumerate(datasets[0].cases):
        got, want = tr.predict_case(i), jtr.predict_case(i)
        assert got.shape == (c.n_nodes, 7)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * np.abs(want).max())
        # the original cell order: the case's graph forward, un-permuted
        with torch.no_grad():
            tr.model.eval()
            out = tr.model(c.graph).numpy()[: c.n_nodes]
        perm = c.graph.perm.numpy()[: c.n_nodes]
        np.testing.assert_array_equal(got[perm], out)


def test_best_checkpoint_serves(runs, datasets):
    jtr, tr, root = runs
    meta = json.loads((root / "port" / "best.meta.json").read_text())
    assert meta["multitopo_cases"] == [c.name for c in datasets[0].cases]
    pred = Predictor.from_checkpoint(root / "port", "best", device="cpu")
    jpred = JaxPredictor.from_checkpoint(root / "jax", "best", aot=False)
    got = pred.predict_fields(datasets[0].cases[1].graph)
    want = jpred.predict_fields(datasets[1].cases[1].graph)
    assert got["U"].shape[1] == 3
    for name, w in want.items():
        assert np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=TOL * np.abs(w).max(), err_msg=name)


def test_one_step_graph_a_bucket(runs):
    """Three cases in two buckets: two step graphs and two eval graphs."""
    _, tr, _ = runs
    assert sorted(k[0] for k in tr._graphs) == ["eval", "eval", "step",
                                                "step"]
    assert {k[1] for k in tr._graphs} == set(tr.dataset.buckets)


def test_cli_train_multitopo(boxes, tmp_path, capsys):
    out = tmp_path / "out"
    assert cli_main(["train-multitopo", "--case_paths", *map(str, boxes),
                     "--output_dir", str(out), "--epochs", "2",
                     "--hidden_dim", "8", "--num_layers", "1",
                     "--node_align", "128", "--edge_align", "512",
                     "--device", "cpu"]) == 0
    assert "Multi-topology training completed!" in capsys.readouterr().out
    hist = json.loads((out / "training_history.json").read_text())
    assert hist["epoch"] == [1, 2] and len(hist["per_case_loss"][-1]) == 3
    for name in ("best", "epoch_2"):
        assert (out / f"{name}.pt").exists()
        meta = json.loads((out / f"{name}.meta.json").read_text())
        assert meta["model_config"]["backend"] == "dense"


def test_cli_defaults_match_jax():
    from gnn_bfs_rans_tpu.cli.main import build_parser as jax_parser
    from gnn_bfs_rans_tpu_torch.cli.main import build_parser

    argv = ["train-multitopo", "--case_paths", "a"]
    got = vars(build_parser().parse_args(argv))
    want = vars(jax_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    for d in (got, want):
        d.pop("func")
    assert got == want


def test_foam_case_source_rejects_two_topologies(boxes):
    a, b, _ = boxes
    with pytest.raises(ValueError, match="topology"):
        _, _, gen = foam_case_source([str(a), str(b)], chunk=2,
                                     time_dir="282")
        next(gen)
