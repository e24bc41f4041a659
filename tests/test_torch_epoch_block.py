"""The port's on-device epoch blocks (``--epoch_block`` > 1) vs the JAX
package (CPU).

* ``plateau_update`` (the device plateau scheduler) against the JAX
  ``plateau_update`` and the host ``ReduceLROnPlateau`` on the metric
  sequence of ``tests/test_epoch_block.py``, and its ``min_lr`` floor;
* three epochs of ``epoch_body`` (batch 3: one batch an epoch, in order)
  against the JAX ``make_epoch_block`` from the same weights
  (``compat/from_jax.py``): GCN on ``dense`` and GAT on ``pallas`` (JAX
  in interpret mode), f32, dropout 0;
* the ``Trainer``: one block of K epochs equals K blocks of 1 bit for bit;
  blocks and checkpoints cut where the JAX ``_run_blocks`` cuts them; one
  ``metrics.jsonl`` row an epoch; ``best`` holds the best epoch's
  parameters; uneven batches fall back to the per-epoch loop with a log
  line; a SIGINT inside a block saves the epoch it ends, and resuming
  from it reproduces the uninterrupted run (cosine schedule);
* ``train --epoch_block 2 --device cpu`` and ``--resume``.

Small sizes: a 336-cell generated case with three snapshots, 2 layers.
The blocks replayed as CUDA graphs are held against the same blocks run
eagerly on the card by ``test_torch_cuda.py``.
"""

import json
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.foam import FoamCase as JaxFoamCase
from gnn_bfs_rans_tpu.graph.build import build_graph as jax_build_graph
from gnn_bfs_rans_tpu.models.flow_gnn import FlowGNN as JaxFlowGNN
from gnn_bfs_rans_tpu.models.flow_gnn import ModelConfig as JaxModelConfig
from gnn_bfs_rans_tpu.train.loop import ReduceLROnPlateau as JaxPlateau
from gnn_bfs_rans_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_bfs_rans_tpu.train.loop import TrainState, make_optimizer
from gnn_bfs_rans_tpu.train.loop import init_epoch_block_carry as jax_carry
from gnn_bfs_rans_tpu.train.loop import make_epoch_block
from gnn_bfs_rans_tpu.train.loop import plateau_init as jax_plateau_init
from gnn_bfs_rans_tpu.train.loop import plateau_update as jax_plateau_update
from gnn_bfs_rans_tpu.train.trainer import Trainer as JaxTrainer
from gnn_bfs_rans_tpu.train.trainer import empty_history as jax_history
from gnn_bfs_rans_tpu_torch.cli.main import main as cli_main
from gnn_bfs_rans_tpu_torch.compat.from_jax import (
    flax_tree_from_state_dict,
    state_dict_from_flax,
)
from gnn_bfs_rans_tpu_torch.foam import drifting_box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.foam.reader import FoamCase
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
from gnn_bfs_rans_tpu_torch.graph.build import build_graph
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.train import loop as tl
from gnn_bfs_rans_tpu_torch.train.checkpoint import load_checkpoint
from gnn_bfs_rans_tpu_torch.train.data import load_dataset
from gnn_bfs_rans_tpu_torch.train.trainer import Trainer

TIMES = ("100", "200", "282")
LR = 1e-3
EPOCHS = 3
MODELS = {
    "GCN-dense": dict(layer_type="GCN", backend="dense", hidden_dim=16),
    "GAT-pallas": dict(layer_type="GAT", backend="pallas", hidden_dim=32,
                       heads=4),
}
# biases whose shift the BatchNorm removes: each conv's (zero gradient in
# exact arithmetic), and input_proj's, which reaches the BatchNorm through
# the residual and a conv that nearly keeps a constant shift (the GAT's
# attention mean exactly, up to its LeakyReLU; GCN's normalized rows
# nearly).  Their gradients are rounding noise beside the others', which
# Adam's step lr·m/√v turns into moves of up to ±lr a step on either side:
# measured 4.4e-2 (GAT) and 2.3e-4 (GCN) of input_proj's bias's own max
# apart after three epochs, every other leaf ≤ 3.8e-5.
NOISE_BIASES = {"['input_proj']['bias']", "['conv_0']['bias']",
                "['conv_1']['bias']"}
# the metric sequence of tests/test_epoch_block.py::TestPlateauUpdate
METRICS = [1.0, 0.9, 0.9, 0.9, 0.9, 0.5, 0.5001, 0.6, 0.7, 0.7] + list(
    np.random.default_rng(0).uniform(0.3, 0.5, 30))


@pytest.fixture(scope="module", autouse=True)
def warm_exp():
    """torch's first multi-threaded f32 exp in a process has been seen to
    return values up to 1e-4 off in one thread's chunk; one call first."""
    torch.exp(torch.randn(1 << 19))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_epoch_block") / "case"
    generate_box_case(path, 24, 14, 1, time_dirs=TIMES,
                      time_field_fn=drifting_box_fields)
    return path


@pytest.fixture(scope="module")
def dataset(case):
    return load_dataset(case, list(TIMES), with_band=False)


# ------------------------------------------------------------- the plateau
@pytest.mark.parametrize("form", ["sequence", "min_lr"])
def test_plateau_update_matches_jax_and_host(form):
    """lr, best and the bad-epoch count after every metric: the port's
    device scheduler, the JAX one and the host one (1e-6 relative: f32
    state against the host's f64)."""
    if form == "sequence":
        kw, metrics = dict(plateau_patience=2, plateau_threshold=1e-4), METRICS
    else:
        kw, metrics = dict(plateau_patience=0, plateau_min_lr=0.3), [1.0] * 10
    kw = dict(lr=1.0, plateau_factor=0.5, **kw)
    cfg, jcfg = tl.TrainConfig(**kw), JaxTrainConfig(**kw)
    host = tl.ReduceLROnPlateau(1.0, factor=0.5,
                                patience=kw["plateau_patience"],
                                threshold=cfg.plateau_threshold,
                                min_lr=cfg.plateau_min_lr)
    jhost = JaxPlateau(1.0, factor=0.5, patience=kw["plateau_patience"],
                       threshold=cfg.plateau_threshold,
                       min_lr=cfg.plateau_min_lr)
    s, js = tl.plateau_init(1.0), jax_plateau_init(1.0)
    for m in metrics:
        host_lr = host.step(m)
        assert jhost.step(m) == host_lr
        s = tl.plateau_update(s, torch.tensor(m, dtype=torch.float32), cfg)
        js = jax_plateau_update(js, jnp.asarray(m, jnp.float32), jcfg)
        assert s.lr.dtype == torch.float32 and s.num_bad.dtype == torch.int32
        assert float(s.lr) == pytest.approx(host_lr, rel=1e-6), m
        assert float(s.lr) == pytest.approx(float(js.lr), rel=1e-6), m
        assert int(s.num_bad) == int(js.num_bad) == host.num_bad, m
        assert float(s.best) == pytest.approx(float(js.best), rel=1e-6)
    assert float(s.best) == pytest.approx(host.best, rel=1e-6)
    if form == "min_lr":
        assert float(s.lr) == pytest.approx(0.3)


# ------------------------------------------- one block against the JAX one
def _variables(cfg, graph, seed=0):
    """Seeded flax init with non-trivial BN parameters and statistics."""
    variables = JaxFlowGNN(cfg).init(jax.random.PRNGKey(seed), graph,
                                     train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    rng = np.random.default_rng(seed)
    h = cfg.hidden_dim
    for i in range(cfg.num_layers):
        params[f"bn_{i}"]["scale"] = (1 + 0.1 * rng.normal(size=h)).astype(np.float32)
        params[f"bn_{i}"]["bias"] = (0.1 * rng.normal(size=h)).astype(np.float32)
        stats[f"bn_{i}"]["mean"] = (0.5 * rng.normal(size=h)).astype(np.float32)
        stats[f"bn_{i}"]["var"] = rng.uniform(0.5, 2.0, size=h).astype(np.float32)
    return params, stats


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_block_matches_jax_make_epoch_block(case, model):
    """Three epochs, batch 3 (one batch an epoch, so both run the snapshots
    in order), from the same weights: per-epoch train and val loss within
    1e-5 relative, lr within 1e-6, the same best epoch, parameters and
    batch statistics within 1e-4 of each leaf's max, and the biases whose
    gradient is rounding noise (``NOISE_BIASES``) moved by no more than
    1.01 × epochs × lr."""
    spec = MODELS[model]
    jcfg = JaxModelConfig(num_layers=2, dropout=0.0, **spec)
    mesh = JaxFoamCase(case).load_mesh()
    pallas = spec["backend"] == "pallas"
    comps = LAYER_COMPONENTS[spec["layer_type"]]
    jgraph = jax_build_graph(mesh, with_band=pallas, band_components=comps)
    jtcfg = JaxTrainConfig(lr=LR, weight_decay=1e-4, batch_size=3,
                           epochs=EPOCHS)
    params, stats = _variables(jcfg, jgraph)
    targets = np.random.default_rng(3).normal(
        size=(3, jgraph.n_pad, 7)).astype(np.float32)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats,
                       opt_state=make_optimizer(jtcfg).init(params))
    block = make_epoch_block(JaxFlowGNN(jcfg), jtcfg, 3)
    jc, outs = block(jax_carry(state, LR, jax.random.PRNGKey(0)), jgraph,
                     jnp.asarray(targets), jnp.asarray(0, jnp.int32),
                     n_epochs=EPOCHS)

    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tcfg = tl.TrainConfig.from_dict(jtcfg.to_dict())
    graph = build_graph(FoamCase(case).load_mesh(), with_band=pallas,
                        band_components=comps)
    port = FlowGNN(cfg)
    port.load_state_dict(state_dict_from_flax(params, stats, cfg))
    opt = tl.make_optimizer(port, tcfg)
    carry = tl.init_epoch_block_carry(port, LR, EPOCHS)
    for _ in range(EPOCHS):
        tl.epoch_body(port, opt, graph, torch.from_numpy(targets), carry,
                      tcfg, n_batches=1)
    rows = carry.outs.numpy().astype(np.float64)

    np.testing.assert_allclose(rows[:, 0], outs["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(rows[:, 1], outs["val_loss"], rtol=1e-5)
    np.testing.assert_allclose(rows[:, 2], outs["lr"], rtol=0, atol=1e-6)
    for j, f in enumerate(tl.FIELDS):
        np.testing.assert_allclose(rows[:, 3 + j], outs["errors"][f],
                                   rtol=1e-4)
    assert int(carry.best_epoch) == int(jc.best_epoch)
    assert int(carry.epoch) == EPOCHS and int(carry.slot) == EPOCHS
    got_params, got_stats = flax_tree_from_state_dict(port.state_dict(), cfg)
    start, got = _leaves(params), _leaves(got_params)
    for k, w in _leaves(jc.state.params).items():
        if k in NOISE_BIASES:
            assert np.abs(got[k] - start[k]).max() <= 1.01 * EPOCHS * LR, k
            continue
        err = np.abs(got[k] - w).max()
        assert err <= 1e-4 * np.abs(w).max(), f"param {k}: {err}"
    # the running variances do not see a shift; the running means record
    # the noise biases' shifts (two in each block's BatchNorm input, each
    # apart by at most 2·E·lr) with the EMA's weight 1 − 0.9^E
    got_s = _leaves(got_stats)
    shift = (1 - 0.9 ** EPOCHS) * 2 * (2 * EPOCHS * LR)
    for k, w in _leaves(jc.state.batch_stats).items():
        err = np.abs(got_s[k] - w).max()
        limit = 1e-4 * np.abs(w).max() + (shift if k.endswith("['mean']")
                                          else 0.0)
        assert err <= limit, f"batch_stats {k}: {err}"


# ---------------------------------------------------------------- Trainer
CFG = dict(hidden_dim=16, num_layers=2, layer_type="GCN", backend="dense")


def _trainer(dataset, out, dropout=0.0, log=None, **tkw):
    return Trainer(dataset, ModelConfig(**CFG, dropout=dropout),
                   tl.TrainConfig(**{"lr": LR, **tkw}), output_dir=out,
                   log_fn=log or (lambda *_: None), device="cpu")


def _history(out):
    return json.loads((out / "training_history.json").read_text())


def test_one_block_equals_blocks_of_one(dataset, tmp_path):
    """A block of 3 epochs and 3 blocks of 1 (cut at every ``save_every``
    multiple) from the same seeds, batch 1 (a permutation drawn from the
    trainer's generator each epoch) and dropout 0.1: the same history and
    parameters bit for bit."""
    runs = []
    for save_every in (3, 1):
        out = tmp_path / f"every{save_every}"
        tr = _trainer(dataset, out, dropout=0.1, epochs=3, epoch_block=3,
                      save_every=save_every)
        hist = tr.train()
        runs.append((hist, tr.model.state_dict()))
    (h3, s3), (h1, s1) = runs
    for key in ("epoch", "train_loss", "val_loss", "learning_rate"):
        assert h3[key] == h1[key], key
    for k in s3:
        assert torch.equal(s3[k], s1[k]), k
    # the permutations moved the losses: not three copies of one epoch
    assert len(set(h3["train_loss"])) == 3


def _jax_block_cuts(cfg: dict, tmp_path):
    """The JAX trainer's ``_run_blocks`` on a stand-in block function:
    (blocks as (first, last, freeze), checkpoints as (name, epoch))."""
    jtcfg = JaxTrainConfig(**cfg)
    blocks, saves = [], []

    def block_fn(carry, graph, targets, epoch0, n_epochs, freeze=False):
        e0 = int(epoch0)
        blocks.append((e0 + 1, e0 + n_epochs, bool(freeze)))
        val = 1.0 / (e0 + 1 + jnp.arange(n_epochs, dtype=jnp.float32))
        outs = {"train_loss": val, "val_loss": val,
                "lr": jnp.full(n_epochs, carry.sched.lr),
                "errors": {f: jnp.zeros(n_epochs) for f in tl.FIELDS}}
        return carry.replace(best_val=val[-1],
                             best_epoch=jnp.int32(e0 + n_epochs)), outs

    state = TrainState(step=jnp.zeros((), jnp.int32), params={},
                       batch_stats={}, opt_state=())
    stub = types.SimpleNamespace(
        log=lambda *_: None, output_dir=tmp_path, history=jax_history(),
        graph=None, targets=None, state=state, _pbar=None,
        scheduler=types.SimpleNamespace(lr=jtcfg.lr, best=float("inf")),
        best_val=float("inf"), save_history=lambda: None,
        _save=lambda name, epoch, val, extra: saves.append((name, epoch)))
    JaxTrainer._run_blocks(stub, jtcfg, 3, block_fn,
                           jax_carry(state, jtcfg.lr, jax.random.PRNGKey(0)),
                           1)
    return blocks, saves


def test_trainer_cuts_blocks_as_jax(dataset, tmp_path, monkeypatch):
    """epoch_block 3, save_every 2, curriculum 1, 5 epochs: the blocks
    (their epochs and pressure freeze) and the periodic checkpoints are the
    JAX ``_run_blocks``'s; the curriculum halves the lr at epoch 2; one
    ``metrics.jsonl`` row an epoch; ``best`` holds the parameters of the
    best epoch, as a run cut into blocks of 1 saved them."""
    cfg = dict(epochs=5, epoch_block=3, save_every=2, curriculum_epochs=1,
               batch_size=3)
    want_blocks, want_saves = _jax_block_cuts({**cfg, "lr": LR}, tmp_path)
    blocks, saves, lines = [], [], []
    end_block, save = Trainer._end_block, Trainer._save

    def record_block(self, carry, epoch, k, t0):
        blocks.append((epoch, epoch + k - 1, freezes[-1]))
        return end_block(self, carry, epoch, k, t0)

    def record_save(self, name, epoch, val_loss, extra):
        saves.append((name, epoch))
        save(self, name, epoch, val_loss, extra)

    freezes = []
    epoch_graph = Trainer._epoch
    monkeypatch.setattr(Trainer, "_end_block", record_block)
    monkeypatch.setattr(Trainer, "_save", record_save)
    monkeypatch.setattr(Trainer, "_epoch", lambda self, freeze: (
        freezes.append(bool(freeze)), epoch_graph(self, freeze))[1])
    out = tmp_path / "run"
    hist = _trainer(dataset, out, log=lines.append, **cfg).train()

    assert blocks == want_blocks == [(1, 1, True), (2, 2, False),
                                     (3, 4, False), (5, 5, False)]
    periodic = [s for s in saves if s[0] != "best"]
    assert periodic == [s for s in want_saves if s[0] != "best"]
    assert periodic == [("epoch_2", 2), ("epoch_4", 4), ("epoch_5", 5)]
    assert any("Curriculum phase 2" in ln for ln in lines)
    assert hist["epoch"] == [1, 2, 3, 4, 5]
    assert hist["learning_rate"][0] == pytest.approx(LR)
    assert hist["learning_rate"][1:] == pytest.approx([LR / 2] * 4)
    rows = [json.loads(ln) for ln in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2, 3, 4, 5]
    assert all(r["epoch_seconds"] > 0 for r in rows)

    monkeypatch.undo()
    every = tmp_path / "every_epoch"
    _trainer(dataset, every, **{**cfg, "save_every": 1}).train()
    best_state, best_meta = load_checkpoint(out, "best")
    vals = hist["val_loss"]
    assert best_meta["epoch"] == 1 + int(np.argmin(vals))
    assert best_meta["val_loss"] == pytest.approx(min(vals), rel=1e-6)
    ref, _ = load_checkpoint(every, f"epoch_{best_meta['epoch']}")
    for k in ref:
        assert torch.equal(best_state[k], ref[k]), k


def test_uneven_batches_fall_back_to_the_per_epoch_loop(dataset, tmp_path):
    lines = []
    hist = _trainer(dataset, tmp_path / "run", log=lines.append, epochs=2,
                    epoch_block=2, batch_size=2).train()
    assert any("falling back to the per-epoch loop" in ln for ln in lines)
    assert not any(ln.startswith("Epochs ") for ln in lines)
    assert hist["epoch"] == [1, 2]
    with pytest.raises(ValueError, match="divisible"):
        tl.epoch_batches(3, 2)


def test_interrupt_inside_a_block_saves_its_epoch(dataset, tmp_path,
                                                  monkeypatch):
    """A SIGINT during epoch 2's train step (a block of 3): epoch 2 runs
    whole, the interrupt is raised after it, and ``epoch_2`` is saved with
    ``interrupted: True`` and the history of epochs 1 and 2; resuming from
    it (cosine schedule: the lr depends on the epoch alone) reproduces the
    uninterrupted run's epochs 3 to 5 and its parameters bit for bit."""
    cfg = dict(epochs=5, epoch_block=3, save_every=10, batch_size=3,
               scheduler="cosine")
    full = _trainer(dataset, tmp_path / "full", **cfg)
    want = full.train()

    out = tmp_path / "run"
    step, calls = tl.train_step, []

    def step_with_sigint(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            signal.raise_signal(signal.SIGINT)
        return step(*args, **kwargs)

    monkeypatch.setattr(tl, "train_step", step_with_sigint)
    with pytest.raises(KeyboardInterrupt):
        _trainer(dataset, out, **cfg).train()
    monkeypatch.setattr(tl, "train_step", step)
    _, meta = load_checkpoint(out, "epoch_2")
    assert meta["interrupted"] is True and meta["epoch"] == 2
    assert _history(out)["epoch"] == [1, 2]
    assert meta["val_loss"] == want["val_loss"][1]

    resumed = _trainer(dataset, out, **cfg)
    resumed.initialize(resume=True)
    assert resumed.start_epoch == 3
    got = resumed.train()
    for key in ("epoch", "train_loss", "val_loss", "learning_rate"):
        assert got[key] == want[key], key
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_cli_trains_in_blocks_and_resumes(case, tmp_path):
    out = tmp_path / "run"
    argv = ["train", "--case_path", str(case), "--time_dirs", *TIMES,
            "--output_dir", str(out), "--hidden_dim", "16", "--num_layers",
            "2", "--save_every", "2", "--lr", "3e-3", "--device", "cpu",
            "--epoch_block", "2"]
    assert cli_main([*argv, "--epochs", "3"]) == 0
    assert _history(out)["epoch"] == [1, 2, 3]
    for name in ("epoch_2", "epoch_3", "best"):
        assert (out / f"{name}.pt").is_file(), name
    assert cli_main([*argv, "--epochs", "5", "--resume"]) == 0
    hist = _history(out)
    assert hist["epoch"] == [1, 2, 3, 4, 5]
    assert np.isfinite(hist["train_loss"]).all()
    rows = [json.loads(ln) for ln in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2, 3, 4, 5]
