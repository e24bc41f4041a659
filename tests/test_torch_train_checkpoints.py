"""The ``Trainer``'s checkpoints through ``train/checkpoint.py``'s
``CheckpointWriter`` (CPU): a snapshot of the state at the save, the
files written on the writer's thread.

* Two blocks of two epochs (GCN dense, 2 layers, BatchNorm recalibration
  on), each write held back: every checkpoint's ``.pt`` and
  ``.meta.json`` are byte-equal to a synchronous ``save_checkpoint`` of
  the state at its save, its ``.train.pt`` loads to bit-equal tensors,
  every file is on disk when ``train()`` returns, and
  ``checkpoint.async_saves`` counts the saves.
* A write that fails makes ``train()`` raise, chained to its error.
* A SIGINT inside a block while writes are held back: every queued
  checkpoint is whole when ``train()`` raises, and resuming from the
  latest ``epoch_N`` gives the uninterrupted run's history.
* The writer alone under a short switch interval: many saves of tensors
  changed in place after each, every file holding its save's values, in
  the order saved.

The tiny case of ``tests/test_torch_trace.py`` (336 cells, 3 snapshots).
"""

import signal
import sys
import threading
import time

import pytest
import torch

from gnn_bfs_rans_tpu_torch.foam import drifting_box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig
from gnn_bfs_rans_tpu_torch.train import checkpoint as ckpt
from gnn_bfs_rans_tpu_torch.train import loop as tl
from gnn_bfs_rans_tpu_torch.train.data import load_dataset
from gnn_bfs_rans_tpu_torch.train.recal import exact_stats
from gnn_bfs_rans_tpu_torch.train.trainer import Trainer
from gnn_bfs_rans_tpu_torch.utils import trace

CFG = dict(hidden_dim=16, num_layers=2, layer_type="GCN", backend="dense",
           dropout=0.0)
EXTS = (".pt", ".train.pt", ".meta.json")


@pytest.fixture(scope="module")
def small_case(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_ckpt") / "case"
    times = ["100", "200", "282"]
    generate_box_case(path, 24, 14, 1, time_dirs=times,
                      time_field_fn=drifting_box_fields)
    return load_dataset(path, times, with_band=False)


def _trainer(dataset, out, **tkw):
    return Trainer(dataset, ModelConfig(**CFG),
                   tl.TrainConfig(**{"lr": 1e-3, **tkw}), output_dir=out,
                   log_fn=lambda *_: None, device="cpu")


@pytest.fixture
def held_writes(monkeypatch):
    """Each write starts 50 ms late, so the epochs after a save run before
    its files are written."""
    write = ckpt.write_checkpoint

    def late(*args, **kwargs):
        time.sleep(0.05)
        return write(*args, **kwargs)

    monkeypatch.setattr(ckpt, "write_checkpoint", late)


def _sync_save(tr, directory, name, epoch, val_loss, extra):
    """The trainer's checkpoint written on the calling thread."""
    state = tr.model.state_dict()
    if tr.bn_recal:
        state = {**state, **exact_stats(tr.model, tr.graph)}
        extra = {**extra, "bn_recalibrated": True}
    ckpt.save_checkpoint(
        directory, name, state, model_config=tr.model_config,
        normalizer=tr.dataset.normalizer, epoch=epoch, val_loss=val_loss,
        train_config=tr.config.to_dict(), extra=extra,
        train_state={"optimizer": tr.optimizer.state_dict()})


def _assert_same_tree(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_checkpoints_equal_synchronous_saves(small_case, tmp_path,
                                             held_writes):
    out, sync = tmp_path / "run", tmp_path / "sync"
    tr = _trainer(small_case, out, epochs=4, epoch_block=2, save_every=2,
                  bn_recal="on")
    save, saves = tr._save, []

    def both(name, epoch, val_loss, extra):
        saves.append(name)
        _sync_save(tr, sync, name, epoch, val_loss, extra)
        save(name, epoch, val_loss, extra)

    tr._save = both
    before = trace.counters().get("checkpoint.async_saves", 0)
    tr.train()
    # on disk when train() returns, though each write started late
    names = set(saves)
    assert {"epoch_2", "epoch_4"} <= names
    for name in names:
        for ext in EXTS:
            assert (out / f"{name}{ext}").is_file(), (name, ext)
    assert trace.counters()["checkpoint.async_saves"] - before == len(saves)
    for name in names:
        for ext in (".pt", ".meta.json"):
            assert (out / f"{name}{ext}").read_bytes() == \
                (sync / f"{name}{ext}").read_bytes(), (name, ext)
        _assert_same_tree(ckpt.load_train_state(out, name),
                          ckpt.load_train_state(sync, name), name)
    # the state moved between the saves: each file holds its own epoch's
    assert (out / "epoch_2.pt").read_bytes() != \
        (out / "epoch_4.pt").read_bytes()


def test_a_failed_write_raises_from_train(small_case, tmp_path,
                                          monkeypatch):
    def full_disk(obj, f, *args, **kwargs):
        raise OSError("No space left on device")

    monkeypatch.setattr(torch, "save", full_disk)
    tr = _trainer(small_case, tmp_path / "run", epochs=2, epoch_block=2,
                  save_every=2)
    with pytest.raises(RuntimeError, match="writing checkpoint") as err:
        tr.train()
    assert isinstance(err.value.__cause__, OSError)
    assert not list((tmp_path / "run").glob("*.meta.json"))


def test_an_interrupt_leaves_every_queued_checkpoint_whole(
        small_case, tmp_path, monkeypatch, held_writes):
    """A SIGINT during epoch 3's step (blocks of 2): epoch 3 ends, and
    ``best``, ``epoch_2`` and the interrupted ``epoch_3`` are whole when
    ``train()`` raises; resuming from ``epoch_3`` (cosine schedule: the lr
    depends on the epoch alone) gives the uninterrupted run's history."""
    cfg = dict(epochs=6, epoch_block=2, save_every=2, batch_size=3,
               scheduler="cosine")
    want = _trainer(small_case, tmp_path / "full", **cfg).train()

    out = tmp_path / "run"
    step, calls = tl.train_step, []

    def step_with_sigint(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            signal.raise_signal(signal.SIGINT)
        return step(*args, **kwargs)

    monkeypatch.setattr(tl, "train_step", step_with_sigint)
    with pytest.raises(KeyboardInterrupt):
        _trainer(small_case, out, **cfg).train()
    monkeypatch.setattr(tl, "train_step", step)
    for name in ("best", "epoch_2", "epoch_3"):
        ckpt.load_checkpoint(out, name)
        ckpt.load_train_state(out, name)
    assert ckpt.load_meta(out, "epoch_3")["interrupted"] is True
    assert ckpt.latest_checkpoint(out) == "epoch_3"

    resumed = _trainer(small_case, out, **cfg)
    resumed.initialize(resume=True)
    assert resumed.start_epoch == 4
    got = resumed.train()
    for key in ("epoch", "train_loss", "val_loss", "learning_rate"):
        assert got[key] == want[key], key


def test_the_writer_keeps_each_saves_state_under_load(tmp_path):
    """40 saves of a tensor changed in place after each, two buffer sets,
    a 1 µs switch interval: every file holds its save's value, and the
    writes ran in the order saved."""
    writer = ckpt.CheckpointWriter("cpu")
    x = torch.zeros(1 << 12)
    n, before = 40, trace.mark()

    def saves():
        for i in range(n):
            writer.save(tmp_path, f"s{i}", {"x": x}, {"i": i},
                        train_state={"step": torch.tensor(float(i))})
            x.add_(1)
        writer.wait()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=saves)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    for i in range(n):
        state, meta = ckpt.load_checkpoint(tmp_path, f"s{i}")
        assert meta == {"i": i}
        assert torch.equal(state["x"], torch.full((1 << 12,), float(i)))
        assert ckpt.load_train_state(tmp_path, f"s{i}")["step"] == i
    writes = [s for s in trace.records()
              if s.name == "checkpoint.write"][-n:]
    assert [s.attrs["name"] for s in writes] == [f"s{i}" for i in range(n)]
    assert "checkpoint.async_saves" in trace.summary(before)
