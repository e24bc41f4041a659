"""The readers of the program's spans and counters (``core/spans.py``,
``metrics/*.py``) on a tiny CPU run of a cell, and on a program that keeps
no such store."""

from __future__ import annotations

import pytest

from perfbench import run
from perfbench.core import spans
from perfbench.tests import tiny

READERS = ("epoch_ms.train", "block_end_ms.train", "checkpoint_ms.train",
           "checkpoint_mb.train", "trainer_init_s.train")


def _read(rec=None) -> dict:
    return {name: run.reader(name)(rec) for name in READERS}


def test_the_readers_on_a_cpu_run(tmp_path):
    cell = "gat4x256-bf16.train-box12k"
    res = tiny.run_tiny(cell, tmp_path, trace=True)
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # no device time off the card
    assert "epoch_ms.train" not in got
    for name in READERS[1:]:
        assert got[name] > 0, name
    w = spans.window()
    saves = w.named("trainer.save")
    blocks = w.named("trainer.block")
    assert len(blocks) == res["attempted"] and saves
    # the writer's thread counts the bytes: the run's counter holds them
    assert got["checkpoint_mb.train"] * 1e6 * len(saves) == pytest.approx(
        w.run.counters["checkpoint.bytes"])
    assert got["checkpoint_ms.train"] == pytest.approx(
        sum(s.ms for s in saves) / len(saves))
    # the blocks' ends hold every save
    assert got["block_end_ms.train"] * len(blocks) >= sum(
        s.ms for s in saves)
    assert got["trainer_init_s.train"] == pytest.approx(
        spans.last("trainer.init").ms / 1e3)


def test_nothing_to_read_is_no_number(monkeypatch):
    from gnn_bfs_rans_tpu_torch.utils import trace

    # a program without the store: the readers report nothing
    monkeypatch.setattr(spans, "_store", lambda: None)
    assert _read() == dict.fromkeys(READERS)
    monkeypatch.undo()
    # a window whose spans were dropped
    with trace.span("trainer.init"):
        pass
    with trace.span("trainer.run", counters=True):
        with trace.span("trainer.block", first=1, last=1):
            pass
    assert spans.window() is not None
    monkeypatch.setattr(trace, "dropped_since", lambda span: True)
    assert spans.window() is None
    got = _read()
    assert got.pop("trainer_init_s.train") is not None
    assert got == dict.fromkeys(READERS[:4])
