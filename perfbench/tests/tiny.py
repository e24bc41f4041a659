"""A cell's files cut to a size the CPU runs in seconds: the published
widths (hidden 256, 4 heads) on two layers, a 40 × 6 box (or a 24 × 12
grid), blocks of 3 epochs."""

from __future__ import annotations

from perfbench import run


def bench() -> dict:
    return run.load_json(run.ROOT / "BENCHMARK.json")


def files(cell: str) -> dict:
    f = run.cell_files(bench(), cell)
    f["config"] = dict(f["config"], num_layers=2)
    t = dict(f["traffic"])
    t["mesh"] = ({"kind": "box", "nx": 40, "ny": 6, "nz": 1}
                 if t["mesh"]["kind"] == "box"
                 else {"kind": "grid", "nx": 24, "ny": 12})
    t.update(epoch_block=3, save_every=3, trace_seconds=0.3)
    f["traffic"] = t
    return f


def cells() -> list[str]:
    return [w["name"] for w in bench()["workloads"]]


def configs() -> list[str]:
    return [c["name"] for c in bench()["configs"]]


def config(name: str) -> dict:
    """A configuration on two layers."""
    path = next(c["file"] for c in bench()["configs"] if c["name"] == name)
    return dict(run.load_json(run.ROOT / path), num_layers=2)


def run_tiny(cell: str, tmp_path, seed: int = 2 ** 31 + 17,
             trace: bool = False, seconds: float = 0.4) -> dict:
    return run.run_cell(files(cell), run.metrics_of(bench(), cell, trace),
                        seed, seconds, trace, "cpu", tmp_path / cell)
