"""Readings that the check's limits are set from, many seeds in one
process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--control] [--fault frozen|frozen_replay|half_batch|altered] \\
        [--seconds 2]

For each seed it sets the cell up as a run does (at the cell's own
size), runs a short window, and prints one JSON line: the program's
numbers, or with ``--control`` those of the reference computed in the
precision below the configuration's (``reference/model.py``: 8-bit
floats for bfloat16, TF32 for float32) put in the program's place, or
with ``--fault`` those of the program with that fault planted
(``perfbench/faults.py``).  The limits of
``perfbench/limits/<cell>.json`` lie between the program's largest
reading and the smallest reading of the control and the faults.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from perfbench import run  # noqa: E402


def readings(files: dict, seed: int, control: bool, fault: str | None,
             seconds: float, device: str, out_dir: Path) -> dict:
    from perfbench import faults
    from perfbench.core.context import Context
    from perfbench.reference import model

    ctx = Context(workload=files["workload"], config=files["config"],
                  traffic=files["traffic"], limits=files["limits"],
                  seed=seed, seconds=seconds, trace=False, device=device,
                  out_dir=out_dir)
    driver = importlib.import_module(
        f"perfbench.drivers.{files['traffic']['kind']}")
    with faults.planted(fault) if fault else contextlib.nullcontext():
        state = driver.setup(ctx)
        driver.window(ctx, state)
    driver.release(state)
    quant = model.control_precision(files["config"]) if control else "f32"
    return driver.check(ctx, state, quant=quant)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    files = run.cell_files(bench, args.workload)
    out_dir = (Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
               / "perfbench-control" / args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = readings(files, seed, args.control, args.fault, args.seconds,
                        args.device, out_dir)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
