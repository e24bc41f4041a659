"""Run one cell of the benchmark once, and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell's configuration file, its traffic mix
(``perfbench/traffic/<mix>.json``, whose ``kind`` names the driver
``perfbench/drivers/<kind>.py``), the limits of its check
(``perfbench/limits/<cell>.json``: the numbers compared and their
limits) and each metric's reader
(``perfbench/metrics/<metric>.py``, a ``read(rec)`` that returns a number
or None).  A run:

1. exits 2 without a result when the card (or as many as the cell asks
   for) is missing;
2. set-up: the driver builds the program's kernels, makes the inputs and
   weights from ``--seed`` and warms up every shape the traffic uses
   (``setup_s``, from the process's start, with a line of its phases on
   standard error);
3. the window: ``--seconds`` of traffic (with ``--trace 1`` the traffic
   file's ``trace_seconds`` under ``torch.profiler``);
4. exits 3 without a result if JAX or the JAX package is loaded;
5. reads the device memory peak, frees the program's state, and checks
   what the timed path produced against the plain reference
   (``perfbench/reference/``), each number against its limit;
6. prints the compared numbers on standard error, then the result line:
   ``{"correct", "attempted", "failed", "metrics", "device"[,
   "breakdown"], "checks"}`` — the cell's end-to-end metrics with
   ``--trace 0``, its per-layer metrics with ``--trace 1``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_bfs_rans_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (compared whole: ``gnn_bfs_rans_tpu_torch`` is not
    ``gnn_bfs_rans_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(bench: dict, name: str) -> dict:
    """A cell's workload entry, configuration, traffic and limits."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c["file"] for c in bench["configs"]
                if c["name"] == cell["config"])
    return {"workload": cell,
            "config": load_json(ROOT / conf),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{name}.json")}


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones (a per-layer metric without a
    ``workloads`` list goes with every cell that reports what it moves)."""
    def listed(m):
        return cell in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if listed(m) is not False]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (listed(m) if "workloads" in m else m["moves"] in names)]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(files: dict, metrics: list[dict], seed: int, seconds: float,
             trace: bool, device: str, out_dir: Path,
             t_process: float = T_PROCESS) -> dict:
    """Set-up, window, check and metrics of one run (no card check)."""
    import torch

    from perfbench.core.context import Context
    from perfbench.core.trace import breakdown
    from perfbench.yardstick import flops

    wl = files["workload"]
    ctx = Context(workload=wl, config=files["config"],
                  traffic=files["traffic"], limits=files["limits"],
                  seed=seed, seconds=seconds, trace=trace, device=device,
                  out_dir=out_dir)
    driver = importlib.import_module(
        f"perfbench.drivers.{files['traffic']['kind']}")
    state = driver.setup(ctx)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    ctx.log("setup " + " ".join(f"{k} {v:.3f}" for k, v in
                                {**ctx.setup_phases, "setup_s": setup_s}
                                .items()))
    records = driver.window(ctx, state)
    if cuda:
        torch.cuda.synchronize()
    # the run's peak, set-up and window, before the reference runs
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        ctx.log("forbidden modules loaded: " + ", ".join(found))
        raise SystemExit(3)
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    rec = {"setup_s": setup_s, "window": records, "trace": ctx.tracer.result,
           "memory_peak_bytes": peak, "config": ctx.config,
           "traffic": ctx.traffic, "device_name": name,
           "peaks": (flops.peaks(name, ctx.config["compute_dtype"])
                     if cuda else None),
           "graph": {"n_nodes": state.n_nodes, "n_edges": state.n_edges}}
    values = {}
    for m in metrics:
        v = reader(m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    driver.release(state)
    numbers = driver.check(ctx, state)
    # the numbers the cell's limits file names are compared; the others
    # are read out only
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in ctx.limits.items()}
    ctx.log("readings " + " ".join(f"{k} {v!r}" for k, v in numbers.items()
                                   if k not in checks))
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": torch.cuda.device_count() if cuda else 0,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": records["attempted"],
              "failed": records["failed"], "metrics": values, "device": dev}
    if trace and ctx.tracer.result is not None:
        dev["busy_s"] = ctx.tracer.result["busy_s"]
        dev["window_s"] = ctx.tracer.result["window_s"]
        result["breakdown"] = breakdown(ctx.tracer.result)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    files = cell_files(bench, args.workload)
    import torch

    chips = files["workload"]["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"[perfbench] needs {chips} CUDA device(s); found {cards}",
              file=sys.stderr)
        return 2
    out_dir = (Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
               / "perfbench" / args.workload)
    try:
        result = run_cell(files, metrics_of(bench, args.workload,
                                            bool(args.trace)),
                          args.seed, args.seconds, bool(args.trace),
                          "cuda", out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print("[perfbench] forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"[perfbench] check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"[perfbench] correct {result['correct']}", file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
