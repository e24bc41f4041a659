"""Headline benchmark entry: prints ONE JSON line with the headline metric.

Counterpart of the repository's root ``bench.py``: edge-messages/sec/card
of the 4-layer, hidden-256, 4-head GAT forward on the banded kernels in
bfloat16, over ``BASELINE.json``'s north-star target of 1e8 (a target,
not a measurement), timed as chained marginal device latency
(``utils/bench.py``), with the roofline guard and the steady-state
cross-check.

    python -m gnn_bfs_rans_tpu_torch.bench [--case_path P] [--device D]
"""

from __future__ import annotations

import argparse
import json
import sys

# the result keys the headline line carries under "detail"
DETAIL_KEYS = (
    "mode", "layer_type", "num_layers", "hidden_dim", "backend",
    "compute_dtype", "n_edges", "step_median_s", "step_steady_s",
    "steps_per_sec", "platform", "timing", "timing_detail",
    "cross_check", "matmul_flops", "mfu", "bound",
    "bytes_basis", "hbm_bytes_xla", "hbm_bytes_est", "hbm_frac",
    "roofline_min_s",
)


def headline(result: dict) -> dict:
    """The one line printed from a :func:`run_benchmark` result."""
    return {
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "vs_baseline": result["vs_baseline"],
        "mfu": result["mfu"],
        "detail": {k: result[k] for k in DETAIL_KEYS},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gnn_bfs_rans_tpu_torch.bench",
        description="Headline benchmark: GAT 4x256 bf16 forward")
    parser.add_argument("--case_path", type=str, default="OpenFOAM-data",
                        help="Path to OpenFOAM case directory")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "versions)")
    args = parser.parse_args(argv)
    from .utils.bench import run_benchmark

    result = run_benchmark(
        case_path=args.case_path,
        layer_type="GAT",
        num_layers=4,
        hidden_dim=256,
        backend="pallas",
        compute_dtype="bfloat16",
        mode="forward",
        device=args.device,
    )
    print(json.dumps(headline(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
