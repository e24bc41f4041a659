"""Command-line interface of the port: the ``infer`` subcommand.

``python -m gnn_bfs_rans_tpu_torch infer [flags]`` takes the flags of the
JAX package's ``infer`` (``gnn_bfs_rans_tpu/cli/main.py:503-527``) plus
``--device``.  The other subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def cmd_infer(args) -> int:
    from ..foam.reader import FoamCase
    from ..foam.writer import save_fields_openfoam_format
    from ..infer import predict_case
    from ..train.metrics import compare_with_reference

    if args.recalibrate_bn:
        raise NotImplementedError(
            "--recalibrate_bn needs train/recal.py, which is not ported yet")
    print(f"Loading model from {args.checkpoint}...")
    _, fields, graph = predict_case(
        args.checkpoint, args.case_path, name=args.checkpoint_name,
        boundary_self_loops=args.boundary_self_loops,
        exact_bn={"auto": "auto", "on": True, "off": False}[args.bn_exact],
        device=args.device,
    )
    print(f"Graph: {graph.n_nodes} nodes, {graph.n_edges} edges")
    print("Prediction completed!")

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.save_format in ("numpy", "both"):
        np.savez(out_dir / "predictions.npz", **fields)
        print(f"Saved predictions to {out_dir / 'predictions.npz'}")
    if args.save_format in ("openfoam", "both"):
        save_fields_openfoam_format(fields, out_dir, "predicted")
        print(f"Saved predictions in OpenFOAM format to {out_dir / 'predicted'}/")

    if args.reference_time:
        ref = FoamCase(args.case_path).load_fields(args.reference_time)
        stats = compare_with_reference(fields, ref)
        print("\n=== Field Comparison ===")
        for name, s in stats.items():
            print(f"{name}:")
            for k, v in s.items():
                print(f"  {k.upper():5s} {v:.6e}")
        (out_dir / "comparison.json").write_text(json.dumps(stats, indent=2))
    print("\nInference completed!")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gnn_bfs_rans_tpu_torch",
        description="GNN flow-surrogate framework, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("infer", help="Run inference with a trained model")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Checkpoint directory")
    p.add_argument("--checkpoint_name", type=str, default="best")
    p.add_argument("--case_path", type=str, default="OpenFOAM-data",
                   help="Path to OpenFOAM case directory")
    p.add_argument("--output_dir", type=str, default="predictions")
    p.add_argument("--reference_time", type=str, default=None)
    p.add_argument("--save_format", type=str, default="numpy",
                   choices=["numpy", "openfoam", "both"])
    p.add_argument("--recalibrate_bn", action="store_true",
                   help="Re-estimate BatchNorm running stats first (not "
                        "ported yet: raises)")
    p.add_argument("--bn_exact", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="Predict through the deterministic train-mode "
                        "forward (exact in-forward BN statistics). auto = "
                        "on for checkpoints whose meta has bn_recalibrated")
    p.add_argument("--boundary_self_loops", action="store_true",
                   help="Add one self-edge per boundary face (the "
                        "reference's unfiltered-inference graph)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.set_defaults(func=cmd_infer)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
