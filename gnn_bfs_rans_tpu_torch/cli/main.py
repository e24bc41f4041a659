"""Command-line interface of the port: the ``train`` and ``infer``
subcommands.

``python -m gnn_bfs_rans_tpu_torch train|infer [flags]`` take the flags of
the JAX package's subcommands (``gnn_bfs_rans_tpu/cli/main.py:27-76,
455-527``) plus ``--device`` (``cuda`` by default; ``cpu`` runs the
kernels' plain versions).  ``train`` defaults to the JAX CLI's model
(``--layer_type GCN``, 6 layers, hidden 256) and trains every layer type
on every backend: ``--backend pallas`` (the port's default, where the JAX
CLI defaults to ``dense``: the banded kernels, or the dense branches on a
mesh without a band), ``dense`` or ``segment``, with ``--norm_type batch``,
``layer`` or ``none``.  The band is built only for ``pallas``, as the JAX
CLI builds it.  ``--epoch_block`` > 1 runs whole epochs on the device, a
CUDA graph of the epoch replayed once an epoch, and synchronizes the host
once a block (the JAX CLI's ``lax.scan`` blocks).  The JAX trainer's
``--progress`` bar and ``--no_aot`` cache are not ported, nor are the
other subcommands.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def cmd_train(args) -> int:
    from ..graph.band import LAYER_COMPONENTS
    from ..models.flow_gnn import ModelConfig
    from ..train.data import load_dataset
    from ..train.loop import TrainConfig
    from ..train.trainer import Trainer

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg_dict = {k: v for k, v in vars(args).items() if k != "func"}
    (out_dir / "config.json").write_text(json.dumps(cfg_dict, indent=2))

    print("Loading dataset...")
    dataset = load_dataset(
        args.case_path, args.time_dirs, include_uniform=args.include_uniform,
        with_band=args.backend == "pallas",
        band_components=LAYER_COMPONENTS.get(args.layer_type))
    print(f"Loaded {dataset.n_snapshots} samples: {dataset.time_dirs}")
    dataset.normalizer.save(out_dir / "normalizer.json")

    mcfg = ModelConfig(
        hidden_dim=args.hidden_dim, num_layers=args.num_layers,
        layer_type=args.layer_type, dropout=args.dropout,
        backend=args.backend, compute_dtype=args.compute_dtype,
        norm_type=args.norm_type)
    tcfg = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, epochs=args.epochs,
        batch_size=args.batch_size,
        pressure_ref_weight=args.pressure_ref_weight,
        curriculum_epochs=args.curriculum_epochs, save_every=args.save_every,
        seed=args.seed, plateau_min_lr=args.min_lr, scheduler=args.scheduler,
        epoch_block=args.epoch_block, bn_recal=args.bn_recal)
    trainer = Trainer(dataset, mcfg, tcfg, output_dir=out_dir,
                      device=args.device)
    trainer.initialize(resume=args.resume)
    trainer.train()
    print("Training completed!")
    return 0


def cmd_infer(args) -> int:
    from ..foam.reader import FoamCase
    from ..foam.writer import save_fields_openfoam_format
    from ..infer import predict_case
    from ..train.metrics import compare_with_reference

    print(f"Loading model from {args.checkpoint}...")
    _, fields, graph = predict_case(
        args.checkpoint, args.case_path, name=args.checkpoint_name,
        boundary_self_loops=args.boundary_self_loops,
        recalibrate_bn=args.recalibrate_bn,
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

    p = sub.add_parser("train", help="Train a FlowGNN surrogate")
    p.add_argument("--case_path", type=str, default="OpenFOAM-data",
                   help="Path to OpenFOAM case directory")
    p.add_argument("--time_dirs", type=str, nargs="+",
                   default=["0", "100", "200", "282"])
    p.add_argument("--output_dir", type=str, default="checkpoints")
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--num_layers", type=int, default=6)
    p.add_argument("--layer_type", type=str, default="GCN",
                   choices=["GCN", "GAT", "GIN", "Transformer"])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--pressure_ref_weight", type=float, default=0.1)
    p.add_argument("--curriculum_epochs", type=int, default=0)
    p.add_argument("--min_lr", type=float, default=0.0,
                   help="Floor for the LR schedule")
    p.add_argument("--scheduler", type=str, default="plateau",
                   choices=["plateau", "cosine"])
    p.add_argument("--epoch_block", type=int, default=1,
                   help="Epochs per device-resident block (1 = host-driven "
                        "per-epoch loop; >1 replays a CUDA graph of whole "
                        "epochs and syncs the host once per block)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", type=str, default="pallas",
                   choices=["segment", "dense", "pallas"],
                   help="pallas: the banded kernels (the dense branches on "
                        "a mesh without a band); dense: padded neighbour "
                        "lists; segment: COO scatter-add")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "mixed"])
    p.add_argument("--norm_type", type=str, default="batch",
                   choices=["batch", "layer", "none"])
    p.add_argument("--bn_recal", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="BatchNorm recalibration: eval/best-selection on "
                        "exact batch statistics and checkpoints saved with "
                        "them. auto = on for bfloat16/mixed batch-norm "
                        "models")
    p.add_argument("--include_uniform", action="store_true",
                   help="Keep uniform (initial-condition) snapshots")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in output_dir")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.set_defaults(func=cmd_train)

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
                   help="Re-estimate BatchNorm running stats from one "
                        "exact pass over the case first")
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
