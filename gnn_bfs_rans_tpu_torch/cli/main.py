"""Command-line interface of the port: train / infer / export-torch /
visualize / plot-lines / plot-training / check-data / check-coordinates /
train-multicase / train-multitopo / bench.

``python -m gnn_bfs_rans_tpu_torch <subcommand> [flags]`` take the flags
of the JAX package's subcommands (``gnn_bfs_rans_tpu/cli/main.py``), and
those that run a model (``train``, ``train-multicase``, ``train-multitopo``,
``infer``, ``visualize``, ``plot-lines``, ``bench``) also ``--device`` (``cuda`` by default; ``cpu``
runs the kernels' plain versions).  ``train`` defaults to the JAX CLI's model
(``--layer_type GCN``, 6 layers, hidden 256) and trains every layer type,
and MeshGraphNets (``--layer_type MeshGraphNets``: ``--num_layers``
message-passing steps of latent ``--hidden_dim``, its own LayerNorms and no
BatchNorm whatever ``--norm_type`` says, ``--dropout 0``; on the card its
edge and node blocks' kernels take ``--compute_dtype bfloat16``), on
every backend: ``--backend pallas`` (the port's default, where the JAX
CLI defaults to ``dense``: the banded kernels, or the dense branches on a
mesh without a band), ``dense`` or ``segment``, with ``--norm_type batch``,
``layer`` or ``none``.  The band is built only for ``pallas``, as the JAX
CLI builds it.  ``--epoch_block`` > 1 runs whole epochs on the device, a
CUDA graph of the epoch replayed once an epoch, and synchronizes the host
once a block (the JAX CLI's ``lax.scan`` blocks).  ``bench`` prints one
JSON line from ``utils/bench.py::run_benchmark`` (``--synthetic N``:
``utils/synthetic.py::run_scale_benchmark`` on a ~N-cell grid), its
``--backend`` defaulting to ``pallas`` as ``train``'s does; ``--mode dp
--devices N`` the data-parallel scaling efficiency at 1 and N ranks
(``utils/dp_bench.py``: one rank a card over NCCL; gloo ranks with
``--device cpu``).  ``train-multicase`` (the JAX subcommand's flags and
defaults) trains over a streamed family of cases sharing one mesh topology
on ``--devices`` ranks (default: every visible card; 1 with ``--device
cpu``): real OpenFOAM cases (``--case_paths``) or a perturbed-geometry
family of ``--case_path`` with analytic targets and the
geometry-generalization report, writing ``normalizer.json``,
``history.json`` and ``generalization.json`` as the JAX CLI does.
``train-multitopo`` (the JAX subcommand's flags and defaults: ``--backend
dense``, GCN 3×64, LayerNorm, 30 epochs) trains one model over cases of
different meshes, one CUDA graph of the step a padding bucket
(``train/multitopo.py``).
``export-torch`` writes a checkpoint in the reference's ``.pt`` format
(``compat/torch_port.py``).  ``visualize`` and ``plot-lines`` serve the
checkpoint on the case (``infer.predict_case``) and plot it against a
reference time; they and ``plot-training`` need matplotlib.
``check-data`` and ``check-coordinates`` run on the host alone.  Not
ported: the JAX trainer's ``--no_aot`` (its compile cache).
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
    comps = LAYER_COMPONENTS.get(args.layer_type)
    dataset = load_dataset(
        args.case_path, args.time_dirs, include_uniform=args.include_uniform,
        with_band=args.backend == "pallas" and comps is not None,
        band_components=comps)
    print(f"Loaded {dataset.n_snapshots} samples: {dataset.time_dirs}")
    dataset.normalizer.save(out_dir / "normalizer.json")

    mcfg = ModelConfig(
        hidden_dim=args.hidden_dim, num_layers=args.num_layers,
        layer_type=args.layer_type, dropout=args.dropout,
        backend=args.backend, compute_dtype=args.compute_dtype,
        norm_type=args.norm_type,
        # MeshGraphNets' LayerNorms belong to the architecture
        use_batch_norm=args.layer_type != "MeshGraphNets")
    tcfg = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, epochs=args.epochs,
        batch_size=args.batch_size,
        pressure_ref_weight=args.pressure_ref_weight,
        curriculum_epochs=args.curriculum_epochs, save_every=args.save_every,
        seed=args.seed, plateau_min_lr=args.min_lr, scheduler=args.scheduler,
        epoch_block=args.epoch_block, bn_recal=args.bn_recal)
    trainer = Trainer(dataset, mcfg, tcfg, output_dir=out_dir,
                      device=args.device, progress=args.progress)
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


def _predict_filtered(args):
    """Common prefix of visualize/plot-lines: predict + z>=0 filter."""
    from ..foam.reader import FoamCase
    from ..infer import predict_case

    _, fields, _ = predict_case(args.checkpoint, args.case_path,
                                name=args.checkpoint_name,
                                device=args.device)
    case = FoamCase(args.case_path)
    mesh = case.load_mesh()
    ref_raw = case.load_fields(args.reference_time)
    ref = {"U": ref_raw["U"]}
    for name in ("p", "k", "epsilon", "nut"):
        ref[name] = ref_raw[name].reshape(-1, 1)
    cc = mesh.cell_centers
    z_mask = cc[:, 2] >= 0
    if z_mask.sum() == 0:
        z_mask = np.ones(len(cc), dtype=bool)
    cc = cc[z_mask]
    fields = {k: np.asarray(v)[z_mask] for k, v in fields.items()}
    ref = {k: np.asarray(v)[z_mask] for k, v in ref.items()}
    return fields, ref, cc


def cmd_export_torch(args) -> int:
    from ..compat.torch_port import save_torch_checkpoint
    from ..models.flow_gnn import ModelConfig
    from ..train.checkpoint import load_checkpoint
    from ..train.normalization import FieldNormalizer

    state, meta = load_checkpoint(args.checkpoint, args.checkpoint_name)
    mcfg = ModelConfig.from_dict(meta["model_config"])
    normalizer = (FieldNormalizer.from_dict(meta["normalizer"])
                  if meta.get("normalizer") else None)
    save_torch_checkpoint(
        args.output, state, mcfg, normalizer=normalizer,
        epoch=int(meta.get("epoch", 0)),
        val_loss=float(meta.get("val_loss", float("nan"))),
        train_config=meta.get("train_config"))
    print(f"Exported {args.checkpoint}/{args.checkpoint_name} -> {args.output} "
          f"({mcfg.layer_type} {mcfg.hidden_dim}x{mcfg.num_layers}, "
          "reference torch format)")
    return 0


def cmd_visualize(args) -> int:
    from ..viz.fields import compare_fields

    fields, ref, cc = _predict_filtered(args)
    print("Creating visualization plots...")
    stats = compare_fields(fields, ref, cc, args.output_dir)
    (Path(args.output_dir) / "error_stats.json").write_text(
        json.dumps(stats, indent=2))
    print(f"\nVisualization complete! Plots saved to {args.output_dir}")
    return 0


def cmd_plot_lines(args) -> int:
    from ..viz.lines import plot_line_comparison

    fields, ref, cc = _predict_filtered(args)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"\nPlotting along horizontal line Y = {args.y_line}...")
    plot_line_comparison(
        fields, ref, cc, y_line=args.y_line,
        output_path=out_dir / f"line_Y_{args.y_line:.3f}.png", tol=args.tol)
    print(f"\nPlotting along vertical line X = {args.x_line}...")
    plot_line_comparison(
        fields, ref, cc, x_line=args.x_line,
        output_path=out_dir / f"line_X_{args.x_line:.3f}.png", tol=args.tol)
    print(f"\nLine plots saved to {out_dir}")
    return 0


def cmd_plot_training(args) -> int:
    from ..viz.training import plot_field_errors_detailed, plot_training_curves

    if not Path(args.history).exists():
        print(f"Error: history file not found: {args.history}")
        return 1
    plot_training_curves(args.history, args.output)
    if args.detailed:
        plot_field_errors_detailed(args.history)
    return 0


def cmd_check_data(args) -> int:
    """Data-pipeline smoke check (parity with test_data_loading.py)."""
    from ..foam.reader import FoamCase
    from ..graph.build import build_graph

    try:
        case = FoamCase(args.case_path)
        print("Loading mesh...")
        mesh = case.load_mesh()
        print(f"  points: {mesh.n_points}")
        print(f"  faces: {mesh.n_faces} ({mesh.n_internal_faces} internal)")
        print(f"  cells: {mesh.n_cells} ({mesh.n_internal_cells} internal)")
        print(f"  boundaries: {list(mesh.boundaries)}")
        for td in args.time_dirs:
            fields = case.load_fields(td, n_cells=mesh.n_cells)
            shapes = {k: v.shape for k, v in fields.items()}
            print(f"  time {td}: {shapes}")
        print("Building graph...")
        graph = build_graph(mesh)
        print(f"  nodes: {graph.n_nodes} (padded {graph.n_pad})")
        print(f"  edges: {graph.n_edges} (padded {graph.e_pad})")
        print(f"  max degree: {graph.max_degree}")
        print("OK")
        return 0
    except Exception as e:  # smoke contract: exit code 1 on any failure
        print(f"FAILED: {e}")
        return 1


def cmd_check_coordinates(args) -> int:
    """Coordinate diagnostic (parity with check_coordinates.py)."""
    from ..foam.reader import FoamCase

    cc = FoamCase(args.case_path).load_mesh().cell_centers
    print("Cell center coordinate ranges:")
    for i, axis in enumerate("xyz"):
        print(f"  {axis}: [{cc[:, i].min():.6f}, {cc[:, i].max():.6f}]")
    # BFS region accounting (expectation from blockMeshDict, scale 0.001)
    upstream = (cc[:, 0] < 0).sum()
    downstream = (cc[:, 0] >= 0).sum()
    below_step = ((cc[:, 0] >= 0) & (cc[:, 1] < 0)).sum()
    print(f"BFS regions: upstream(x<0)={upstream}, downstream(x>=0)={downstream}, "
          f"recirculation(x>=0,y<0)={below_step}")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(12, 4))
        ax.scatter(cc[:, 0], cc[:, 1], s=0.2)
        ax.set_aspect("equal")
        ax.set_xlabel("X [m]")
        ax.set_ylabel("Y [m]")
        out = Path(args.output_dir) / "geometry.png"
        out.parent.mkdir(parents=True, exist_ok=True)
        plt.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        print(f"Saved geometry plot to {out}")
    return 0


def cmd_train_multicase(args) -> int:
    """Streamed multi-case training on ``--devices`` ranks; rank 0's
    results are written here (the JAX ``cmd_train_multicase``)."""
    import torch

    from ..device import resolve_device
    from ..parallel.distributed import launch
    from ..parallel.ranks import train_multicase_rank

    dev = resolve_device(args.device)
    n_dev = args.devices or (torch.cuda.device_count()
                             if dev.type == "cuda" else 1)
    print(f"Data ranks: {n_dev} × {dev.type}")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rank_args = {k: v for k, v in vars(args).items() if k != "func"}
    res = launch(train_multicase_rank, n_dev, (rank_args,), device=dev.type,
                 join_timeout_s=None)[0]
    if args.case_paths:
        res["normalizer"].save(out_dir / "normalizer.json")
        history = res["history"]
        for h in history:
            print(f"epoch {h['epoch']}: loss={h['loss']:.6f} "
                  f"({h['seconds']:.1f}s)")
        (out_dir / "history.json").write_text(json.dumps(history, indent=2))
        print("Multi-case training completed!")
        return 0
    print(f"final train loss: {res['history'][-1]['loss']:.6f}")
    print("per-field errors (train-family / held-out geometry / ratio):")
    for f in ("U", "p", "k", "epsilon", "nut"):
        tr, te = res["train_errors"][f], res["heldout_errors"][f]
        print(f"  {f:8s} {tr:.5f} / {te:.5f} / "
              f"{res['generalization_ratio'][f]:.2f}×")
    (out_dir / "generalization.json").write_text(json.dumps(res, indent=2))
    print(f"Saved report to {out_dir / 'generalization.json'}")
    return 0


def cmd_train_multitopo(args) -> int:
    """Training over cases with different mesh topologies, one graph of
    the step a padding bucket (the JAX ``cmd_train_multitopo``)."""
    from ..models.flow_gnn import ModelConfig
    from ..train.loop import TrainConfig
    from ..train.multitopo import MultiTopoTrainer, load_multitopo_dataset

    dataset = load_multitopo_dataset(
        args.case_paths, time_dir=args.time_dir,
        node_align=args.node_align, edge_align=args.edge_align)
    mcfg = ModelConfig(
        hidden_dim=args.hidden_dim, num_layers=args.num_layers,
        layer_type=args.layer_type, dropout=args.dropout,
        norm_type=args.norm_type, backend=args.backend)
    tcfg = TrainConfig(lr=args.lr, epochs=args.epochs, seed=args.seed)
    trainer = MultiTopoTrainer(dataset, mcfg, tcfg,
                               output_dir=args.output_dir,
                               device=args.device)
    trainer.train()
    print("Multi-topology training completed!")
    return 0


def cmd_bench(args) -> int:
    if args.mode == "dp":
        from ..utils.dp_bench import run_dp_scaling_benchmark

        result = run_dp_scaling_benchmark(
            n_devices=args.devices,
            case_path=args.case_path,
            layer_type=args.layer_type,
            num_layers=args.num_layers,
            hidden_dim=args.hidden_dim,
            backend=args.backend,
            compute_dtype=args.compute_dtype,
            steps=args.steps,
            device=args.device,
        )
        print(json.dumps(result))
        return 0
    if args.synthetic:
        from ..utils.synthetic import run_scale_benchmark

        result = run_scale_benchmark(
            n_nodes=args.synthetic,
            layer_type=args.layer_type,
            num_layers=args.num_layers,
            hidden_dim=args.hidden_dim,
            backend=args.backend,
            compute_dtype=args.compute_dtype,
            steps=args.steps,
            device=args.device,
        )
        print(json.dumps(result))
        return 0

    from ..utils.bench import run_benchmark

    result = run_benchmark(
        case_path=args.case_path,
        layer_type=args.layer_type,
        num_layers=args.num_layers,
        hidden_dim=args.hidden_dim,
        backend=args.backend,
        steps=args.steps,
        mode=args.mode,
        compute_dtype=args.compute_dtype,
        trace=args.trace,
        device=args.device,
    )
    print(json.dumps(result))
    return 0


def _served_plot_parser(sub, name: str, helptext: str, func):
    """The flags of a subcommand that serves a checkpoint on a case and
    plots it against a reference time."""
    p = sub.add_parser(name, help=helptext)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--checkpoint_name", type=str, default="best")
    p.add_argument("--case_path", type=str, default="OpenFOAM-data",
                   help="Path to OpenFOAM case directory")
    p.add_argument("--reference_time", type=str, default="282")
    p.add_argument("--output_dir", type=str, default="visualizations")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.set_defaults(func=func)
    return p


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gnn_bfs_rans_tpu_torch",
        description="GNN flow-surrogate framework, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="Train a FlowGNN or MeshGraphNets "
                                     "surrogate")
    p.add_argument("--case_path", type=str, default="OpenFOAM-data",
                   help="Path to OpenFOAM case directory")
    p.add_argument("--time_dirs", type=str, nargs="+",
                   default=["0", "100", "200", "282"])
    p.add_argument("--output_dir", type=str, default="checkpoints")
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--num_layers", type=int, default=6)
    p.add_argument("--layer_type", type=str, default="GCN",
                   choices=["GCN", "GAT", "GIN", "Transformer",
                            "MeshGraphNets"],
                   help="MeshGraphNets: --num_layers message-passing steps "
                        "of latent --hidden_dim, with its own LayerNorms "
                        "(no BatchNorm, whatever --norm_type says) and "
                        "--dropout 0")
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
                   choices=["batch", "layer", "none"],
                   help="the FlowGNN blocks' norm; MeshGraphNets takes none "
                        "of these (use_batch_norm off whatever this says)")
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
    p.add_argument("--progress", action="store_true",
                   help="Live tqdm epoch bar with loss postfix (parity with "
                        "the reference's per-batch bar, train.py:165,194)")
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

    p = sub.add_parser(
        "export-torch",
        help="Export a checkpoint to the reference's torch .pt format")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Checkpoint directory")
    p.add_argument("--checkpoint_name", type=str, default="best")
    p.add_argument("--output", type=str, default="best_model.pt")
    p.set_defaults(func=cmd_export_torch)

    p = _served_plot_parser(sub, "visualize", "Field-comparison plots",
                            cmd_visualize)
    p = _served_plot_parser(sub, "plot-lines", "Line-extraction plots",
                            cmd_plot_lines)
    p.add_argument("--x_line", type=float, default=0.15)
    p.add_argument("--y_line", type=float, default=0.005)
    p.add_argument("--tol", type=float, default=1e-4)

    p = sub.add_parser("plot-training", help="Training-curve plots")
    p.add_argument("--history", type=str,
                   default="checkpoints/training_history.json")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--detailed", action="store_true")
    p.set_defaults(func=cmd_plot_training)

    p = sub.add_parser("check-data", help="Data-pipeline smoke check")
    p.add_argument("--case_path", type=str, default="OpenFOAM-data",
                   help="Path to OpenFOAM case directory")
    p.add_argument("--time_dirs", type=str, nargs="+",
                   default=["0", "100", "200", "282"])
    p.set_defaults(func=cmd_check_data)

    p = sub.add_parser("check-coordinates", help="Coordinate diagnostic")
    p.add_argument("--case_path", type=str, default="OpenFOAM-data",
                   help="Path to OpenFOAM case directory")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--output_dir", type=str, default="visualizations")
    p.set_defaults(func=cmd_check_coordinates)

    p = sub.add_parser(
        "train-multicase",
        help="Streamed multi-case DP training / geometry generalization",
    )
    p.add_argument("--case_path", type=str, default="OpenFOAM-data",
                   help="Path to OpenFOAM case directory")
    p.add_argument("--case_paths", type=str, nargs="*", default=None,
                   help="Real OpenFOAM case dirs sharing one mesh topology; "
                        "omit for the synthetic perturbed-geometry family")
    p.add_argument("--time_dir", type=str, default="282")
    p.add_argument("--output_dir", type=str, default="multicase_out")
    p.add_argument("--devices", type=int, default=None,
                   help="Ranks (default: every visible card; 1 with "
                        "--device cpu)")
    p.add_argument("--n_cases", type=int, default=16)
    p.add_argument("--n_test_cases", type=int, default=4)
    p.add_argument("--amplitude", type=float, default=0.05)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--layer_type", type=str, default="GCN",
                   choices=["GCN", "GAT", "GIN", "Transformer"])
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--norm_type", type=str, default="layer",
                   choices=["batch", "layer", "none"])
    p.add_argument("--backend", type=str, default="dense",
                   choices=["segment", "dense", "pallas"])
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (one rank a card, NCCL) or cpu (gloo ranks)")
    p.set_defaults(func=cmd_train_multicase)

    p = sub.add_parser(
        "train-multitopo",
        help="Bucketed training over cases with different mesh topologies",
    )
    p.add_argument("--case_paths", type=str, nargs="+", required=True,
                   help="OpenFOAM case dirs; meshes may differ arbitrarily "
                        "(similar sizes share a padding bucket and its "
                        "CUDA graphs)")
    p.add_argument("--time_dir", type=str, default="282")
    p.add_argument("--output_dir", type=str, default="multitopo_out")
    p.add_argument("--node_align", type=int, default=512,
                   help="Node-padding bucket granularity")
    p.add_argument("--edge_align", type=int, default=2048,
                   help="Edge-padding bucket granularity")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--layer_type", type=str, default="GCN",
                   choices=["GCN", "GAT", "GIN", "Transformer"])
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--norm_type", type=str, default="layer",
                   choices=["batch", "layer", "none"])
    p.add_argument("--backend", type=str, default="dense",
                   choices=["segment", "dense", "pallas"])
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (CUDA graphs of the steps) or cpu")
    p.set_defaults(func=cmd_train_multitopo)

    p = sub.add_parser("bench", help="Performance benchmark")
    p.add_argument("--case_path", type=str, default="OpenFOAM-data",
                   help="Path to OpenFOAM case directory")
    p.add_argument("--layer_type", type=str, default="GAT",
                   choices=["GCN", "GAT", "GIN", "Transformer"])
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--backend", type=str, default="pallas",
                   choices=["segment", "dense", "pallas"])
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "mixed"])
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--mode", type=str, default="forward",
                   choices=["forward", "train", "dp"])
    p.add_argument("--devices", type=int, default=None,
                   help="mode=dp: ranks (default: every visible card; 1 "
                        "with --device cpu)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="Benchmark a synthetic quad-grid of ~N cells instead")
    p.add_argument("--trace", action="store_true",
                   help="Also capture a per-op device trace of the step — a "
                        "dispatch-independent third timing witness "
                        "(utils/trace.py); adds a 'trace' block to the JSON")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.set_defaults(func=cmd_bench)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
