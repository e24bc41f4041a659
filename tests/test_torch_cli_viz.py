"""The port's CLI subcommands, plots and public names, against the JAX package.

On generated cases (no BFS case): ``check-data`` and ``check-coordinates``
print what the JAX subcommands print and return their exit codes;
``train --progress`` (both trainer loops), ``infer
--boundary_self_loops``, ``plot-training``, ``visualize`` and
``plot-lines`` run through the port's CLI with ``--device cpu``; the
legacy contour plot, the normalization names and the loss
(``tests/test_normalization.py:57-136``), ``mean_normalized_error``,
``boundary_cell_mask`` and the mixed hex/prism case
(``tests/test_casegen_mixed.py``) are held against the JAX package.
"""

import builtins
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu.cli.main import main as jax_main
from gnn_bfs_rans_tpu.foam import FoamCase as JaxFoamCase
from gnn_bfs_rans_tpu.foam.casegen import (
    generate_mixed_prism_case as jax_mixed_case,
)
from gnn_bfs_rans_tpu.graph.build import boundary_cell_mask as jax_mask
from gnn_bfs_rans_tpu.graph.build import build_graph as jax_build_graph
from gnn_bfs_rans_tpu.models.flow_gnn import FlowGNN as JaxFlowGNN
from gnn_bfs_rans_tpu.models.flow_gnn import ModelConfig as JaxModelConfig
from gnn_bfs_rans_tpu.train import metrics as jax_metrics
from gnn_bfs_rans_tpu.train import normalization as jax_norm
from gnn_bfs_rans_tpu.viz.fields import collapse_to_2d, normalized_error
from gnn_bfs_rans_tpu_torch.cli.main import main
from gnn_bfs_rans_tpu_torch.compat.from_jax import state_dict_from_flax
from gnn_bfs_rans_tpu_torch.foam import (
    FoamCase,
    box_fields,
    drifting_box_fields,
    generate_box_case,
    generate_mixed_prism_case,
)
from gnn_bfs_rans_tpu_torch.graph import boundary_cell_mask, build_graph
from gnn_bfs_rans_tpu_torch.infer import load_graph
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.train import (
    FieldNormalizer,
    TrainConfig,
    Trainer,
    load_dataset,
    mean_normalized_error,
    pack_targets,
    unpack_fields,
    weighted_elementwise_mse,
    weighted_fieldwise_mse,
)
from gnn_bfs_rans_tpu_torch.viz.fields import plot_field_2d_legacy

REPO = Path(__file__).resolve().parents[1]
NX, NY = 24, 14
TIMES = ("100", "200")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_cli") / "case"
    info = generate_box_case(path, NX, NY, 1, time_dirs=TIMES,
                             time_field_fn=drifting_box_fields)
    return path, info


@pytest.fixture(scope="module")
def trained(case, tmp_path_factory):
    """``train --progress`` through the port's CLI: GCN, hidden 16, 1 layer,
    2 epochs on the CPU."""
    path, _ = case
    out = tmp_path_factory.mktemp("torch_cli_train") / "ckpt"
    rc = main(["train", "--case_path", str(path), "--time_dirs", *TIMES,
               "--output_dir", str(out), "--hidden_dim", "16",
               "--num_layers", "1", "--epochs", "2", "--save_every", "2",
               "--progress", "--device", "cpu"])
    assert rc == 0
    return out


def _both(argv, capsys, monkeypatch):
    """(exit code, stdout) of the port's and the JAX package's CLI."""
    out = []
    monkeypatch.setenv("GNN_BFS_RANS_TPU_NO_CACHE", "1")
    for fn in (main, jax_main):
        rc = fn(argv)
        out.append((rc, capsys.readouterr().out))
    return out


@pytest.mark.parametrize("good", [True, False], ids=["case", "bad_path"])
def test_check_data_matches_jax(case, capsys, monkeypatch, tmp_path, good):
    path, info = case
    argv = ["check-data", "--case_path",
            str(path if good else tmp_path / "nonexistent"),
            "--time_dirs", *TIMES]
    ours, theirs = _both(argv, capsys, monkeypatch)
    assert ours == theirs and ours[0] == (0 if good else 1)
    if good:
        edges = 2 * ((NX - 1) * NY + NX * (NY - 1))
        assert f"cells: {info['n_cells']}" in ours[1]
        assert f"edges: {edges} (" in ours[1]
    else:
        assert "FAILED: " in ours[1]


@pytest.mark.parametrize("plot", [False, True], ids=["text", "plot"])
def test_check_coordinates_matches_jax(case, capsys, monkeypatch, tmp_path,
                                       plot):
    path, _ = case
    argv = ["check-coordinates", "--case_path", str(path)]
    if plot:
        argv += ["--plot", "--output_dir", str(tmp_path)]
    ours, theirs = _both(argv, capsys, monkeypatch)
    assert ours == theirs and ours[0] == 0
    assert "Cell center coordinate ranges" in ours[1]
    assert (tmp_path / "geometry.png").exists() is plot


def test_python_m_entry_point(case):
    path, _ = case
    res = subprocess.run(
        [sys.executable, "-m", "gnn_bfs_rans_tpu_torch", "check-data",
         "--case_path", str(path), "--time_dirs", *TIMES],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.rstrip().endswith("OK")


@pytest.mark.parametrize("block", [1, 2], ids=["per_epoch", "blocked"])
def test_train_progress_bar(case, tmp_path, block):
    """``progress`` runs the tqdm bar through both trainer loops and puts
    the log back."""
    path, _ = case
    ds = load_dataset(path, list(TIMES))
    tr = Trainer(ds, ModelConfig(hidden_dim=16, num_layers=1),
                 TrainConfig(epochs=2, save_every=2, epoch_block=block),
                 output_dir=tmp_path, device="cpu", progress=True)
    tr.initialize()
    hist = tr.train()
    assert hist["epoch"] == [1, 2]
    assert tr._pbar is None and tr.log is print


def test_progress_without_tqdm(case, tmp_path, monkeypatch):
    """No tqdm (the card's machine): log it and train on."""
    real_import = builtins.__import__

    def no_tqdm(name, *args, **kwargs):
        if name == "tqdm":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tqdm)
    path, _ = case
    lines = []
    tr = Trainer(load_dataset(path, list(TIMES)),
                 ModelConfig(hidden_dim=16, num_layers=1),
                 TrainConfig(epochs=1, save_every=1),
                 output_dir=tmp_path, device="cpu", log_fn=lines.append,
                 progress=True)
    tr.initialize()
    assert tr.train()["epoch"] == [1]
    assert "tqdm not installed — --progress disabled" in lines
    assert not tr.progress


def test_infer_boundary_self_loops(case, trained, tmp_path, capsys):
    """One self-edge per boundary face (the reference's unfiltered-inference
    graph); the node count is unchanged."""
    path, info = case
    rc = main(["infer", "--checkpoint", str(trained), "--case_path",
               str(path), "--output_dir", str(tmp_path),
               "--boundary_self_loops", "--device", "cpu"])
    assert rc == 0
    edges = (2 * info["n_internal_faces"]
             + info["n_faces"] - info["n_internal_faces"])
    assert f"{info['n_cells']} nodes, {edges} edges" in capsys.readouterr().out
    assert np.load(tmp_path / "predictions.npz")["U"].shape == (
        info["n_cells"], 3)


def test_plot_training(trained, tmp_path):
    history = trained / "training_history.json"
    assert json.loads(history.read_text())["epoch"] == [1, 2]
    assert main(["plot-training", "--history", str(history), "--output",
                 str(tmp_path / "curves.png"), "--detailed"]) == 0
    assert (tmp_path / "curves.png").exists()
    assert (trained / "field_errors_detailed.png").exists()
    assert main(["plot-training", "--history",
                 str(tmp_path / "missing.json")]) == 1


def test_visualize(case, trained, tmp_path):
    """The plots, and error statistics equal to the JAX package's on the
    fields the port serves."""
    path, _ = case
    assert main(["visualize", "--checkpoint", str(trained), "--case_path",
                 str(path), "--reference_time", "200", "--output_dir",
                 str(tmp_path), "--device", "cpu"]) == 0
    assert (tmp_path / "U_comparison.png").exists()
    stats = json.loads((tmp_path / "error_stats.json").read_text())
    assert set(stats) == {"U", "p", "k", "epsilon", "nut"}
    pred = dict(np.load(_predictions(trained, path, tmp_path)))
    ref = FoamCase(path).load_fields("200")
    cc = FoamCase(path).load_mesh().cell_centers
    _, _, p2d = collapse_to_2d(cc, np.asarray(pred["p"]).reshape(-1))
    _, _, r2d = collapse_to_2d(cc, ref["p"])
    _, want = normalized_error(p2d, r2d)
    for k, v in want.items():
        assert stats["p"][k] == pytest.approx(v, rel=1e-6), k


def _predictions(ckpt, path, out):
    assert main(["infer", "--checkpoint", str(ckpt), "--case_path",
                 str(path), "--output_dir", str(out / "pred"),
                 "--device", "cpu"]) == 0
    return out / "pred" / "predictions.npz"


def test_plot_lines(case, trained, tmp_path):
    path, _ = case
    assert main(["plot-lines", "--checkpoint", str(trained), "--case_path",
                 str(path), "--reference_time", "200", "--output_dir",
                 str(tmp_path), "--x_line", "0.5", "--y_line", "0.5",
                 "--tol", "0.03", "--device", "cpu"]) == 0
    assert (tmp_path / "line_Y_0.500.png").exists()
    assert (tmp_path / "line_X_0.500.png").exists()


# ---- the legacy contour plot (tests/test_viz_legacy.py)
def _fake_mesh(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(0, 2, n), rng.uniform(0, 1, n),
                            np.zeros(n)])


def test_legacy_scalar_field_png(tmp_path):
    import matplotlib.pyplot as plt

    cc = _fake_mesh()
    out = tmp_path / "p_legacy.png"
    fig, ax = plot_field_2d_legacy(cc, np.sin(cc[:, 0]) * np.cos(cc[:, 1]),
                                   "p", "Pressure (legacy)", output_path=out)
    assert out.exists() and out.stat().st_size > 1000
    assert ax.get_title() == "Pressure (legacy)"
    plt.close(fig)


def test_legacy_vector_field_collapses_to_magnitude(tmp_path):
    import matplotlib.pyplot as plt

    cc = _fake_mesh()
    u = np.column_stack([np.ones(len(cc)), np.zeros(len(cc)),
                         np.zeros(len(cc))])
    out = tmp_path / "U_legacy.png"
    fig, _ = plot_field_2d_legacy(cc, u, "U", "Velocity (legacy)",
                                  output_path=out)
    assert out.exists()
    plt.close(fig)


def test_legacy_constant_pressure_degenerate_norm(tmp_path):
    """TwoSlopeNorm fails on a constant field; the plot falls back."""
    import matplotlib.pyplot as plt

    cc = _fake_mesh()
    fig, _ = plot_field_2d_legacy(cc, np.full(len(cc), 2.5), "p", "const",
                                  output_path=tmp_path / "c.png")
    plt.close(fig)


# ---- normalization and the loss (tests/test_normalization.py:57-136)
def _fake_fields(rng, n=100):
    return {"U": rng.normal(size=(n, 3)) * [10.0, 1.0, 0.1],
            "p": rng.normal(size=n) * 5 + 2, "k": rng.uniform(0, 1, n),
            "epsilon": rng.uniform(0, 10, n), "nut": rng.uniform(0, 1e-3, n)}


def test_packed_mean_std_matches_jax():
    fields = _fake_fields(np.random.default_rng(3))
    norm = FieldNormalizer().fit(fields)
    mean, std = norm.packed_mean_std()
    np.testing.assert_allclose((pack_targets(fields) - mean) / std,
                               pack_targets(norm.transform(fields)),
                               rtol=1e-10)
    jmean, jstd = jax_norm.FieldNormalizer().fit(fields).packed_mean_std()
    assert np.array_equal(mean, jmean) and np.array_equal(std, jstd)


def test_pack_unpack_and_json_round_trip(tmp_path):
    fields = _fake_fields(np.random.default_rng(4))
    packed = pack_targets(fields)
    assert packed.shape == (100, 7)
    rt = unpack_fields(packed)
    np.testing.assert_allclose(rt["U"], fields["U"])
    np.testing.assert_allclose(rt["p"][:, 0], fields["p"])
    t_rt = unpack_fields(torch.from_numpy(packed))
    assert torch.equal(t_rt["nut"], torch.from_numpy(packed[:, 6:7]))
    norm = FieldNormalizer().fit(fields)
    norm.save(tmp_path / "norm.json")
    again = FieldNormalizer.load(tmp_path / "norm.json")
    theirs = jax_norm.FieldNormalizer.load(tmp_path / "norm.json")
    for name, v in norm.transform(fields).items():
        np.testing.assert_allclose(again.transform(fields)[name], v,
                                   rtol=1e-12)
        np.testing.assert_allclose(theirs.transform(fields)[name], v,
                                   rtol=1e-12)


def _manual(pred, target, w=(1.0, 3.0, 0.5, 0.5, 0.5), pref=0.1):
    u = ((pred[:, :3] - target[:, :3]) ** 2).mean()
    p = ((pred[:, 3] - target[:, 3]) ** 2).mean()
    p = p + pref * (pred[:, 3].mean() - target[:, 3].mean()) ** 2
    rest = [((pred[:, i] - target[:, i]) ** 2).mean() for i in (4, 5, 6)]
    return w[0] * u + w[1] * p + sum(wi * r for wi, r in zip(w[2:], rest))


def _losses(fn, jfn, pred, target, mask, **kw):
    got = float(fn(torch.from_numpy(pred), torch.from_numpy(target),
                   torch.from_numpy(mask), **kw))
    want = float(jfn(jnp.asarray(pred), jnp.asarray(target),
                     jnp.asarray(mask), **kw))
    return got, want


@pytest.mark.parametrize("form", ["unpadded", "padded", "anchor",
                                  "elementwise"])
def test_weighted_losses_match_manual_and_jax(form):
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(50, 7)).astype(np.float32)
    target = rng.normal(size=(50, 7)).astype(np.float32)
    mask = np.ones(50, bool)
    if form == "unpadded":
        got, want = _losses(weighted_fieldwise_mse,
                            jax_norm.weighted_fieldwise_mse, pred, target,
                            mask)
        np.testing.assert_allclose(got, _manual(pred, target), rtol=1e-5)
    elif form == "padded":
        # masked padding rows, garbage in them, change nothing
        base, _ = _losses(weighted_fieldwise_mse,
                          jax_norm.weighted_fieldwise_mse, pred, target,
                          mask)
        pad = np.zeros((14, 7), np.float32)
        got, want = _losses(
            weighted_fieldwise_mse, jax_norm.weighted_fieldwise_mse,
            np.concatenate([pred, pad + 99]), np.concatenate([target, pad]),
            np.concatenate([mask, np.zeros(14, bool)]))
        np.testing.assert_allclose(got, base, rtol=1e-6)
    elif form == "anchor":
        pred, target = np.zeros((10, 7), np.float32), np.zeros((10, 7),
                                                               np.float32)
        pred[:, 3] = 1.0            # a constant pressure offset
        for pref, expect in ((0.0, 3.0), (0.1, 3.3)):
            got, want = _losses(weighted_fieldwise_mse,
                                jax_norm.weighted_fieldwise_mse, pred,
                                target, np.ones(10, bool),
                                pressure_ref_weight=pref)
            np.testing.assert_allclose(got, expect, rtol=1e-6)
    else:
        got, want = _losses(weighted_elementwise_mse,
                            jax_norm.weighted_elementwise_mse, pred, target,
                            mask)
        w = np.array([1, 1, 1, 3, 0.5, 0.5, 0.5])
        np.testing.assert_allclose(
            got, (((pred - target) ** 2) * w).mean(), rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("flat", [False, True], ids=["ranged", "flat"])
def test_mean_normalized_error_matches_jax(flat):
    rng = np.random.default_rng(6)
    ref = np.full(200, 3.0) if flat else rng.normal(size=200)
    pred = ref + 0.01 * rng.normal(size=200)
    assert mean_normalized_error(pred, ref) == \
        jax_metrics.mean_normalized_error(pred, ref)


# ---- boundary_cell_mask (tests/test_graph.py:100)
def test_boundary_cell_mask_matches_jax(case):
    path, _ = case
    mesh, jmesh = FoamCase(path).load_mesh(), JaxFoamCase(path).load_mesh()
    for patch in mesh.boundaries:
        got = boundary_cell_mask(mesh, patch)
        assert np.array_equal(got, jax_mask(jmesh, patch))
        assert got.sum() == mesh.boundaries[patch].n_faces
    xmin = boundary_cell_mask(mesh, "xmin")
    assert mesh.cell_centers[xmin][:, 0].max() < 1.0 / NX
    with pytest.raises(ValueError):
        boundary_cell_mask(mesh, "nope")


# ---- the mixed hex/prism case (tests/test_casegen_mixed.py)
@pytest.fixture(scope="module")
def mixed_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixed")
    golden = generate_mixed_prism_case(root / "port", 6, 5, 5)
    jax_mixed_case(root / "jax", 6, 5, 5)
    return root, golden


def test_mixed_case_matches_jax_and_golden_counts(mixed_case):
    root, golden = mixed_case
    for f in ("points", "faces", "owner", "neighbour", "boundary"):
        rel = Path("constant") / "polyMesh" / f
        assert (root / "port" / rel).read_bytes() == (
            root / "jax" / rel).read_bytes(), f
    for f in ("U", "p", "k", "epsilon", "nut"):
        assert (root / "port" / "100" / f).read_bytes() == (
            root / "jax" / "100" / f).read_bytes(), f
    text = (root / "port" / "constant" / "polyMesh" / "faces").read_text()
    assert "\n3(" in text and "\n4(" in text
    nx, ny, nz, n_even, n_odd = 6, 5, 5, 3, 2
    assert golden["n_cells"] == nx * ny * (n_even + 2 * n_odd)
    assert golden["n_internal_faces"] == (
        (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * n_odd
        + 2 * nx * ny * (nz - 1))
    case = FoamCase(root / "port")
    mesh = case.load_mesh()
    assert (mesh.n_cells, mesh.n_faces, mesh.n_internal_faces) == (
        golden["n_cells"], golden["n_faces"], golden["n_internal_faces"])
    np.testing.assert_allclose(mesh.cell_centers, golden["cell_centers"],
                               rtol=1e-7, atol=1e-9)
    f = case.load_fields("100", n_cells=golden["n_cells"], strict=True)
    for name, v in box_fields(golden["cell_centers"]).items():
        np.testing.assert_allclose(f[name], v, rtol=1e-5, atol=1e-8)
    deg = build_graph(mesh, reorder="none").in_degree.numpy()[: mesh.n_cells]
    assert deg.max() == 8 and (deg == 8).sum() == 4 * 3 and deg.min() >= 3


@pytest.fixture(scope="module")
def mixed_w5(tmp_path_factory):
    """16×16×7: degree-8 rows on a 5-tile band window."""
    path = tmp_path_factory.mktemp("mixed_w5") / "case"
    generate_mixed_prism_case(path, 16, 16, 7)
    assert load_graph(path, "GCN").band.gcn.shape[1] == 5
    return path, jax_build_graph(JaxFoamCase(path).load_mesh())


@pytest.mark.parametrize("layer_type", ["GCN", "GAT", "GIN", "Transformer"])
def test_mixed_case_band_and_conv_parity(mixed_w5, layer_type):
    """The port on pallas (the W 5 band; plain versions on the CPU) against
    the JAX model on segment with the same weights."""
    path, jgraph = mixed_w5
    graph = load_graph(path, layer_type)
    assert graph.band is not None and int(graph.in_degree.max()) == 8
    jcfg = JaxModelConfig(hidden_dim=16, num_layers=2, dropout=0.0,
                          norm_type="layer", layer_type=layer_type,
                          backend="segment")
    jmodel = JaxFlowGNN(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jgraph, train=False)
    want = np.asarray(jmodel.apply(variables, jgraph, train=False))
    cfg = ModelConfig.from_dict({**jcfg.to_dict(), "backend": "pallas"})
    model = FlowGNN(cfg)
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"]), {}, cfg))
    with torch.inference_mode():
        got = model.eval()(graph).numpy()
    n = jgraph.n_nodes
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-4,
                               atol=1e-4 * np.abs(want[:n]).max())


def test_new_modules_import_without_jax_or_plotting():
    """The slice's modules import no JAX, and matplotlib only inside the
    functions that draw (the card's machine has none; tqdm is left out of
    the check: torch itself imports it where it is installed)."""
    code = (
        "import sys\n"
        "import gnn_bfs_rans_tpu_torch.compat, gnn_bfs_rans_tpu_torch.viz\n"
        "import gnn_bfs_rans_tpu_torch.compat.torch_ref\n"
        "import gnn_bfs_rans_tpu_torch.train, gnn_bfs_rans_tpu_torch.graph\n"
        "import gnn_bfs_rans_tpu_torch.foam, gnn_bfs_rans_tpu_torch.cli.main\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gnn_bfs_rans_tpu', 'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
