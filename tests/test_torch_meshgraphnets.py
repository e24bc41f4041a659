"""MeshGraphNets in the port (``models/meshgraphnets.py``,
``kernels/mgn.py``) on the CPU, against the benchmark's plain reference
(``perfbench/reference/archs/meshgraphnets.py``, the repository's one
reference of the architecture), through the ``Trainer``, the
``Predictor`` and the CLI; and the paths that take FlowGNN only.  No
JAX.  The kernels' own tests are in ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from gnn_bfs_rans_tpu_torch.foam import generate_box_case
from gnn_bfs_rans_tpu_torch.kernels.mgn import (mgn_edge, mgn_edge_plain,
                                                mgn_node, mgn_node_plain)
from gnn_bfs_rans_tpu_torch.models import (FlowGNNSurrogate, MeshGraphNet,
                                           ModelConfig, build_model)
from perfbench.core import program
from perfbench.reference import graph as ref_graph
from perfbench.reference.model import Forward, loss
from perfbench.yardstick import meshes, weights


def _cfg(hidden: int, steps: int, **kw) -> dict:
    base = dict(layer_type="MeshGraphNets", num_layers=steps,
                hidden_dim=hidden, dropout=0.0, input_dim=3, output_dim=7,
                use_batch_norm=False, backend="segment",
                compute_dtype="float32")
    return {**base, **kw}


def _mcfg(**kw) -> ModelConfig:
    return program.model_config(_cfg(16, 2, **kw))


@pytest.fixture(scope="module")
def box():
    """A 20 × 10 box: 200 cells, the program's graph (RCM rows) and the
    reference's (the same rows)."""
    mesh = meshes.box_mesh(20, 10, 1)
    g = program.program_graph(mesh, "MeshGraphNets")
    rg = ref_graph.build(mesh)
    assert (rg.order == program.rows(g)).all()
    return g, rg


@pytest.mark.parametrize("hidden,steps", [(16, 3), (128, 2)])
def test_model_matches_the_reference_forward_and_gradients(box, hidden,
                                                           steps):
    """The port on ``segment`` and the reference's ``Forward`` in f32 on
    seeded random weights: the prediction, and every leaf's gradient of
    the field-weighted loss."""
    g, rg = box
    cfg = _cfg(hidden, steps)
    w = weights.make_weights(cfg, 11, "cpu")
    model = MeshGraphNet(program.model_config(cfg))
    model.load_state_dict(w, strict=True)
    target = torch.rand((rg.n, 7), generator=torch.Generator().manual_seed(2))
    out = model(g, train=True)[:rg.n]
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref = Forward(cfg, rg)(p, {}, rg.coords, "train")
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(loss(out, target), list(model.parameters()))
    names = [k for k, _ in model.named_parameters()]
    want = torch.autograd.grad(loss(ref, target), [p[k] for k in names])
    for k, a, b in zip(names, grads, want):
        scale = float(b.abs().max()) + 1e-12
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6 * scale,
                                   msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_on_the_cpu_is_the_plain_path(box, dtype):
    """On the CPU ``pallas`` runs the kernels' plain versions, which are
    ``segment``'s blocks: the same bits, forward and gradients."""
    g, _ = box
    seg = MeshGraphNet(_mcfg(compute_dtype=dtype),
                       torch.Generator().manual_seed(5))
    pal = MeshGraphNet(_mcfg(backend="pallas", compute_dtype=dtype))
    pal.load_state_dict(seg.state_dict())
    outs = [m(g, train=True) for m in (seg, pal)]
    assert torch.equal(outs[0], outs[1])
    grads = [torch.autograd.grad(o.square().sum(), list(m.parameters()))
             for o, m in zip(outs, (seg, pal))]
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # the blocks themselves, as the card's wrappers take them on the CPU
    step = seg.processor[0]
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    gen = torch.Generator().manual_seed(4)
    ne = g.n_edges
    v, e, agg = (torch.randn((rows, 16), generator=gen).to(dt)
                 for rows in (g.n_pad, ne, g.n_pad))
    s, r = g.senders[:ne], g.receivers[:ne]
    for a, b in zip((*mgn_edge(v, e, s, r, *step.edge_params()),
                     mgn_node(v, agg, *step.node_params())),
                    (*mgn_edge_plain(v, e, s, r, *step.edge_params()),
                     mgn_node_plain(v, agg, *step.node_params()))):
        assert a.dtype == dt and torch.equal(a, b)


def test_spans_and_counters(box):
    from gnn_bfs_rans_tpu_torch.utils import trace

    g, _ = box
    model = MeshGraphNet(_mcfg(backend="pallas"))
    trace.reset()
    model(g, train=True).sum().backward()
    with torch.no_grad():
        model(g)
    spans = trace.records()
    fwd = [s for s in spans if s.name == "mgn.forward"]
    assert [s.attrs["train"] for s in fwd] == [True, False]
    kids = {s.name for s in spans if s.parent == fwd[0].id}
    assert kids == {"mgn.encode", "mgn.process", "mgn.decode"}
    assert fwd[0].counters["mgn.edge_rows"] == 2 * g.n_edges
    assert fwd[1].counters["mgn.edge_rows"] == 2 * g.n_edges
    # the training forward keeps at least each step's edge MLP's three
    # f32 activations; an eval forward keeps nothing
    assert fwd[0].counters["mgn.saved_bytes"] >= 2 * 3 * g.n_edges * 16 * 4
    assert "mgn.saved_bytes" not in fwd[1].counters


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("mgn") / "case"
    generate_box_case(path, 12, 6, 1, time_dirs=("100", "200"))
    return path


def test_trainer_blocked_loop_trains_and_serves(case, tmp_path):
    """The ``Trainer``'s blocked loop trains MeshGraphNets (built by the
    model factory); its last checkpoint serves through ``Predictor`` with
    the trained model's own output."""
    from gnn_bfs_rans_tpu_torch.infer import Predictor, load_graph
    from gnn_bfs_rans_tpu_torch.train.data import load_dataset
    from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig
    from gnn_bfs_rans_tpu_torch.train.trainer import Trainer

    ds = load_dataset(case, ["100", "200"])
    assert ds.graph.band is None
    tr = Trainer(ds, _mcfg(backend="pallas"),
                 TrainConfig(lr=3e-3, epochs=6, epoch_block=3, save_every=3,
                             batch_size=1),
                 output_dir=tmp_path, log_fn=lambda *a, **k: None,
                 device="cpu")
    assert isinstance(tr.model, MeshGraphNet)
    tr.initialize()
    tr.train()
    losses = tr.history["train_loss"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    pred = Predictor.from_checkpoint(tmp_path, "epoch_6", device="cpu")
    assert isinstance(pred.model, MeshGraphNet)
    graph = load_graph(case, "MeshGraphNets")
    assert graph.band is None
    tr.model.eval()
    with torch.no_grad():
        want = tr.model(graph).numpy()[:graph.n_nodes]
    got = pred.predict_packed(graph)
    perm = graph.perm.numpy()[:graph.n_nodes]
    np.testing.assert_array_equal(got[perm], want)


def test_cli_trains_and_infers(case, tmp_path):
    """``train --layer_type MeshGraphNets`` turns BatchNorm off whatever
    ``--norm_type`` says; ``infer`` builds the model from the meta file."""
    from gnn_bfs_rans_tpu_torch.cli.main import main

    out = tmp_path / "ckpt"
    assert main(["train", "--case_path", str(case), "--time_dirs", "100",
                 "200", "--output_dir", str(out), "--layer_type",
                 "MeshGraphNets", "--num_layers", "2", "--hidden_dim", "16",
                 "--dropout", "0", "--epochs", "2", "--device", "cpu",
                 "--norm_type", "batch"]) == 0
    cfg = json.loads((out / "best.meta.json").read_text())["model_config"]
    assert cfg["layer_type"] == "MeshGraphNets"
    assert cfg["use_batch_norm"] is False
    assert main(["infer", "--checkpoint", str(out), "--case_path",
                 str(case), "--output_dir", str(tmp_path / "pred"),
                 "--device", "cpu", "--save_format", "numpy"]) == 0
    pred = np.load(tmp_path / "pred" / "predictions.npz")
    assert pred["U"].shape == (72, 3) and np.isfinite(pred["U"]).all()


def _partitioned(cfg, tmp_path):
    from gnn_bfs_rans_tpu_torch.models.partitioned import PartitionedFlowGNN
    return PartitionedFlowGNN(cfg)


def _multitopo(cfg, tmp_path):
    from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig
    from gnn_bfs_rans_tpu_torch.train.multitopo import MultiTopoTrainer
    return MultiTopoTrainer(None, cfg, TrainConfig(), output_dir=tmp_path,
                            device="cpu")


def _export(cfg, tmp_path):
    from gnn_bfs_rans_tpu_torch.compat.torch_port import save_torch_checkpoint
    model = build_model(cfg)
    return save_torch_checkpoint(tmp_path / "m.pt", model.state_dict(), cfg)


@pytest.mark.parametrize("path,change", [
    (_partitioned, {}),
    (_multitopo, {}),
    (lambda cfg, _: FlowGNNSurrogate(cfg), {}),
    (_export, {}),
    (lambda cfg, _: build_model(cfg), {"remat": True}),
    (lambda cfg, _: build_model(cfg), {"use_batch_norm": True}),
    (lambda cfg, _: build_model(cfg), {"dropout": 0.1}),
    (lambda cfg, _: build_model(cfg), {"compute_dtype": "mixed"}),
], ids=["partitioned", "multitopo", "surrogate", "export-torch", "remat",
        "batch_norm", "dropout", "mixed"])
def test_out_of_scope_paths_raise(path, change, tmp_path):
    cfg = dataclasses.replace(_mcfg(), **change)
    with pytest.raises(ValueError, match="MeshGraphNets"):
        path(cfg, tmp_path)


def _strip_sums(vals: np.ndarray, recv: np.ndarray, n_nodes: int,
                strip: int = 16) -> np.ndarray:
    """``csrc/mgn_edge.cu``'s receiver sums written out: each strip's
    ``warp_run_sums`` (runs inside the strip to ``out``, cut runs to the
    strip's slot 0 or 1), then ``mgn_edge_fixup_kernel``."""
    n = len(recv)
    n_strips = -(-n // strip)
    out = np.zeros((n_nodes, vals.shape[1]), np.float32)
    part = np.full((n_strips, 2, vals.shape[1]), np.nan, np.float32)
    for t in range(n_strips):
        row0, n_rows = t * strip, min(strip, n - t * strip)
        prev_r = recv[row0 - 1] if row0 > 0 else -1
        next_r = recv[row0 + n_rows] if row0 + n_rows < n else -1
        cur, open_start = recv[row0], recv[row0] == prev_r
        acc = np.zeros(vals.shape[1], np.float32)
        for i in range(n_rows):
            r = recv[row0 + i]
            if r != cur:
                if open_start:
                    part[t, 0] = acc
                else:
                    out[cur] = acc
                acc, cur, open_start = np.zeros_like(acc), r, False
            acc = acc + vals[row0 + i]
        if next_r == cur:
            part[t, 0 if open_start else 1] = acc
        elif open_start:
            part[t, 0] = acc
        else:
            out[cur] = acc
    for t in range(n_strips):
        first, last = t * strip, min(t * strip + strip, n) - 1
        r = recv[last]
        if last + 1 >= n or recv[last + 1] != r:
            continue
        if recv[first] == r and first > 0 and recv[first - 1] == r:
            continue
        acc = part[t, 1]
        for u in range(t + 1, n_strips):
            acc = acc + part[u, 0]
            u_last = min((u + 1) * strip, n) - 1
            if not (u_last + 1 < n and recv[u_last + 1] == r):
                break
        out[r] = acc
    return out


@pytest.mark.parametrize("degrees", [
    [4, 3, 5, 4, 2, 4, 4, 6, 3, 4, 4, 1],      # a mesh's short runs
    [16, 16, 1, 40, 2, 15, 17, 33, 5],         # runs of a strip and more
    [70],                                      # one run over 5 strips
])
def test_strip_partials_and_fixup_give_the_receiver_sums(degrees):
    """The kernels' receiver sums over 16-edge strips (no atomics) equal
    the sum over each receiver's run, for runs inside a strip, cut by one
    boundary, or covering whole strips; receivers without edges stay 0."""
    rng = np.random.default_rng(len(degrees))
    nodes = rng.permutation(3 * len(degrees))[:len(degrees)]
    recv = np.repeat(np.sort(nodes), degrees)
    vals = rng.standard_normal((len(recv), 4)).astype(np.float32)
    want = np.zeros((3 * len(degrees), 4))
    np.add.at(want, recv, vals.astype(np.float64))
    got = _strip_sums(vals, recv, 3 * len(degrees))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
