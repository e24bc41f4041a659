"""The port's scale-out (``gnn_bfs_rans_tpu_torch/parallel/``,
``models/partitioned.py``) against the JAX package on the CPU.

The JAX side runs on the conftest's virtual CPU devices; the port side on
gloo ranks spawned by the port's launcher (``parallel/distributed.py``:
one thread a rank, a file store under ``tmp_path``, results returned by
rank), two groups in all: 2 ranks and 4 ranks, each running every job of
``parallel/ranks.py`` it is given.  Small sizes: a 16 × 32 grid (512 cells,
4 shards of 128 rows, halo 128), hidden 16–32, 2 layers; JAX's
interpret-mode Pallas only for the banded GAT at 2 shards.

* ``build_partition`` / ``_slice_band`` equal JAX's array for array (2 and
  4 shards, tile-aligned and misaligned), and raise as JAX does;
* ``halo_exchange`` forward and backward at 2 and 4 ranks against a numpy
  model and ``jax.lax.ppermute`` under ``shard_map`` (and its VJP);
* the partitioned forward at 2 and 4 ranks (GCN and GAT dense, GAT pallas
  with the band at 2) against JAX ``make_partitioned_forward`` on the same
  weights and against the port's single-rank ``FlowGNN`` forward;
* the partitioned train step (GCN, BatchNorm, pressure anchor on) against
  JAX ``make_partitioned_train_step`` and the single-rank step: loss,
  gradients (through the halo exchange and the BatchNorm sums) and every
  parameter after the step;
* the DP step at S = 3 on 2 ranks (uneven weights) against JAX
  ``make_dp_train_step`` and the port's ``train_step``;
* the multi-case step, 2 ranks × 2 cases, against JAX
  ``make_multicase_train_step`` (loss, parameters, averaged running
  statistics) and ``gather_case_predictions`` (case order, ``perm``);
  ``make_perturbed_cases`` equal to JAX's.

The DP and multi-case steps run with a clip that never fires
(``NO_CLIP``), so the gradients they applied are the all-reduced sums
themselves; these are held against the full-batch gradients (the port's
``train_step`` for DP, ``jax.grad`` for the multi-case step).  A first Adam step and a
global-norm clip both hide a uniform scale of the gradients, so without
this a mean in place of the SUM all-reduce would pass.

Tolerances (``PERF.md`` §2): f32, 1e-5 of the largest output (forward) and
1e-4 (gradients, parameters after one step).  Adam's first step moves an
entry by lr·g/|g|: where the gradient is zero in exact arithmetic (the
conv bias before a BatchNorm) both sides toss a coin of ±lr, so updated
parameters are compared where |g| > 1e-6 of the largest gradient, and
every entry moves by at most lr.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gnn_bfs_rans_tpu.foam import FoamCase as JaxFoamCase
from gnn_bfs_rans_tpu.models.flow_gnn import FlowGNN as JaxFlowGNN
from gnn_bfs_rans_tpu.models.flow_gnn import ModelConfig as JaxModelConfig
from gnn_bfs_rans_tpu.parallel import data_parallel as jdp
from gnn_bfs_rans_tpu.parallel import multicase as jmc
from gnn_bfs_rans_tpu.parallel import partition as jpart
from gnn_bfs_rans_tpu.train.loop import TrainConfig as JaxTrainConfig
from gnn_bfs_rans_tpu.train.loop import TrainState, make_optimizer
from gnn_bfs_rans_tpu.utils.synthetic import (
    build_grid_graph as jax_build_grid_graph,
)
from gnn_bfs_rans_tpu_torch.compat.from_jax import (
    flax_tree_from_state_dict,
    state_dict_from_flax,
)
from gnn_bfs_rans_tpu_torch.foam import FoamCase, generate_box_case
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
from gnn_bfs_rans_tpu_torch.models.flow_gnn import FlowGNN, ModelConfig
from gnn_bfs_rans_tpu_torch.parallel import (
    build_partition,
    make_perturbed_cases,
)
from gnn_bfs_rans_tpu_torch.parallel.distributed import launch
from gnn_bfs_rans_tpu_torch.parallel.ranks import run_jobs
from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig, train_step
from gnn_bfs_rans_tpu_torch.train.loop import make_optimizer as port_optimizer
from gnn_bfs_rans_tpu_torch.utils.synthetic import build_grid_graph

NX, NY = 16, 32          # 512 cells: 4 shards of one 128-row tile
HALO = 128
LR = 1e-3
FWD_TOL, STEP_TOL = 1e-5, 1e-4
NO_CLIP = 1e9            # a global-norm clip that never fires
# the forwards each world runs: (label, config); the banded GAT (JAX in
# interpret mode) at 2 ranks only
FORWARDS = {
    "gcn-dense": dict(layer_type="GCN", backend="dense"),
    "gat-dense": dict(layer_type="GAT", backend="dense", heads=2),
    "gat-pallas": dict(layer_type="GAT", backend="pallas", heads=2),
}
WORLD_FORWARDS = {2: ("gcn-dense", "gat-dense", "gat-pallas"),
                  4: ("gcn-dense", "gat-dense")}
STEP_CFG = dict(layer_type="GCN", backend="dense", hidden_dim=16,
                num_layers=2, dropout=0.0)




@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes run fastest on one thread, and leave the cores to the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_grid(layer_type):
    return jax_build_grid_graph(NX, NY, with_band=True,
                                band_components=LAYER_COMPONENTS[layer_type])


def _port_grid(layer_type):
    return build_grid_graph(NX, NY, with_band=True,
                            band_components=LAYER_COMPONENTS[layer_type])


def _variables(jcfg, seed=0):
    """Seeded weights with non-trivial BatchNorm parameters and statistics,
    as flax numpy trees (made by the port: no flax init)."""
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    model = FlowGNN(cfg, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in model.norms:
            h = bn.weight.shape[0]
            bn.weight.copy_(1 + 0.1 * torch.randn(h, generator=gen))
            bn.bias.copy_(0.1 * torch.randn(h, generator=gen))
            bn.running_mean.copy_(0.5 * torch.randn(h, generator=gen))
            bn.running_var.uniform_(0.5, 2.0, generator=gen)
    return flax_tree_from_state_dict(model.state_dict(), cfg)


def _state_np(params, stats, cfg):
    return {k: v.numpy() for k, v in
            state_dict_from_flax(params, stats, cfg).items()}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_state(params, stats, jtcfg):
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=stats,
                      opt_state=make_optimizer(jtcfg).init(params))


def _port_tree(state_np, cfg):
    return flax_tree_from_state_dict(
        {k: torch.from_numpy(v) for k, v in state_np.items()}, cfg)


def _assert_step(got_state, got_grads, want_params, start, cfg, what):
    """Parameters after one step: within STEP_TOL of the largest entry
    where the gradient is firm, and every entry moved by at most lr."""
    got, _ = _port_tree(got_state, cfg)
    grads, _ = _port_tree({**got_state, **got_grads}, cfg)
    got, grads, start = _leaves(got), _leaves(grads), _leaves(start)
    g_max = max(np.abs(v).max() for v in grads.values())
    for k, w in _leaves(want_params).items():
        firm = np.abs(grads[k]) > 1e-6 * g_max
        err = np.abs(got[k] - w)[firm].max(initial=0.0)
        assert err <= STEP_TOL * np.abs(w).max(), f"{what} {k}: {err}"
        assert np.abs(got[k] - start[k]).max() <= 1.01 * LR, f"{what} {k}"


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    path = tmp_path_factory.mktemp("scaleout") / "box"
    generate_box_case(path, 24, 16, 1)
    return FoamCase(path).load_mesh(), JaxFoamCase(path).load_mesh()


@pytest.fixture(scope="module")
def setups(box):
    """The inputs and JAX results of every job, by name."""
    out = {}
    rng = np.random.default_rng(0)
    for label, kw in FORWARDS.items():
        jcfg = JaxModelConfig(hidden_dim=32, num_layers=2, dropout=0.0,
                              use_edge_attr=False, **kw)
        params, stats = _variables(jcfg)
        out[label] = dict(jcfg=jcfg, params=params, stats=stats)
    # the partitioned and DP steps share a GCN with BatchNorm
    jcfg = JaxModelConfig(use_edge_attr=False, **STEP_CFG)
    params, stats = _variables(jcfg, seed=1)
    out["step"] = dict(jcfg=jcfg, params=params, stats=stats,
                       targets=rng.normal(size=(2, NX * NY, 7)).astype(
                           np.float32),
                       dp_targets=rng.normal(size=(3, NX * NY, 7)).astype(
                           np.float32))
    # the multi-case step: 4 perturbed box cases
    mesh_t, mesh_j = box
    tg = (0.1 * rng.normal(size=(4, 384, 7))).astype(np.float32)
    base, batch = make_perturbed_cases(mesh_t, 4, amplitude=0.05, seed=2,
                                       targets=tg)
    jbase, jbatch = jmc.make_perturbed_cases(mesh_j, 4, amplitude=0.05,
                                             seed=2, targets=tg)
    params, stats = _variables(jcfg, seed=2)
    out["multicase"] = dict(jcfg=jcfg, params=params, stats=stats,
                            base=base, batch=batch, jbase=jbase,
                            jbatch=jbatch)
    return out


def _payloads(setups, world, halo_x, halo_g):
    jobs = [("halo", dict(x=halo_x, g=halo_g, halo=4))]
    for label in WORLD_FORWARDS[world]:
        s = setups[label]
        cfg = ModelConfig.from_dict(s["jcfg"].to_dict())
        jobs.append(("partitioned_forward", dict(
            config=cfg.to_dict(), state=_state_np(s["params"], s["stats"],
                                                  cfg),
            graph=_port_grid(cfg.layer_type), halo=HALO)))
    s = setups["step"]
    cfg = ModelConfig.from_dict(s["jcfg"].to_dict())
    common = dict(config=cfg.to_dict(),
                  state=_state_np(s["params"], s["stats"], cfg),
                  train=TrainConfig().to_dict(), lr=LR)
    jobs.append(("partitioned_step", dict(common, graph=_port_grid("GCN"),
                                          targets=s["targets"], halo=HALO)))
    if world == 2:
        # no clip: the gradients after the step are the reduced sums
        common = dict(common, train=TrainConfig(grad_clip=NO_CLIP).to_dict())
        jobs.append(("dp_step", dict(common, graph=_port_grid("GCN"),
                                     targets=s["dp_targets"])))
        m = setups["multicase"]
        jobs.append(("multicase_step", dict(
            common, state=_state_np(m["params"], m["stats"], cfg),
            graph=m["base"], batch=m["batch"])))
    return jobs


@pytest.fixture(scope="module")
def ranks(setups, tmp_path_factory):
    """{world: (jobs, per-rank results)} from one spawned group each, the
    two groups at once."""
    rng = np.random.default_rng(5)
    jobs = {}
    for world in (2, 4):
        x = rng.normal(size=(world, 14, 3)).astype(np.float32)
        g = rng.normal(size=(world, 14, 3)).astype(np.float32)
        jobs[world] = _payloads(setups, world, x, g)

    def run(world):
        store = tmp_path_factory.mktemp(f"store{world}") / "store"
        return launch(run_jobs, world, (jobs[world], "cpu"), device="cpu",
                      init_method=f"file://{store}")

    with ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(run, w) for w in jobs}
        return {w: (jobs[w], f.result()) for w, f in futures.items()}


def _job(ranks, world, name, rank=0, nth=0):
    jobs, res = ranks[world]
    idx = [i for i, (n, _) in enumerate(jobs) if n == name][nth]
    return jobs[idx][1], res[rank][idx]


# --------------------------------------------------------------- partition
@pytest.mark.parametrize("n_dev,halo", [(2, 128), (4, 128), (2, 64),
                                        (4, 32)])
def test_build_partition_matches_jax(n_dev, halo):
    """Every array, band slices included (aligned: 128; misaligned: no
    band, the shards take the dense branches on both sides)."""
    layer = "Transformer"                       # bias_noself, geo, pos
    got = build_partition(_port_grid(layer), n_dev, halo)
    want = jpart.build_partition(_jax_grid(layer), n_dev, halo)
    assert got.has_band == want.has_band == (halo == 128)
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        g = getattr(got, f.name)
        if w is None or isinstance(w, int):
            assert g == w, f.name
            continue
        np.testing.assert_array_equal(
            g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy(),
            np.asarray(w, np.float32) if np.asarray(w).dtype.name ==
            "bfloat16" else np.asarray(w), err_msg=f.name)


def test_build_partition_band_planes_for_every_conv():
    for layer in ("GCN", "GIN", "GAT"):
        got = build_partition(_port_grid(layer), 4, HALO)
        want = jpart.build_partition(_jax_grid(layer), 4, HALO)
        for name in ("adj", "gcn", "bias_self"):
            w = getattr(want, f"band_{name}")
            g = getattr(got, f"band_{name}")
            assert (w is None) == (g is None), name
            if w is not None:
                np.testing.assert_array_equal(
                    g.float().numpy(), np.asarray(w, np.float32))


def test_build_partition_errors():
    g = _port_grid("GCN")
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        build_partition(g, 3)
    with pytest.raises(ValueError, match="smaller than halo 256"):
        build_partition(g, 4, halo=256)
    # a wide ordering: edges span more than the halo
    wide = build_grid_graph(512, 2, with_band=False)
    with pytest.raises(ValueError, match="edge exceeds halo 128"):
        build_partition(wide, 4)


# ------------------------------------------------------------ halo exchange
def _halo_numpy(x, g, h):
    """ppermute's semantics and their transpose, in numpy."""
    world, n_ext = x.shape[:2]
    n_loc = n_ext - 2 * h
    y = x.copy()
    dx = g.copy()
    y[:, :h] = 0
    y[:, h + n_loc:] = 0
    dx[:, :h] = 0
    dx[:, h + n_loc:] = 0
    for d in range(world):
        if d > 0:
            y[d, :h] = x[d - 1, n_loc:n_loc + h]
            dx[d - 1, n_loc:n_loc + h] += g[d, :h]
        if d + 1 < world:
            y[d, h + n_loc:] = x[d + 1, h:2 * h]
            dx[d + 1, h:2 * h] += g[d, h + n_loc:]
    return y, dx


def _halo_jax(x, g, h):
    from gnn_bfs_rans_tpu.models.partitioned import halo_exchange

    mesh = jdp.make_data_mesh(x.shape[0])

    def f(a):
        return jax.shard_map(
            lambda s: halo_exchange(s[0], h, "data")[None], mesh=mesh,
            in_specs=P("data"), out_specs=P("data"))(a)

    y, vjp = jax.vjp(f, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("world", [2, 4])
def test_halo_exchange(ranks, world):
    p, _ = _job(ranks, world, "halo")
    got_y = np.stack([_job(ranks, world, "halo", r)[1]["y"]
                      for r in range(world)])
    got_dx = np.stack([_job(ranks, world, "halo", r)[1]["dx"]
                       for r in range(world)])
    want_y, want_dx = _halo_numpy(p["x"], p["g"], p["halo"])
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(got_dx, want_dx, rtol=1e-6, atol=1e-6)
    jy, jdx = _halo_jax(p["x"], p["g"], p["halo"])
    np.testing.assert_array_equal(got_y, jy)
    np.testing.assert_allclose(got_dx, jdx, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------- partitioned forward
@pytest.mark.parametrize("world,label", [(w, lb) for w in (2, 4)
                                         for lb in WORLD_FORWARDS[w]])
def test_partitioned_forward(setups, ranks, world, label):
    s = setups[label]
    nth = WORLD_FORWARDS[world].index(label)
    p, res = _job(ranks, world, "partitioned_forward", nth=nth)
    assert res["has_band"]
    # every rank gathers the same rows
    for r in range(1, world):
        np.testing.assert_array_equal(
            _job(ranks, world, "partitioned_forward", r, nth)[1]["out"],
            res["out"])
    got = res["out"]
    # JAX make_partitioned_forward on the same weights
    jgraph = _jax_grid(s["jcfg"].layer_type)
    mesh = jdp.make_data_mesh(world)
    pg = jpart.shard_partition(jpart.build_partition(jgraph, world, HALO),
                               mesh)
    fwd = jpart.make_partitioned_forward(s["jcfg"], mesh, halo=HALO)
    want = jpart.gather_partitioned(fwd(s["params"], s["stats"], pg), pg)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= FWD_TOL * scale
    # the port's single-rank FlowGNN forward, owned rows
    cfg = ModelConfig.from_dict(p["config"])
    model = FlowGNN(cfg)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in p["state"].items()})
    model.eval()
    with torch.no_grad():
        full = model(p["graph"]).numpy()[:p["graph"].n_nodes]
    assert np.abs(got - full).max() <= FWD_TOL * scale


# ------------------------------------------------ partitioned train step
@pytest.fixture(scope="module")
def single_step(setups):
    """The port's single-rank unfused step on the same weights: loss,
    state, gradients."""
    s = setups["step"]
    cfg = ModelConfig.from_dict(s["jcfg"].to_dict())
    model = FlowGNN(cfg)
    model.load_state_dict(state_dict_from_flax(s["params"], s["stats"], cfg))
    loss = train_step(model, port_optimizer(model, TrainConfig()),
                      _port_grid("GCN"), torch.from_numpy(s["targets"]), LR,
                      TrainConfig())
    return (float(loss),
            {k: v.numpy().copy() for k, v in model.state_dict().items()},
            {k: p.grad.numpy().copy() for k, p in model.named_parameters()})


@pytest.mark.parametrize("world", [2, 4])
def test_partitioned_step_matches_jax(setups, ranks, world):
    s = setups["step"]
    jtcfg = JaxTrainConfig()
    jgraph = _jax_grid("GCN")
    mesh = jdp.make_data_mesh(world)
    pg = jpart.shard_partition(jpart.build_partition(jgraph, world, HALO),
                               mesh)
    tgt = jpart.shard_partitioned_targets(s["targets"], pg, mesh)
    state = jdp.replicate(_jax_state(s["params"], s["stats"], jtcfg), mesh)
    step = jpart.make_partitioned_train_step(s["jcfg"], jtcfg, mesh,
                                             halo=HALO)
    new, loss = step(state, pg, tgt, jnp.float32(LR),
                     jax.random.PRNGKey(0))
    _, res = _job(ranks, world, "partitioned_step")
    assert res["loss"] == pytest.approx(float(loss), rel=FWD_TOL)
    cfg = ModelConfig.from_dict(s["jcfg"].to_dict())
    _assert_step(res["state"], res["grads"], new.params, s["params"], cfg,
                 f"partitioned {world}")
    _, stats = _port_tree(res["state"], cfg)
    for k, w in _leaves(new.batch_stats).items():
        np.testing.assert_allclose(_leaves(stats)[k], w, rtol=STEP_TOL,
                                   atol=STEP_TOL * np.abs(w).max())


@pytest.mark.parametrize("world", [2, 4])
def test_partitioned_step_matches_single_rank(single_step, ranks, world):
    """Gradients through halo_exchange and the BatchNorm sums equal the
    single-rank step's; so do the loss and the running statistics."""
    loss, state, grads = single_step
    _, res = _job(ranks, world, "partitioned_step")
    assert res["loss"] == pytest.approx(loss, rel=FWD_TOL)
    g_max = max(np.abs(g).max() for g in grads.values())
    for k, g in grads.items():
        if k.endswith("bias") and k.startswith("convs."):
            # zero in exact arithmetic (the BatchNorm removes it): noise
            assert np.abs(res["grads"][k]).max() <= 1e-6 * g_max, k
            continue
        err = np.abs(res["grads"][k] - g).max()
        assert err <= STEP_TOL * max(np.abs(g).max(), 1e-3 * g_max), k
    for k in ("norms.0.running_mean", "norms.1.running_var"):
        np.testing.assert_allclose(res["state"][k], state[k], rtol=STEP_TOL,
                                   atol=1e-6)


def _assert_grads(got, want, what):
    """Gradients by state-dict name: within STEP_TOL of each tensor's
    largest entry (floored at 1e-3 of the largest gradient); the conv
    biases before a BatchNorm, zero in exact arithmetic, stay noise."""
    g_max = max(np.abs(g).max() for g in want.values())
    for k, g in want.items():
        if k.endswith("bias") and k.startswith("convs."):
            assert np.abs(got[k]).max() <= 1e-6 * g_max, f"{what} {k}"
            continue
        err = np.abs(got[k] - g).max()
        assert err <= STEP_TOL * max(np.abs(g).max(), 1e-3 * g_max), \
            f"{what} {k}: {err}"


def _jax_grads(jcfg, params, stats, cases, n_div):
    """JAX gradients of ``Σ loss_c / n_div`` over ``cases`` of
    ``(graph, targets)``, each a train-mode forward (dropout 0), as
    port-named numpy arrays."""
    from gnn_bfs_rans_tpu.train.normalization import weighted_fieldwise_mse

    model = JaxFlowGNN(jcfg)

    def loss_fn(p):
        total = 0.0
        for g, t in cases:
            out, _ = model.apply({"params": p, "batch_stats": stats}, g,
                                 train=True,
                                 rngs={"dropout": jax.random.PRNGKey(0)},
                                 mutable=["batch_stats"])
            total = total + weighted_fieldwise_mse(
                out, t, g.node_mask,
                pressure_ref_weight=JaxTrainConfig().pressure_ref_weight)
        return total / n_div

    grads = jax.jit(jax.grad(loss_fn))(params)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    return {k: v.numpy() for k, v in
            state_dict_from_flax(grads, stats, cfg).items()
            if k in dict(FlowGNN(cfg).named_parameters())}


# ------------------------------------------------------------- DP step
def test_dp_step_uneven_snapshots(setups, ranks, single_step):
    """S = 3 on 2 ranks: the padded copy's weights keep the mean exact, and
    the SUM all-reduce gives the full-batch gradient (no divide by the
    world size)."""
    s = setups["step"]
    jtcfg = JaxTrainConfig(grad_clip=NO_CLIP)
    jgraph = _jax_grid("GCN")
    mesh = jdp.make_data_mesh(2)
    tgt, wts = jdp.shard_targets(s["dp_targets"], mesh)
    state = jdp.replicate(_jax_state(s["params"], s["stats"], jtcfg), mesh)
    step = jdp.make_dp_train_step(JaxFlowGNN(s["jcfg"]), jtcfg, mesh)
    new, loss = step(state, jgraph, tgt, wts, jnp.float32(LR),
                     jax.random.PRNGKey(0))
    _, res = _job(ranks, 2, "dp_step")
    _, res1 = _job(ranks, 2, "dp_step", rank=1)
    assert res["loss"] == res1["loss"]
    assert res["loss"] == pytest.approx(float(loss), rel=FWD_TOL)
    cfg = ModelConfig.from_dict(s["jcfg"].to_dict())
    _assert_step(res["state"], res["grads"], new.params, s["params"], cfg,
                 "dp")
    # the port's train_step on all three snapshots (held against JAX's in
    # test_torch_train_gcn_gin.py): loss and the reduced gradients
    model = FlowGNN(cfg)
    model.load_state_dict(state_dict_from_flax(s["params"], s["stats"], cfg))
    tcfg = TrainConfig(grad_clip=NO_CLIP)
    want = train_step(model, port_optimizer(model, tcfg),
                      _port_grid("GCN"), torch.from_numpy(s["dp_targets"]),
                      LR, tcfg)
    assert res["loss"] == pytest.approx(float(want), rel=FWD_TOL)
    _assert_grads(res["grads"], {k: p.grad.numpy() for k, p in
                                 model.named_parameters()},
                  "dp vs train_step")
    g_max = max(p.grad.abs().max().item() for p in model.parameters())
    for k, p in model.named_parameters():
        firm = np.abs(p.grad.numpy()) > 1e-6 * g_max
        err = np.abs(res["state"][k] - p.detach().numpy())[firm].max(
            initial=0.0)
        assert err <= STEP_TOL * np.abs(p.detach().numpy()).max(), k


def test_dp_shard_targets_weights():
    from gnn_bfs_rans_tpu_torch.parallel import shard_targets

    t = np.arange(3, dtype=np.float32)[:, None, None] * np.ones((3, 2, 7),
                                                                np.float32)
    mesh = jdp.make_data_mesh(2)
    jt, jw = jdp.shard_targets(t, mesh)
    parts = [shard_targets(t, 2, r, "cpu") for r in range(2)]
    np.testing.assert_array_equal(
        np.concatenate([p[0].numpy() for p in parts]), np.asarray(jt))
    np.testing.assert_array_equal(
        np.concatenate([p[1].numpy() for p in parts]), np.asarray(jw))
    assert float(sum(p[1].sum() for p in parts)) == pytest.approx(1.0)


def test_gather_predictions_order():
    from gnn_bfs_rans_tpu_torch.parallel import (gather_predictions,
                                                 make_dp_forward)

    g = _port_grid("GCN")
    model = FlowGNN(ModelConfig(hidden_dim=8, num_layers=1, backend="dense"))
    out = make_dp_forward(model)(g)
    got = gather_predictions(out, g)
    assert got.shape == (g.n_nodes, 7)
    np.testing.assert_array_equal(got, out.numpy()[:g.n_nodes])


# ---------------------------------------------------------- multi-case
def test_make_perturbed_cases_matches_jax(setups):
    m = setups["multicase"]
    for f in ("node_feats", "edge_feats", "targets"):
        np.testing.assert_array_equal(getattr(m["batch"], f),
                                      np.asarray(getattr(m["jbatch"], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(m["base"].perm.numpy(),
                                  np.asarray(m["jbase"].perm))


def test_multicase_step_matches_jax(setups, ranks):
    m = setups["multicase"]
    jtcfg = JaxTrainConfig(grad_clip=NO_CLIP)
    mesh = jdp.make_data_mesh(2)
    state = jdp.replicate(_jax_state(m["params"], m["stats"], jtcfg), mesh)
    sharded = jmc.shard_cases(m["jbatch"], mesh)
    model = JaxFlowGNN(m["jcfg"])
    step = jmc.make_multicase_train_step(model, jtcfg, mesh)
    new, loss = step(state, m["jbase"], sharded, jnp.float32(LR),
                     jax.random.PRNGKey(0))
    _, res = _job(ranks, 2, "multicase_step")
    assert res["loss"] == pytest.approx(float(loss), rel=FWD_TOL)
    cfg = ModelConfig.from_dict(m["jcfg"].to_dict())
    _assert_step(res["state"], res["grads"], new.params, m["params"], cfg,
                 "multicase")
    # the reduced gradients: JAX's gradient of the mean over the 4 cases
    jb = m["jbatch"]
    _assert_grads(res["grads"], _jax_grads(
        m["jcfg"], m["params"], m["stats"],
        [(jmc._local_graph(m["jbase"], jb.node_feats[c], jb.edge_feats[c]),
          jb.targets[c]) for c in range(jb.n_cases)], jb.n_cases),
        "multicase vs jax.grad")
    # the running statistics, averaged over the ranks
    _, stats = _port_tree(res["state"], cfg)
    for k, w in _leaves(new.batch_stats).items():
        np.testing.assert_allclose(_leaves(stats)[k], w, rtol=STEP_TOL,
                                   atol=STEP_TOL * np.abs(w).max())
    # the forward's predictions (before the step): case and cell order
    fwd = jmc.make_multicase_forward(model, mesh)
    want = jmc.gather_case_predictions(
        fwd(m["params"], m["stats"], m["jbase"], sharded), m["jbase"])
    assert res["pred"].shape == want.shape == (4, 384, 7)
    assert np.abs(res["pred"] - want).max() <= STEP_TOL * np.abs(want).max()


# ------------------------------------------------ the steps' CUDA graphs
def _tensors(obj, path="arg"):
    """(path, tensor) of every tensor field of a dataclass, at any depth."""
    if isinstance(obj, torch.Tensor):
        return [(path, obj)]
    if dataclasses.is_dataclass(obj):
        return [leaf for f in dataclasses.fields(obj)
                for leaf in _tensors(getattr(obj, f.name),
                                     f"{path}.{f.name}")]
    return []


def _capture_args(setups, kind):
    """Three arguments of one kind: a and b of one shape, c of another
    (or other counts)."""
    from gnn_bfs_rans_tpu_torch.parallel import shard_cases, shard_partition

    if kind == "graph":
        a = _port_grid("GAT")
        a.band.transposed("bias_self")       # a plane the Band keeps
        b = dataclasses.replace(a, node_feat=a.node_feat + 1,
                                edge_feat=-a.edge_feat)
        return a, b, dataclasses.replace(a, n_nodes=a.n_nodes - 1)
    if kind == "case_batch":
        batch = setups["multicase"]["batch"]
        return (shard_cases(batch, 2, 0, "cpu"),
                shard_cases(batch, 2, 1, "cpu"),
                shard_cases(batch, 4, 0, "cpu"))     # a shorter chunk
    grid = _port_grid("GAT")
    pg = build_partition(grid, 2, HALO)
    return (shard_partition(pg, 0, "cpu"), shard_partition(pg, 1, "cpu"),
            shard_partition(build_partition(grid, 4, HALO), 0, "cpu"))


@pytest.mark.parametrize("kind", ["graph", "case_batch", "partition"])
def test_capture_copies_dataclass_arguments(setups, kind):
    """What a CUDA graph of a scale-out step keeps of a dataclass argument
    (``train/graphs.py``, device-independent): a static copy whose every
    tensor (the Band's kept transposed plane too) is a clone; a call's
    tensors copied into it, the caller's left as they were; the
    signature, the graph's key, equal for equal shapes and counts and
    different otherwise; a call that differs in more than tensor values
    raises rather than replaying on the captured ones."""
    from gnn_bfs_rans_tpu_torch.train.graphs import (_load_into,
                                                     _static_copy, signature)

    a, b, c = _capture_args(setups, kind)
    static = _static_copy(a)
    before = [t.clone() for _, t in _tensors(a)]
    for (name, s), (_, t) in zip(_tensors(static), _tensors(a)):
        assert s is not t and torch.equal(s, t), name
    _load_into(static, b, "arg")
    for (name, s), (_, t) in zip(_tensors(static), _tensors(b)):
        assert torch.equal(s, t), name
    assert all(torch.equal(x, t) for x, (_, t) in zip(before, _tensors(a)))
    if kind == "graph":
        kept = static.band.__dict__["_transposed"]["bias_self"]
        assert torch.equal(kept, b.band.transposed("bias_self"))
    assert signature(a, 1e-3) == signature(b, 3e-4)
    assert signature(a) != signature(c)
    with pytest.raises(ValueError):
        _load_into(static, c, "arg")


@pytest.mark.parametrize("world,job", [(2, "partitioned_step"),
                                       (4, "partitioned_step"),
                                       (2, "dp_step"),
                                       (2, "multicase_step")])
def test_steps_stay_eager_in_a_gloo_group(ranks, world, job):
    """A gloo group's collectives cannot be captured: on every rank the
    graphed step ran eagerly."""
    for rank in range(world):
        _, res = _job(ranks, world, job, rank=rank)
        assert res["captured"] is False
