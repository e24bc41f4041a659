"""Benchmark harness: edge-messages/sec/card with honest device timing.

Counterpart of ``gnn_bfs_rans_tpu/utils/bench.py``.  Metric
(``BASELINE.json``): one "edge message" = one edge processed by one conv
layer, so a forward emits ``num_layers × n_edges`` messages.

The JAX harness's four defenses hold here too:

1. **Full-output consumption** — the chain feeds a reduction of the WHOLE
   output back into the next input, so no part of the model is dead work.
2. **Signal ≫ noise** — base 8 / reps 64 / trials 5 by default, and the
   reps widen until the full-vs-base delta is ≥ ``min_snr``× the trial
   spread; a delta ≤ 0 raises.
3. **Roofline sanity** — analytic matmul FLOPs (``utils.roofline``) over the
   measured time must not exceed the card's peak; a violation raises.
4. **Steady-state cross-check** — back-to-back dispatches of the same step;
   steady-state below half the chained time raises.

Timing methodology — **chained marginal latency**.  JAX traces one
``fori_loop`` of K data-dependent forwards; here one chained body
(forward, then ``feat += sum(out)·1e-30`` into the static ``node_feat``
the body reads) is captured as a CUDA graph (``train/graphs.py``), and
T(K) is K back-to-back replays ending in a one-element fetch.  The
marginal cost ``(T(K) − T(base)) / (K − base)`` isolates the device
execution of one forward: the launch latency and the fence cancel in the
subtraction.  Off the card the body runs eagerly, with the widening
capped as the JAX harness caps it off the TPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..train.graphs import Graphed


def _fetch_scalar(out) -> None:
    """Fence: fetch one element of the first tensor in ``out`` (``.item()``
    waits for the work queued before it on the current stream)."""
    while not isinstance(out, torch.Tensor):
        out = next(iter(out.values() if isinstance(out, dict) else out))
    out.reshape(-1)[0].item()


@dataclasses.dataclass
class MarginalTiming:
    step_s: float
    base: int
    reps: int
    trials: int
    t_base_s: float
    t_full_s: float
    spread_s: float        # max−min over trials at the full rep count
    snr: float             # (t_full − t_base) / spread

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _marginal_from_times(
    t_base: float, t_full: float, base: int, reps: int,
    spread: float, trials: int,
) -> MarginalTiming:
    """Form the marginal estimate; refuse a collapsed (≤0) delta."""
    delta = t_full - t_base
    if delta <= 0:
        raise RuntimeError(
            f"bench resolution collapse: T({reps})={t_full:.4f}s ≤ "
            f"T({base})={t_base:.4f}s — the marginal signal is below the "
            f"jitter floor even at reps={reps}; refusing to report"
        )
    return MarginalTiming(
        step_s=delta / (reps - base),
        base=base, reps=reps, trials=trials,
        t_base_s=t_base, t_full_s=t_full, spread_s=spread,
        snr=delta / spread,
    )


def _chain(apply_fn, graph):
    """``(step, fence)``: ``step()`` runs one chained forward — ``apply_fn``
    on ``graph`` with ``node_feat`` replaced by a static buffer ``feat``,
    then ``feat += sum(out)·1e-30`` (numerically invisible, but the next
    forward depends on every output element) — and returns ``feat``;
    ``fence()`` fetches one element of it.  ``feat`` is updated in place
    and never passed as an argument: a ``Graphed`` argument would be copied
    into the graph's own buffer on every replay.  Two calls are made here
    (the warm-up, then the capture and its replay)."""
    feat = graph.node_feat.clone()
    g = dataclasses.replace(graph, node_feat=feat)

    def body():
        with torch.no_grad():
            out = apply_fn(g)
            feat.add_(out.sum().to(feat.dtype) * 1e-30)
        return feat

    step = Graphed(body, feat.device)
    step()
    step()
    return step, lambda: _fetch_scalar(feat)


def _marginal_time(step, fence, device: torch.device, reps: int, base: int,
                   trials: int, min_snr: float,
                   max_reps: int) -> MarginalTiming:
    """Marginal seconds per ``step()`` from k back-to-back calls ending in
    ``fence()``; the reps double until the delta clears ``min_snr×`` the
    trial spread.  Off the card the widening is capped low (the plain
    versions are slow and there is no launch jitter to average away)."""
    if device.type != "cuda":
        reps = min(reps, 16)
        base = min(base, 2)
        trials = min(trials, 2)
        max_reps = min(max_reps, 32)

    def run(k: int) -> None:
        for _ in range(k):
            step()
        fence()

    def timings(k: int) -> list[float]:
        run(k)  # warm
        ts = []
        for _ in range(trials):
            t0 = time.perf_counter()
            run(k)
            ts.append(time.perf_counter() - t0)
        return ts

    while True:
        tb = timings(base)
        tf = timings(reps)
        t_base, t_full = min(tb), min(tf)
        spread = max(max(tf) - min(tf), 1e-9)
        if (t_full - t_base) >= min_snr * spread or reps >= max_reps:
            break
        reps *= 2
    return _marginal_from_times(t_base, t_full, base, reps, spread, trials)


def chained_marginal_time(
    apply_fn,
    graph,
    reps: int = 64,
    base: int = 8,
    trials: int = 5,
    min_snr: float = 20.0,
    max_reps: int = 512,
) -> MarginalTiming:
    """Marginal seconds per forward via chained data-dependent calls.

    ``apply_fn(graph) -> out`` must be a function of the graph alone.  See
    the module docstring: one captured chained body, T(k) = k replays, and
    ``(T(reps) − T(base)) / (reps − base)``; the reps double until the
    delta clears ``min_snr×`` the trial spread.
    """
    step, fence = _chain(apply_fn, graph)
    return _marginal_time(step, fence, graph.node_feat.device, reps, base,
                          trials, min_snr, max_reps)


def steady_state_time(
    dispatch_fn,
    steps: int = 64,
    base: int = 8,
    depth: int = 3,
    trials: int = 2,
) -> float:
    """Wall throughput of back-to-back host-driven dispatches.

    ``dispatch_fn(i) -> out`` launches step ``i`` asynchronously and returns
    something fetchable.  A bounded pending queue (``depth``) keeps the
    device busy; ``(T(steps) − T(base)) / (steps − base)`` subtracts the
    warm-up and fence cost.  At very small step times it upper-bounds
    device time by the per-dispatch host cost instead — the cross-check in
    :func:`run_benchmark` accounts for that asymmetry.
    """

    def burst(n: int) -> float:
        pending = []
        t0 = time.perf_counter()
        for i in range(n):
            pending.append(dispatch_fn(i))
            if len(pending) > depth:
                _fetch_scalar(pending.pop(0))
        for o in pending:
            _fetch_scalar(o)
        return time.perf_counter() - t0

    burst(base)  # warm the dispatch path
    tb = min(burst(base) for _ in range(trials))
    tk = min(burst(steps) for _ in range(trials))
    return max((tk - tb) / (steps - base), 1e-9)


def time_fn(fn, *args, steps: int = 50, warmup: int = 5, chunk: int = 10) -> dict:
    """Wall-time of back-to-back launches fenced by a host fetch: the
    launch+execute pipeline throughput, an upper bound on per-step cost."""

    out = None
    for _ in range(warmup):
        out = fn(*args)
    _fetch_scalar(out)
    rt0 = time.perf_counter()
    _fetch_scalar(out)
    roundtrip = time.perf_counter() - rt0

    n_chunks = max(steps // chunk, 3)
    times = []
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        for _ in range(chunk):
            out = fn(*args)
        _fetch_scalar(out)
        dt = time.perf_counter() - t0 - roundtrip
        times.append(max(dt, 1e-9) / chunk)
    times = np.array(times)
    return {
        "median_s": float(np.median(times)),
        "mean_s": float(times.mean()),
        "p10_s": float(np.percentile(times, 10)),
        "min_s": float(times.min()),
        "steps": steps,
    }


def _cross_check(chained_s: float, steady_s: float | None,
                 strict: bool = True) -> dict:
    """Reconcile the two timing modes; raise on impossible disagreement.

    Steady-state wall per step can exceed the chained marginal time when
    per-dispatch host cost dominates a sub-ms step (it is an upper bound on
    device time) — reported, not fatal.  Steady-state *less than half* the
    chained time is impossible for a device executing the steps and means
    one measurement is broken.  ``strict=False`` (the plain versions timed
    on a shared host's clock, where load inflates either measurement)
    reports the ratio without raising.
    """
    if steady_s is None:
        return {"steady_available": False}
    ratio = steady_s / chained_s
    if ratio < 0.5 and strict:
        raise RuntimeError(
            f"timing cross-check failed: steady-state {steady_s*1e6:.1f} µs "
            f"is {1/ratio:.1f}× FASTER than chained marginal "
            f"{chained_s*1e6:.1f} µs — physically impossible; one harness "
            f"is under-resolved"
        )
    return {
        "steady_available": True,
        "steady_over_chained": ratio,
        "agreement_2x": bool(ratio <= 2.0),
        # ratio > 2 ⇒ the dispatch path, not the device, limits steady-state
        "steady_dispatch_bound": bool(ratio > 2.0),
    }


def _check_finite(model) -> None:
    """Raise if a parameter went non-finite during the timed steps: their
    time is then not that of training."""
    with torch.no_grad():
        finite = torch.stack([torch.isfinite(p).all()
                              for p in model.parameters()]).all()
    if not finite.item():
        raise FloatingPointError("a parameter is non-finite after the timed "
                                 "train steps")


def _train_chain(model, graph, targets, dropout_gen):
    """``(step, fence)``: ``step()`` is one train step (``train/loop.py
    train_step``) at lr 3e-4 on ``targets``, a CUDA graph on the card with
    ``dropout_gen`` registered (fresh masks each replay); ``fence()``
    fetches one parameter.  The parameters and Adam state advance in place
    from step to step (:func:`_check_finite` checks them after).  Two
    steps are taken here (the warm-up, then the capture and its replay)."""
    from ..train.loop import TrainConfig, make_optimizer, train_step

    tcfg = TrainConfig()
    optimizer = make_optimizer(model, tcfg)
    lr = torch.tensor(3e-4, dtype=torch.float32, device=targets.device)
    step = Graphed(
        lambda: train_step(model, optimizer, graph, targets, lr, tcfg,
                           dropout_gen),
        targets.device, generators=(dropout_gen,),
        before_capture=lambda: optimizer.zero_grad(set_to_none=True))
    step()
    step()
    return step, lambda: _fetch_scalar(model.out_3.bias)


def run_benchmark(
    case_path: str = "OpenFOAM-data",
    layer_type: str = "GAT",
    num_layers: int = 4,
    hidden_dim: int = 256,
    backend: str = "pallas",
    steps: int = 64,
    mode: str = "forward",
    baseline_msgs_per_sec: float = 1e8,
    compute_dtype: str = "bfloat16",
    cross_check: bool = True,
    trace: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Benchmark a model config on an OpenFOAM case; returns a JSON-able
    dict with the JAX harness's keys.

    Defaults are the flagship configuration: 4-layer GAT on the banded
    kernels, bfloat16.  ``mode='forward'``: the eval forward (running
    statistics, dropout 0).  ``mode='train'``: the train step (dropout
    0.1, every snapshot's targets), chained as K replays of its graph; a
    parameter non-finite after the timing raises.
    Unlike the JAX harness, whose every timing call restarts its chain
    from the initial state, the parameters and Adam state advance in place
    through every call (no copy of the state per timing call): the steps
    timed are steps 2, 3, … of one run.  ``trace=True`` adds a per-op
    device trace of the same step (``utils/trace.py``), a third witness
    independent of dispatch.  ``device``: ``cuda`` (the kernels; raises
    without a card) or ``cpu`` (their plain versions).
    """
    from ..graph.band import LAYER_COMPONENTS
    from ..models.flow_gnn import FlowGNN, ModelConfig
    from ..train.data import load_dataset
    from . import roofline

    dev = resolve_device(device)
    dataset = load_dataset(
        case_path,
        with_band=(backend == "pallas"),
        band_components=LAYER_COMPONENTS[layer_type],
    )
    graph = dataset.graph.to(dev)

    mcfg = ModelConfig(
        hidden_dim=hidden_dim,
        num_layers=num_layers,
        layer_type=layer_type,
        backend=backend,
        dropout=0.0 if mode == "forward" else 0.1,
        compute_dtype=compute_dtype,
    )
    model = FlowGNN(mcfg, generator=torch.Generator().manual_seed(0)).to(dev)
    n_params = sum(p.numel() for p in model.parameters())

    edge_messages = num_layers * graph.n_edges

    if mode == "forward":
        model.eval()
        step, fence = _chain(model, graph)
    else:
        targets = torch.from_numpy(dataset.targets).to(dev)
        step, fence = _train_chain(
            model, graph, targets, torch.Generator(device=dev).manual_seed(1))
    timing = _marginal_time(step, fence, dev, max(steps, 64), 8, 5, 20.0, 512)
    launch = lambda i: step()  # noqa: E731
    steady_s: float | None = None
    if cross_check:
        steady_s = (steady_state_time(launch) if mode == "forward"
                    else steady_state_time(launch, steps=32, base=4))
    if mode == "train":
        _check_finite(model)

    step_s = timing.step_s
    check = _cross_check(step_s, steady_s, strict=dev.type == "cuda")

    trace_info = None
    if trace:
        from . import trace as trace_mod

        tres = trace_mod.trace_steps(launch, n_steps=32)
        device_s = tres["device_total_s_per_step"]
        trace_info = {
            "device_total_s_per_step": device_s,
            # device total vs chained marginal: the two independent
            # methods should agree; >15% disagreement flags a broken harness
            "trace_over_chained": device_s / step_s,
            "agreement_15pct": bool(abs(device_s / step_s - 1.0) <= 0.15),
            **trace_mod.top_ops(tres, n=20),
        }

    roof = roofline.analyze(
        layer_type=layer_type, num_layers=num_layers, hidden_dim=hidden_dim,
        n_nodes=graph.n_nodes, n_edges=graph.n_edges, time_s=step_s,
        mode=mode, heads=mcfg.heads, param_count=n_params,
        graph_bytes=roofline.graph_static_bytes(graph),
        use_edge_attr=mcfg.use_edge_attr, device=dev,
    )
    roofline.check_roofline(roof["matmul_flops"], step_s, device=dev)

    msgs_per_sec = edge_messages / step_s
    return {
        "metric": "edge_messages_per_sec_per_chip",
        "value": msgs_per_sec,
        "unit": "msgs/s",
        "vs_baseline": msgs_per_sec / baseline_msgs_per_sec,
        "mode": mode,
        "layer_type": layer_type,
        "num_layers": num_layers,
        "hidden_dim": hidden_dim,
        "backend": backend,
        "compute_dtype": compute_dtype,
        "n_edges": graph.n_edges,
        "n_nodes": graph.n_nodes,
        "n_params": n_params,
        "step_median_s": step_s,
        "step_min_s": step_s,
        "step_steady_s": steady_s,
        "steps_per_sec": 1.0 / step_s,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "timing": "chained_marginal",
        "timing_detail": timing.to_dict(),
        "cross_check": check,
        **({"trace": trace_info} if trace_info is not None else {}),
        "matmul_flops": roof["matmul_flops"],
        "mfu": roof["mfu"],
        "bound": roof["bound"],
        "bytes_basis": roof["bytes_basis"],
        "hbm_bytes_xla": None,
        "hbm_bytes_est": roof["hbm_bytes_est"],
        "hbm_frac": roof.get("hbm_frac"),
        "flops_per_sec": roof["flops_per_sec"],
        "roofline_min_s": roof.get("roofline_min_s"),
    }
