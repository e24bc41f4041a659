"""The reference's first training epochs and the numbers that judge the
program's.

:func:`reference_steps` runs the configuration's first epochs as its
definition states them, on the benchmark's weights and targets.  Each
epoch takes the snapshots in the order ``torch.rand(S).argsort()`` draws
from the training generator (batch 1), one step each: the training
forward, the loss, its gradient, the global-norm clip at ``grad_clip``,
then Adam (β 0.9, 0.999, ε 1e-8) with the L2 term ``weight_decay·p``
added to the gradient; then the eval loss, averaged over the snapshots
(``eval_mode``: ``'exact'`` with BatchNorm recalibration, the
configurations' bfloat16 default, else ``'eval'``).  The plateau
scheduler cannot cut the learning rate within its patience (10 epochs),
so the rate stays.  It records each step's loss and, for the first
epoch, its prediction; each epoch's training loss (the mean of its
steps) and eval loss; the gradient Adam took at step 1 (its first moment
÷ (1 − β1)); and, after the last epoch, each parameter's and running
statistic's change and each parameter's first moment.

:func:`judge` compares the program's readings of the same quantities
with the reference's.  The program's are taken where the window runs:
its first epoch is the epoch graph's eager warm-up, its second the
graph's capture and first replay, so everything read after the second
epoch went through the replayed graph that the window replays.

* ``loss``: the widest relative gap of a training loss: each step of the
  first epoch (the program's worked out from its prediction) and each
  epoch's loss as the program's trainer records it;
* ``val``: the widest relative gap of an epoch's eval loss;
* ``pred``: the widest over the first epoch's steps of the prediction's
  RMS gap over the reference's RMS (every cell and channel: the loss
  averages per-element rounding away, this does not);
* ``pred_first``: the same gap of the first step's prediction alone, at
  the set-up weights: before Adam's first step, which moves every
  parameter by ± the learning rate whatever the size of its gradient,
  so that a gradient component within rounding of 0 (a ReLU whose input
  rounds to either side of 0) moves its parameter either way;
* ``grad``: by the worst leaf, the gap between the program's step-1
  gradient norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf; ``grad_median``: the median
  leaf's gap;
* ``change`` / ``change_median``: the same gap of each leaf's change
  after the last epoch, by the worst leaf and the median leaf (running
  statistics included);
* ``moment`` / ``moment_median``: the same gap of Adam's first moment
  after the last epoch;
* ``unstepped``: the parameters whose Adam state the window did not
  advance by its steps (the program's own state before and after the
  window: the first moment changed, the step count up by the window's
  steps), so a replay that gives back the state it found shows.

Leaves whose reference gradient at step 1 is under a thousandth of the
median leaf's are left out of the leaf numbers.  A bias that BatchNorm
cancels has an exact gradient of 0, but its rounding residue reads a
little above that (1–4e-3 of the median leaf's); Adam moves it by the
residue's signs, which the program's bfloat16 rounding draws anew, so
its change is far off the reference's on every seed: ``change`` (the
worst leaf) is read out, ``change_median`` compared.  A leaf the
program never moved reads as a change of 0.
"""

from __future__ import annotations

import statistics

import torch

from .model import Forward, loss
from ..yardstick.weights import param_shapes

BETA1 = 0.9
EPOCHS = 2


def split_weights(cfg: dict, weights: dict[str, torch.Tensor]):
    params, stats = {}, {}
    for leaf in param_shapes(cfg):
        (stats if leaf.buffer else params)[leaf.name] = weights[leaf.name]
    return params, stats


def reference_steps(cfg: dict, tcfg: dict, graph, x: torch.Tensor,
                    targets: torch.Tensor, weights: dict, seed: int,
                    epochs: int = EPOCHS, quant: str = "f32",
                    eval_mode: str = "exact") -> dict:
    """``x`` [n, 3] row coordinates, ``targets`` [S, n, 7] in rows."""
    dev = x.device
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        p0, s0 = split_weights(cfg, weights)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p0.items()}
        stats = {k: v.detach().clone() for k, v in s0.items()}
        opt = torch.optim.Adam(list(params.values()), lr=tcfg["lr"],
                               betas=(BETA1, 0.999), eps=1e-8,
                               weight_decay=tcfg["weight_decay"],
                               foreach=False)
        fwd = Forward(cfg, graph, quant)
        gen = torch.Generator(device=dev).manual_seed(seed)
        n_snap = targets.shape[0]
        order, losses, preds, epoch_losses, vals = [], [], [], [], []
        grad1 = None
        for epoch in range(epochs):
            draw = (torch.rand(n_snap, generator=gen, device=dev).argsort()
                    if n_snap > 1 else torch.zeros(1, dtype=torch.long,
                                                   device=dev))
            for idx in (int(i) for i in draw):
                opt.zero_grad(set_to_none=True)
                out = fwd(params, stats, x, "train", gen=gen)
                lval = loss(out, targets[idx], tcfg["pressure_ref_weight"])
                lval.backward()
                torch.nn.utils.clip_grad_norm_(list(params.values()),
                                               tcfg["grad_clip"],
                                               foreach=False)
                opt.step()
                order.append(idx)
                losses.append(float(lval.detach()))
                if epoch == 0:
                    preds.append(out.detach())
                if grad1 is None:
                    grad1 = {k: opt.state[v]["exp_avg"] / (1 - BETA1)
                             for k, v in params.items()}
            epoch_losses.append(sum(losses[-n_snap:]) / n_snap)
            with torch.no_grad():
                vals.append(sum(
                    float(loss(fwd(params, stats, x, eval_mode), t,
                               tcfg["pressure_ref_weight"]))
                    for t in targets) / n_snap)
        return {
            "order": order,
            "losses": losses,
            "outputs": preds,
            "epoch_losses": epoch_losses,
            "val": vals,
            "grad1": grad1,
            "change": {k: float((v.detach() - weights[k]).norm())
                       for k, v in {**params, **stats}.items()},
            "moment": {k: float(opt.state[v]["exp_avg"].norm())
                       for k, v in params.items()},
        }
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def norms(tensors: dict) -> dict[str, float]:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, leaves: list[str]) -> dict[str, float]:
    """Each leaf's gap of norms, over the larger of the reference's norm
    of that leaf and of the median leaf."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}


def counted_leaves(ref: dict) -> list[str]:
    g = norms(ref["grad1"])
    med = statistics.median(g.values())
    return [k for k, v in g.items() if v >= 1e-3 * med]


def _buffers(ref: dict) -> list[str]:
    return [k for k in ref["change"] if k not in ref["grad1"]]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def leaf_readings(prog: dict, ref: dict) -> dict[str, dict[str, float]]:
    """The per-leaf gaps of ``grad``, ``change`` and ``moment``."""
    leaves = counted_leaves(ref)
    return {
        "grad": leaf_gaps(norms(prog.get("grad1") or {}),
                          norms(ref["grad1"]), leaves),
        "change": leaf_gaps(prog.get("change", {}), ref["change"],
                            leaves + _buffers(ref)),
        "moment": leaf_gaps(prog.get("moment", {}), ref["moment"], leaves),
    }


def judge(prog: dict, ref: dict, targets: torch.Tensor,
          pressure_ref_weight: float) -> dict[str, float]:
    """The numbers; ``prog`` holds ``outputs`` (the first epoch's
    predictions, [n, 7] rows), ``epoch_losses``, ``val``, ``grad1``
    (tensors), ``change`` and ``moment`` (norms) and, where a window ran,
    ``stepped`` (each parameter: did the window advance its state)."""
    step_gaps, preds = [], []
    for out, pref, idx, lref in zip(prog["outputs"], ref["outputs"],
                                    ref["order"], ref["losses"]):
        lp = float(loss(out.double(), targets[idx].double(),
                        pressure_ref_weight))
        step_gaps.append(_rel(lp, lref))
        preds.append(float((out.double() - pref.double()).pow(2).mean().sqrt()
                           / pref.double().pow(2).mean().sqrt()))
    epoch_gaps = [_rel(a, b) for a, b in zip(prog["epoch_losses"],
                                             ref["epoch_losses"])]
    gaps = leaf_readings(prog, ref)
    stepped = prog.get("stepped")
    return {
        "loss": max(step_gaps + epoch_gaps),
        "val": max(_rel(a, b) for a, b in zip(prog["val"], ref["val"])),
        "pred": max(preds),
        "pred_first": preds[0],
        "grad": max(gaps["grad"].values()),
        "grad_median": statistics.median(gaps["grad"].values()),
        "change": max(gaps["change"].values()),
        "change_median": statistics.median(gaps["change"].values()),
        "moment": max(gaps["moment"].values()),
        "moment_median": statistics.median(gaps["moment"].values()),
        "unstepped": (float(sum(not stepped.get(k, False)
                                for k in counted_leaves(ref)))
                      if stepped is not None else 0.0),
    }


def worst_leaves(prog: dict, ref: dict) -> dict[str, tuple[float, str]]:
    """The worst leaf of each per-leaf number, with its gap."""
    return {name: max((v, k) for k, v in gaps.items())
            for name, gaps in leaf_readings(prog, ref).items()}
