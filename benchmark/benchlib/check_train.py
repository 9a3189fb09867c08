"""``correct`` for the training cells: the reference's first three steps
from the same weights and feed against the program's, and the reference's
redo of the step after the window from the program's state before it.

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the program's and the
  reference's norm of the first gradient, over the larger of the
  reference's norm of that leaf and of the median leaf; and the same for
  the gradient of the step after the window;
* ``change_gap`` and ``ema_gap``: the same for each leaf's change of the
  weights and of their EMA over the three steps, and over the step after
  the window.

Each number is the larger of its two readings; ``extra`` keeps the
after-window step's own.  Leaves whose reference gradient of a step is
under a thousandth of the median leaf's move by round-off alone under
adamax's normalised step, and are left out of that step's change and EMA
(never by name: by this rule)."""

from __future__ import annotations

import numpy as np
import torch

MOVED = 1e-3


def _norms(tensors: dict, names) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(tensors[k].double()))
                     for k in names])


def worst_gap(prog: dict, ref: dict, names) -> float:
    a, b = _norms(prog, names), _norms(ref, names)
    floor = float(np.median(b))
    return float(np.max(np.abs(a - b) / np.maximum(b, floor)))


def _moved(grads: dict, names) -> list:
    norm = _norms(grads, names)
    return [k for k, n in zip(names, norm)
            if n >= MOVED * float(np.median(norm))]


def window_step_gaps(drv, n_blocks: int, tc: dict, dev) -> dict:
    """The step after the window, redone by the reference from the
    program's state before it: loss, gradient (the program's from its
    first moment, ``(mu' - b1 mu) / (1 - b1)``), weights' and EMA's
    change."""
    from reference.train import B1, Adamax, step

    b, a = drv.before, drv.after
    names = sorted(b["params"])
    def copy(d):
        return {k: v.to(dev, copy=True) for k, v in d.items()}

    p, ema = copy(b["params"]), copy(b["ema"])
    opt = Adamax(p, tc["learning_rate"], mu=copy(b["mu"]),
                 nu=copy(b["nu"]), count=b["count"])
    x, noise = drv.feed(b["step"])
    value, grads = step(p, ema, opt, n_blocks, x, noise, tc["lamb"],
                        tc["ema_decay"])
    g_ref = {k: v.cpu() for k, v in grads.items()}
    g_prog = {k: (a["mu"][k].double() - B1 * b["mu"][k].double())
              / (1.0 - B1) for k in names}
    moved = _moved(g_ref, names)
    return {
        "loss_gap": abs(a["loss"] - value) / abs(value),
        "grad_gap": worst_gap(g_prog, g_ref, names),
        "change_gap": worst_gap(
            {k: a["params"][k] - b["params"][k] for k in names},
            {k: p[k].cpu() - b["params"][k] for k in names}, moved),
        "ema_gap": worst_gap(
            {k: a["ema"][k] - b["ema"][k] for k in names},
            {k: ema[k].cpu() - b["ema"][k] for k in names}, moved),
    }


def check_steps(drv) -> dict:
    from reference import rvae
    from reference.train import run_steps

    rvae.full_precision()
    dev = drv.devs[0]
    mc = drv.config["model"]
    tc = drv.config["train"]
    n_blocks = mc["num_res_blocks"]
    p = {k: v.to(dev) for k, v in drv.weights.items()}
    x0, n0 = drv.feed(0)
    rvae.data_dependent_init(p, n_blocks, x0, n0)
    p0 = {k: v.detach().cpu().clone() for k, v in p.items()}
    feed = [drv.feed(i) for i in range(1, len(drv.losses) + 1)]
    ref = run_steps(p, n_blocks, feed, tc["lamb"], tc["learning_rate"],
                    tc["ema_decay"])
    names = sorted(p0)
    g_ref = {k: v.cpu() for k, v in ref["first_grads"].items()}
    moved = _moved(g_ref, names)
    drv.left_out = sorted(set(names) - set(moved))
    d_prog = {k: drv.p3[k] - drv.p0[k] for k in names}
    d_ref = {k: ref["params"][k].cpu() - p0[k] for k in names}
    e_prog = {k: drv.e3[k] - drv.p0[k] for k in names}
    e_ref = {k: ref["ema"][k].cpu() - p0[k] for k in names}
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(drv.losses, ref["losses"]))
    first = {
        "loss_gap": float(loss_gap),
        "grad_gap": worst_gap(drv.g1, g_ref, names),
        "change_gap": worst_gap(d_prog, d_ref, moved),
        "ema_gap": worst_gap(e_prog, e_ref, moved),
    }
    del p, ref
    drv.window_step = window_step_gaps(drv, n_blocks, tc, dev)
    numbers = {k: max(v, drv.window_step[k]) for k, v in first.items()}
    return {"numbers": numbers, "checked": len(drv.losses) + 1,
            "failed": int(not all(np.isfinite(list(numbers.values()))))}
