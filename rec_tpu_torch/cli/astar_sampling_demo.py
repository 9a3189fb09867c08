"""A* sampling demo (port of examples/astar_sampling_demo.py).

    python -m rec_tpu_torch.cli.astar_sampling_demo --samples 200

Draws exact samples from a 1-D mixture of Gaussians p by perturbing a wide
Gaussian proposal q with a Gumbel process: regions of the real line carry
Gumbel(log q-mass) maxima, the search pops the region of highest optimistic
score Gumbel + max_x o(x) (o = log p - log q, bounded on a 512-point grid
plus its largest step), and stops when the best Gumbel + o(X) found beats
every frontier bound.  ``log_ratio`` runs in float32 on the device; the
frontier, the region masses and the ``RandomState``/scipy ``truncnorm``
draws stay on the host, as in the example.  Checks the sample mean against
the mixture's within 4 standard errors and exits with 1 when it is not.
``--device cpu`` runs on the CPU; by default the run needs a GPU and
raises without one.
"""

from __future__ import annotations

import argparse
import heapq
import math
import sys
import time

import numpy as np
import torch

from ..device import resolve_device

# Target: 3-component MoG; proposal: a wide Gaussian covering it.
MOG_W = np.array([0.3, 0.5, 0.2])
MOG_LOC = np.array([-2.0, 0.5, 3.0])
MOG_SCALE = np.array([0.4, 0.7, 0.3])
Q_LOC, Q_SCALE = 0.0, 3.0
_HALF_LOG_2PI = 0.9189385332046727


class LogRatio:
    """o(x) = log p(x) - log q(x) in float32 on ``device``."""

    def __init__(self, device):
        self.device = resolve_device(device)

        def f32(a):
            return torch.tensor(a, dtype=torch.float32, device=self.device)

        # XLA-CPU divides by a constant as a multiply by its float32
        # reciprocal; so does this.
        scale = f32(MOG_SCALE)
        self.loc, self.inv_scale = f32(MOG_LOC), 1.0 / scale
        self.log_scale, self.log_w = torch.log(scale), torch.log(f32(MOG_W))
        self.inv_q_scale = f32(1.0) / Q_SCALE

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        comp = (-0.5 * torch.square((x[..., None] - self.loc)
                                    * self.inv_scale)
                - self.log_scale - _HALF_LOG_2PI + self.log_w)
        log_p = torch.logsumexp(comp, dim=-1)
        log_q = (-0.5 * torch.square((x - Q_LOC) * self.inv_q_scale)
                 - math.log(Q_SCALE) - _HALF_LOG_2PI)
        return log_p - log_q

    def at(self, x: float) -> float:
        return float(self(torch.tensor(x, dtype=torch.float32,
                                       device=self.device)))

    def bound(self, lo: float, hi: float, grid: int = 512) -> float:
        """Upper bound of o on [lo, hi]: the grid's max plus its largest
        step (one read from the device)."""
        vals = self(torch.linspace(lo, hi, grid, dtype=torch.float32,
                                   device=self.device))
        top, slack = torch.stack([torch.max(vals),
                                  torch.max(torch.abs(torch.diff(vals)))
                                  ]).tolist()
        return top + slack


def _q_mass(lo: float, hi: float) -> float:
    def cdf(x):
        return 0.5 * (1.0 + math.erf((x - Q_LOC)
                                     / (Q_SCALE * math.sqrt(2.0))))

    return max(cdf(hi) - cdf(lo), 1e-300)


def _truncated_q(rs: np.random.RandomState, lo: float, hi: float) -> float:
    from scipy.stats import truncnorm

    a, b = (lo - Q_LOC) / Q_SCALE, (hi - Q_LOC) / Q_SCALE
    return float(truncnorm.rvs(a, b, loc=Q_LOC, scale=Q_SCALE,
                               random_state=rs))


def astar_sample(rs: np.random.RandomState, o: LogRatio, lo: float = -30.0,
                 hi: float = 30.0, max_pops: int = 200) -> float:
    """One exact sample from the MoG by A* search over the Gumbel
    process."""
    def gumbel(log_mass):
        return log_mass - math.log(-math.log(rs.uniform()))

    best_x, best_val = None, -np.inf
    g0 = gumbel(math.log(_q_mass(lo, hi)))
    frontier = [(-(g0 + o.bound(lo, hi)), g0, lo, hi)]
    for _ in range(max_pops):
        neg_priority, g, a, b = heapq.heappop(frontier)
        if -neg_priority <= best_val:
            return best_x   # nothing on the frontier can win any more
        x = _truncated_q(rs, a, b)
        val = g + o.at(x)
        if val > best_val:
            best_x, best_val = x, val
        # Split at the sampled point; each child's Gumbel maximum is a
        # Gumbel(log child-mass) truncated below the parent's realised max:
        # TruncGumbel(mu, b) = -log(exp(-Gumbel(mu)) + exp(-b)).
        for ca, cb in ((a, x), (x, b)):
            if cb - ca < 1e-9:
                continue
            raw = gumbel(math.log(_q_mass(ca, cb)))
            cg = -math.log(math.exp(-raw) + math.exp(-g))
            heapq.heappush(frontier, (-(cg + o.bound(ca, cb)), cg, ca, cb))
        if not frontier:
            return best_x
    return best_x


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Samples and checks the mean; returns the samples, their moments and
    the seconds taken.  Exits with 1 when the mean is off."""
    args = parse_args(argv)
    o = LogRatio(args.device)
    rs = np.random.RandomState(args.seed)
    t0 = time.perf_counter()
    xs = np.array([astar_sample(rs, o) for _ in range(args.samples)])
    seconds = time.perf_counter() - t0

    true_mean = float(np.sum(MOG_W * MOG_LOC))
    true_var = float(np.sum(MOG_W * (MOG_SCALE ** 2 + MOG_LOC ** 2))
                     - true_mean ** 2)
    se = math.sqrt(true_var / args.samples)
    print(f"A* samples: n={args.samples}  mean={xs.mean():+.3f} "
          f"(true {true_mean:+.3f}, se {se:.3f})  "
          f"var={xs.var():.3f} (true {true_var:.3f})")
    ok = bool(abs(xs.mean() - true_mean) < 4 * se)
    print(f"mean within 4 standard errors: {ok}")
    if not ok:
        raise SystemExit(1)
    return {"samples": xs, "mean": float(xs.mean()), "var": float(xs.var()),
            "true_mean": true_mean, "true_var": true_var, "se": se,
            "ok": ok, "seconds": seconds}


if __name__ == "__main__":
    main(sys.argv[1:])
