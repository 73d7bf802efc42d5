"""Minimal (mu/mu_w, lambda)-CMA-ES with an ask/tell interface (the port's
copy of :mod:`dhts.utils.cma_es`, which the port does not import).

Hansen-style CMA-ES: rank-mu and rank-one covariance updates, cumulative
step-size adaptation, box constraints by projection with a penalty on the
raw samples. The covariance bookkeeping is small (n is tens) and stays in
host NumPy; a caller evaluates each generation's population as one batch
on the device (the inverse benchmarks: one launch of the fused rollout
kernel per generation).
"""

from __future__ import annotations

import numpy as np


class CmaEs:
    """Ask/tell CMA-ES with box constraints by projection."""

    def __init__(self, x0, sigma, lower=None, upper=None, popsize=None,
                 seed=0):
        self.n = len(x0)
        self.mean = np.asarray(x0, np.float64).copy()
        self.sigma = float(sigma)
        self.lower = None if lower is None else np.asarray(lower, np.float64)
        self.upper = None if upper is None else np.asarray(upper, np.float64)
        self.rng = np.random.default_rng(seed)

        n = self.n
        self.popsize = popsize or 4 + int(3 * np.log(n))
        self.mu = self.popsize // 2
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.weights = w / w.sum()
        self.mueff = 1.0 / np.sum(self.weights**2)

        self.cc = (4 + self.mueff / n) / (n + 4 + 2 * self.mueff / n)
        self.cs = (self.mueff + 2) / (n + self.mueff + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mueff)
        self.cmu = min(
            1 - self.c1,
            2 * (self.mueff - 2 + 1 / self.mueff) / ((n + 2) ** 2 + self.mueff))
        self.damps = 1 + 2 * max(
            0, np.sqrt((self.mueff - 1) / (n + 1)) - 1) + self.cs

        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.C = np.eye(n)
        self.chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n**2))
        self._eig_fresh = False
        self._decompose()

    def _decompose(self):
        self.C = (self.C + self.C.T) / 2
        d, B = np.linalg.eigh(self.C)
        d = np.maximum(d, 1e-20)
        self.B = B
        self.D = np.sqrt(d)
        self.inv_sqrt_C = B @ np.diag(1.0 / self.D) @ B.T
        self._eig_fresh = True

    def ask(self) -> np.ndarray:
        """Sample a raw population ``[popsize, n]``.

        Samples are NOT clipped: projecting onto the box before ``tell``
        stalls covariance/step-size adaptation whenever the optimum sits
        near a bound (every projected sample looks identical along the
        violated coordinate). Callers evaluate ``repair(x)`` and tell the
        raw ``x`` with a penalized fitness — ``optimize`` does exactly
        that; pycma's bounds option does the same via its boundary
        handlers."""
        if not self._eig_fresh:
            self._decompose()
        z = self.rng.standard_normal((self.popsize, self.n))
        y = z @ np.diag(self.D) @ self.B.T  # y ~ N(0, C)
        return self.mean + self.sigma * y

    def repair(self, x: np.ndarray) -> np.ndarray:
        """Project ``x`` onto the box (the feasible point that gets
        evaluated)."""
        if self.lower is None and self.upper is None:
            return x
        return np.clip(x, self.lower, self.upper)

    def boundary_penalty(self, x_raw, x_repaired, fitness) -> np.ndarray:
        """Per-candidate penalty added to the feasible fitness when telling
        the raw sample: ``gamma * sum(((x - repair(x)) / width)^2)``, with
        ``gamma`` scaled to the generation's fitness spread so the penalty
        stays commensurate with the objective as it converges (a light
        version of pycma's adaptive BoundPenalty)."""
        if self.lower is None and self.upper is None:
            return np.zeros(len(x_raw))
        lo = self.lower if self.lower is not None else -np.inf
        hi = self.upper if self.upper is not None else np.inf
        width = np.where(np.isfinite(hi - lo) & (hi - lo > 0), hi - lo, 1.0)
        dist2 = np.sum(((x_raw - x_repaired) / width) ** 2, axis=1)
        med = np.median(fitness)
        # Floor the MAD with an objective-scale minimum (pycma's
        # BoundPenalty does the same): on a plateau generation the raw
        # spread is ~0 and the penalty would vanish, letting the
        # distribution drift arbitrarily far out of bounds unpenalized.
        mad = np.median(np.abs(fitness - med))
        spread = max(mad, 1e-2 * abs(med), 1e-8)
        return (self._pen_gamma * spread) * dist2

    _pen_gamma = 100.0

    def tell(self, solutions, fitness):
        """Rank ``solutions`` by ``fitness`` and update the distribution.

        The update is computed from the passed ``solutions`` (not a cached
        population), so callers may clip/repair/re-order candidates between
        ``ask`` and ``tell`` — the standard ask/tell contract."""
        y_all = (np.asarray(solutions, np.float64) - self.mean) / self.sigma
        order = np.argsort(fitness)
        y_sel = y_all[order[: self.mu]]
        y_w = self.weights @ y_sel
        self.mean = self.mean + self.sigma * y_w

        self.ps = ((1 - self.cs) * self.ps + np.sqrt(
            self.cs * (2 - self.cs) * self.mueff) * self.inv_sqrt_C @ y_w)
        hsig = (np.linalg.norm(self.ps) /
                np.sqrt(1 - (1 - self.cs) ** (2 * self._gen)) <
                (1.4 + 2 / (self.n + 1)) * self.chi_n)
        self.pc = ((1 - self.cc) * self.pc +
                   hsig * np.sqrt(self.cc * (2 - self.cc) * self.mueff) * y_w)

        rank1 = np.outer(self.pc, self.pc)
        rank_mu = (y_sel.T * self.weights) @ y_sel
        dh = (1 - hsig) * self.cc * (2 - self.cc)
        self.C = ((1 - self.c1 - self.cmu) * self.C +
                  self.c1 * (rank1 + dh * self.C) + self.cmu * rank_mu)
        self.sigma *= np.exp(
            (self.cs / self.damps) *
            (np.linalg.norm(self.ps) / self.chi_n - 1))
        self.sigma = float(np.clip(self.sigma, 1e-12, 1e6))
        self._eig_fresh = False
        self._gen += 1

    _gen = 1

    def optimize(self, batch_objective, num_evaluations):
        """Run until ~``num_evaluations`` objective evaluations.

        ``batch_objective(x[batch, n]) -> f[batch]`` — typically the
        simulator rollout over a batch of scenarios, so each generation is
        one device launch. Returns the per-evaluation fitness history
        (length clipped to ``num_evaluations``), the evaluated points and
        the best x seen.
        """
        history = []
        asked = []
        best_x, best_f = None, np.inf
        self._gen = 1
        while len(history) < num_evaluations:
            xs = self.ask()
            xe = self.repair(xs)
            fs = np.asarray(batch_objective(xe), np.float64)
            # distribution update sees the RAW samples with a penalized
            # fitness; the history/best records the feasible evaluations
            self.tell(xs, fs + self.boundary_penalty(xs, xe, fs))
            history.extend(fs.tolist())
            asked.extend(xe.tolist())
            i = int(np.argmin(fs))
            if fs[i] < best_f:
                best_f, best_x = float(fs[i]), xe[i].copy()
        return np.asarray(history[:num_evaluations]), np.asarray(
            asked[:num_evaluations]), best_x
