"""Inverse initial-state estimation harness (port of
:mod:`dhts.apps.inverse.problem`).

Given a randomly built scene and a random *true* initial state, roll the
simulator ``num_timestep`` steps to record a target end state, then
recover an initial state that reproduces it, comparing four optimizers:

* **GD**: Adam (``optax.adam``'s defaults) on the simulator's gradient, a
  Python loop over episodes, each one rollout, its backward, the update and
  a projection onto the box. ``solve_gd_restarts`` runs B restarts as the
  rollout's batch axis: one forward and one backward per episode for all of
  them.
* **CMA-ES** (:class:`dhts_torch.utils.cma_es.CmaEs`), each generation's
  population evaluated as one batch.
* **Nelder-Mead** and **SLSQP** via scipy, an early termination padded
  with the last value.

Per-trial logs are ``<dir>/<method>/trial_k.txt`` with one "beg_error
end_error" line per episode, the format of the JAX package's, and a
mean +- std log-scale graph is rendered where matplotlib is installed.

The optimized state is a pair of vectors ``(a, b)`` (density and speed, or
position and speed), ``[n]`` or, for a batch, ``[B, n]``; subclasses define
how it maps into the simulator. The problem runs on ``device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path).
"""

from __future__ import annotations

import os
import numpy as np
import torch

from dhts_torch.device import resolve_device
from dhts_torch.utils.cma_es import CmaEs


def as_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flat(pair) -> np.ndarray:
    """A state or bound pair ``(a, b)`` as one vector ``[a, b]``."""
    return np.concatenate([as_numpy(x) for x in pair])


class InverseProblem:
    """Abstract harness; subclasses implement the scene and state mapping.

    Required overrides:
      * ``build_scene(rng)``            construct the scene of a trial
      * ``random_initial_state(rng)``   draw a random ``(a, b)`` state
        (a perturbation of ``self.true_state`` once it is set)
      * ``end_state_of(est, differentiable)``  roll the simulator from
        ``est`` and return the compared end state ``(a, b)``; batched
        (``[B, n]``) where ``batched`` is True
      * ``bounds()``                    ``(lb, ub)`` pairs of vectors
    """

    batched = False  # end_state_of takes [B, n] states

    def __init__(self, num_trial: int, num_timestep: int, num_episode: int,
                 delta_time: float, speed_limit: float, run_name: str,
                 gd_lr: float = 1e-3, cma_sigma: float = 1.0,
                 log_root: str = "result/inverse_torch", seed: int = 0,
                 device=None):
        self.num_trial = num_trial
        self.num_timestep = num_timestep
        self.num_episode = num_episode
        self.delta_time = delta_time
        self.speed_limit = speed_limit
        self.gd_lr = gd_lr
        self.cma_sigma = cma_sigma
        self.seed = seed
        self.device = resolve_device(device)
        self.log_dir = os.path.join(log_root, run_name)
        os.makedirs(self.log_dir, exist_ok=True)
        self.true_state = None
        self.target_end = None
        # rollouts each scipy method ran in its last solve_scipy
        self.scipy_evaluations: dict[str, int] = {}

    # -- abstract --------------------------------------------------------

    def build_scene(self, rng: np.random.Generator):
        raise NotImplementedError

    def random_initial_state(self, rng: np.random.Generator):
        raise NotImplementedError

    def end_state_of(self, est, differentiable: bool):
        raise NotImplementedError

    def bounds(self):
        raise NotImplementedError

    # -- shared machinery -------------------------------------------------

    def tensor(self, x):
        """``x`` (a tensor, array or number) as a float32 tensor on the
        problem's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    @staticmethod
    def state_error(sa, sb):
        """Sum of squared differences over both state vectors (per row of
        a batch)."""
        return (torch.sum((sa[0] - sb[0]) ** 2, dim=-1) +
                torch.sum((sa[1] - sb[1]) ** 2, dim=-1))

    def end_states(self, est, differentiable: bool):
        """:meth:`end_state_of` for one state or a batch of them; a
        subclass that cannot batch is run row by row."""
        if est[0].dim() == 1 or self.batched:
            return self.end_state_of(est, differentiable)
        rows = [self.end_state_of((a, b), differentiable)
                for a, b in zip(est[0], est[1])]
        return tuple(torch.stack(x) for x in zip(*rows))

    def end_error(self, est, differentiable: bool = False):
        """Squared error of ``est``'s end state against the target."""
        return self.state_error(self.target_end,
                                self.end_states(est, differentiable))

    def initialize(self, rng: np.random.Generator):
        """Build a trial: scene, true state, simulated target end state."""
        self.build_scene(rng)
        self.true_state = None
        self.true_state = tuple(self.tensor(x) for x in
                                self.random_initial_state(rng))
        with torch.no_grad():
            self.target_end = tuple(
                x.detach() for x in self.end_states(self.true_state, False))

    def split(self, v):
        """``[..., 2n]`` vectors as an ``(a, b)`` pair of float32 tensors."""
        v = self.tensor(v)
        n = self.true_state[0].shape[-1]
        return v[..., :n], v[..., n:]

    def beg_error(self, est):
        return float(self.state_error(self.true_state, est))

    # -- solvers ----------------------------------------------------------

    def _gd(self, est0):
        """Adam on simulator gradients for ``num_episode`` episodes, from
        ``est0`` (``[n]`` or a batch ``[B, n]`` of independent restarts);
        each episode is one rollout and one backward of the whole batch.
        Returns ``(est, beg[E, ...], end[E, ...])``."""
        est = [self.tensor(x).clone().requires_grad_(True) for x in est0]
        opt = torch.optim.Adam(est, lr=self.gd_lr, betas=(0.9, 0.999),
                               eps=1e-8)
        lb, ub = (tuple(self.tensor(x) for x in b) for b in self.bounds())
        begs, ends = [], []
        for _ in range(self.num_episode):
            with torch.no_grad():
                begs.append(self.state_error(self.true_state, est))
            opt.zero_grad(set_to_none=True)
            end = self.end_error(est, True)
            end.sum().backward()
            opt.step()
            with torch.no_grad():
                for x, lo, hi in zip(est, lb, ub):
                    x.copy_(torch.clamp(x, lo, hi))
            ends.append(end.detach())
        return (tuple(x.detach() for x in est), torch.stack(begs),
                torch.stack(ends))

    def solve_gd(self, est0):
        """Adam on simulator gradients, box-projected after each step.
        Returns the per-episode ``(beg_errors, end_errors)`` lists."""
        _, begs, ends = self._gd(est0)
        return begs.cpu().tolist(), ends.cpu().tolist()

    def solve_gd_restarts(self, est0_batch):
        """Multi-restart GD: ``est0_batch`` is a pair of ``[B, n]`` starts,
        run as the rollout's batch axis (one forward and one backward launch
        per episode for all B). Returns ``(beg[B, E], end[B, E], best_est)``
        as numpy arrays and the best restart's final state."""
        ests, begs, ends = self._gd(est0_batch)
        begs, ends = begs.T.cpu().numpy(), ends.T.cpu().numpy()
        best = int(np.argmin(ends[:, -1]))
        return begs, ends, tuple(x[best] for x in ests)

    def solve_cma(self, est0):
        """CMA-ES; each generation is one batched evaluation."""
        lb, ub = self.bounds()
        es = CmaEs(flat(est0), self.cma_sigma, lower=flat(lb),
                   upper=flat(ub), seed=self.seed)

        def batch_objective(xs):
            with torch.no_grad():
                return self.end_error(self.split(xs), False).cpu().numpy()

        history, asked, _ = es.optimize(batch_objective, self.num_episode)
        with torch.no_grad():
            begs = self.state_error(self.true_state, self.split(asked))
        return begs.cpu().tolist(), history.tolist()

    def solve_scipy(self, est0, method: str):
        """Nelder-Mead / SLSQP on the forward loss; records the number of
        rollouts it ran in ``scipy_evaluations[method]``."""
        import scipy.optimize

        lb, ub = self.bounds()
        bounds = scipy.optimize.Bounds(flat(lb), flat(ub))
        beg_errors, end_errors = [], []

        def fun(v):
            est = self.split(v)
            with torch.no_grad():
                e = float(self.end_error(est, False))
            beg_errors.append(self.beg_error(est))
            end_errors.append(e)
            return e

        scipy.optimize.minimize(fun, flat(est0), bounds=bounds, method=method,
                                options={"maxiter": self.num_episode + 1})
        self.scipy_evaluations[method] = len(end_errors)
        # an early termination (SLSQP with a zero finite-difference
        # gradient) is padded with the last value
        while len(end_errors) < self.num_episode:
            beg_errors.append(beg_errors[-1])
            end_errors.append(end_errors[-1])
        return (beg_errors[: self.num_episode],
                end_errors[: self.num_episode])

    # -- evaluation loop --------------------------------------------------

    METHODS = ("gd", "cma-es", "nelder-mead", "slsqp")

    def evaluate(self, methods=METHODS, verbose=True):
        """Run all trials x methods, log per-episode errors, render graphs."""
        all_beg = {m: [] for m in methods}
        all_end = {m: [] for m in methods}
        rng = np.random.default_rng(self.seed)

        for trial in range(self.num_trial):
            if verbose:
                print(f"Trial # {trial}")
            self.initialize(rng)
            est0 = tuple(self.tensor(x) for x in
                         self.random_initial_state(rng))

            for m in methods:
                if m == "gd":
                    beg, end = self.solve_gd(est0)
                elif m == "cma-es":
                    beg, end = self.solve_cma(est0)
                elif m == "nelder-mead":
                    beg, end = self.solve_scipy(est0, "Nelder-Mead")
                elif m == "slsqp":
                    beg, end = self.solve_scipy(est0, "SLSQP")
                else:
                    raise ValueError(m)
                if verbose:
                    print(f"  {m}: ep {self.num_episode - 1} err "
                          f"{end[-1]:.6g}")
                all_beg[m].append(beg)
                all_end[m].append(end)
                mdir = os.path.join(self.log_dir, m)
                os.makedirs(mdir, exist_ok=True)
                with open(os.path.join(mdir, f"trial_{trial}.txt"), "w") as f:
                    for b, e in zip(beg, end):
                        f.write(f"{b} {e}\n")

        self.render_graph(os.path.join(self.log_dir,
                                       "beg_optimization_graph.png"), all_beg)
        self.render_graph(os.path.join(self.log_dir,
                                       "end_optimization_graph.png"), all_end)
        return all_beg, all_end

    @staticmethod
    def render_graph(path, errors_by_method):
        """Mean +- std log-scale convergence plot; skipped without
        matplotlib."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        labels = {"gd": "Ours", "cma-es": "CMAES",
                  "nelder-mead": "Nelder-Mead", "slsqp": "SLSQP"}
        plt.figure(figsize=(10, 7))
        for m, runs in errors_by_method.items():
            if not runs:
                continue
            arr = np.asarray(runs)
            x = np.arange(1, arr.shape[1] + 1)
            mean, std = arr.mean(0), arr.std(0)
            plt.plot(x, mean, label=labels.get(m, m), linewidth=2.5)
            plt.fill_between(x, np.maximum(mean - std, mean / 3.0),
                             mean + std, alpha=0.2)
        plt.yscale("log")
        plt.xlabel("Episode")
        plt.ylabel("Loss")
        plt.legend()
        plt.grid(alpha=0.3)
        plt.savefig(path, dpi=110, bbox_inches="tight")
        plt.close()
