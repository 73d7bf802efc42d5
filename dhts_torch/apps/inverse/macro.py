"""Inverse problem: macroscopic single-lane initial-state estimation (port
of :mod:`dhts.apps.inverse.macro`).

One ARZ lane of ``n_cell`` cells between random fixed ghost cells; recover
the initial (density, speed) profile from the end-state profile after
``n_timestep`` steps. Defaults are the JAX CLI's (10 cells of 5 m, dt 0.01,
500 steps, 100 episodes, speed limit 30, Adam lr 1e-3).

Run on the card through kernel K2 (the whole rollout and its backward as
one launch each)::

    python -m dhts_torch.apps.inverse.macro --fused_rollout

``--device cpu`` runs the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from dhts_torch.apps.inverse.problem import InverseProblem, as_numpy
from dhts_torch.models import lane
from dhts_torch.ops import arz


class MacroInverseProblem(InverseProblem):

    batched = True

    def __init__(self, num_trial, num_timestep, num_episode, delta_time,
                 speed_limit, run_name, num_cell, cell_length,
                 fused_rollout: bool = False, **kw):
        super().__init__(num_trial, num_timestep, num_episode, delta_time,
                         speed_limit, run_name, **kw)
        self.num_cell = num_cell
        self.cell_length = cell_length
        # kernel K2: the whole T-step rollout and its backward as one launch
        # each, instead of the lane.macro_rollout loop
        self.fused_rollout = fused_rollout
        self._fused_cache = {}

    def build_scene(self, rng):
        # random boundary ghost cells
        self.bdry_r = rng.uniform(0.0, 1.0, 2).astype(np.float32)
        self.bdry_u = rng.uniform(0.0, self.speed_limit, 2).astype(np.float32)

    def random_initial_state(self, rng):
        n = self.num_cell
        if self.true_state is None:
            return (rng.uniform(0, 1, n).astype(np.float32),
                    rng.uniform(0, self.speed_limit, n).astype(np.float32))
        # a perturbation of the truth
        r = as_numpy(self.true_state[0]) + rng.normal(size=n) * 1e-2
        u = as_numpy(self.true_state[1]) + rng.normal(size=n) * 1e-2
        return (np.clip(r, 0, 1).astype(np.float32),
                np.clip(u, 0, self.speed_limit).astype(np.float32))

    def _fused(self, batch):
        if batch not in self._fused_cache:
            from dhts_torch.ops.cuda.macro_rollout import \
                make_fused_macro_rollout
            self._fused_cache[batch] = make_fused_macro_rollout(
                self.speed_limit, self.delta_time, self.cell_length,
                self.num_timestep, self.num_cell, batch, device=self.device)
        return self._fused_cache[batch]

    def end_state_of(self, est, differentiable):
        bl_r, br_r = self.bdry_r
        bl_u, br_u = self.bdry_u
        if self.fused_rollout:
            shape = est[0].shape
            r0 = est[0].reshape(-1, self.num_cell)
            y0 = arz.compute_y(r0, est[1].reshape(-1, self.num_cell),
                               self.speed_limit)
            rT, yT, _ = self._fused(r0.shape[0])(r0, y0, bl_r, bl_u, br_r,
                                                 br_u)
            uT = arz.compute_u(rT, yT, self.speed_limit)
            return rT.reshape(shape), uT.reshape(shape)
        res = lane.macro_rollout(est[0], est[1], bl_r, bl_u, br_r, br_u,
                                 self.speed_limit, self.delta_time,
                                 self.cell_length, self.num_timestep)
        return res.r, res.u

    def bounds(self):
        n = self.num_cell
        lb = (np.zeros(n, np.float32), np.zeros(n, np.float32))
        ub = (np.ones(n, np.float32),
              np.full(n, self.speed_limit, np.float32))
        return lb, ub


def build_parser():
    p = argparse.ArgumentParser(
        "Inverse problem: macroscopic traffic simulation, PyTorch/CUDA port")
    p.add_argument("--n_trial", type=int, default=5)
    p.add_argument("--n_cell", type=int, default=10)
    p.add_argument("--n_timestep", type=int, default=500)
    p.add_argument("--cell_length", type=float, default=5.0)
    p.add_argument("--speed_limit", type=float, default=30.0)
    p.add_argument("--delta_time", type=float, default=0.01)
    p.add_argument("--n_episode", type=int, default=100)
    p.add_argument("--methods", type=str,
                   default="gd,cma-es,nelder-mead,slsqp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--log_root", type=str, default="result/inverse_torch")
    p.add_argument("--fused_rollout", action="store_true",
                   help="the rollout and its backward through kernel K2")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    run = args.run_name or f"macro_{time.time():.0f}"
    prob = MacroInverseProblem(args.n_trial, args.n_timestep, args.n_episode,
                               args.delta_time, args.speed_limit, run,
                               args.n_cell, args.cell_length,
                               fused_rollout=args.fused_rollout,
                               seed=args.seed, log_root=args.log_root,
                               device=args.device)
    return prob.evaluate(methods=tuple(args.methods.split(",")))


if __name__ == "__main__":
    main()
