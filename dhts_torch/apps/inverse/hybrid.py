"""Inverse problem: hybrid macro -> micro -> macro chain (port of
:mod:`dhts.apps.inverse.hybrid`).

A three-lane chain (macro, micro, macro) with random external boundary
cells and a random MacroRoute; the optimized state is the first macro
lane's initial (density, speed), compared against its own end state after
``n_timestep`` steps. The rollout runs the whole hybrid machinery of
:func:`dhts_torch.models.network.network_step` (flux-capacitor emission
onto the micro lane, IDM transit, absorption into the third lane), eagerly,
one step at a time; no fused kernel covers it.

Run: ``python -m dhts_torch.apps.inverse.hybrid`` (``--device cpu`` on the
CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dhts_torch.apps.inverse.problem import InverseProblem, as_numpy
from dhts_torch.models import network, scene
from dhts_torch.ops import arz


class HybridInverseProblem(InverseProblem):

    def __init__(self, num_trial, num_timestep, num_episode, delta_time,
                 speed_limit, run_name, num_cell, cell_length, **kw):
        super().__init__(num_trial, num_timestep, num_episode, delta_time,
                         speed_limit, run_name, **kw)
        self.num_cell = num_cell
        self.cell_length = cell_length
        # (emitted, absorbed) vehicles of the last rollout
        self.conversions = (0, 0)

    def build_scene(self, rng):
        b = scene.SceneBuilder(self.speed_limit, max_vehicles_per_lane=32)
        lane_length = self.num_cell * self.cell_length
        l0 = b.add_macro_lane(lane_length, self.cell_length)
        l1 = b.add_micro_lane(lane_length)
        l2 = b.add_macro_lane(lane_length, self.cell_length)
        b.connect(l0, l1)
        b.connect(l1, l2)
        spec, state = b.build(rng, device=self.device)
        mnext, mprev = b.random_macro_route(rng)
        state = state._replace(
            macro_next=torch.as_tensor(mnext, device=self.device),
            macro_prev=torch.as_tensor(mprev, device=self.device))

        # random external boundary cells for both macro lanes
        bdry_r = rng.uniform(0, 1, 4).astype(np.float32)
        bdry_u = rng.uniform(0, self.speed_limit, 4).astype(np.float32)
        state = network.set_external_boundary(
            state, l0, left_r=bdry_r[0], left_u=bdry_u[0],
            right_r=bdry_r[1], right_u=bdry_u[1])
        state = network.set_external_boundary(
            state, l2, left_r=bdry_r[2], left_u=bdry_u[2],
            right_r=bdry_r[3], right_u=bdry_u[3])
        self.spec, self.base_state = spec, state

    def random_initial_state(self, rng):
        n = self.num_cell
        if self.true_state is None:
            return (rng.uniform(0, 1, n).astype(np.float32),
                    rng.uniform(0, self.speed_limit, n).astype(np.float32))
        r = as_numpy(self.true_state[0]) + rng.normal(size=n) * 1e-2
        u = as_numpy(self.true_state[1]) + rng.normal(size=n) * 1e-2
        return (np.clip(r, 0, 1).astype(np.float32),
                np.clip(u, 0, self.speed_limit).astype(np.float32))

    def end_state_of(self, est, differentiable):
        st = network.set_macro_lane_state(self.base_state, 0, est[0], est[1],
                                          self.spec)
        emitted = absorbed = 0
        for _ in range(self.num_timestep):
            st, diag = network.network_step(self.spec, st, self.delta_time,
                                            differentiable)
            emitted = emitted + diag.emitted
            absorbed = absorbed + diag.absorbed
        self.conversions = (emitted, absorbed)
        r = st.macro.r[0, : self.num_cell]
        y = st.macro.y[0, : self.num_cell]
        return r, arz.compute_u(r, y, self.speed_limit)

    def bounds(self):
        n = self.num_cell
        return ((np.zeros(n, np.float32), np.zeros(n, np.float32)),
                (np.ones(n, np.float32),
                 np.full(n, self.speed_limit, np.float32)))


def build_parser():
    p = argparse.ArgumentParser(
        "Inverse problem: hybrid traffic simulation, PyTorch/CUDA port")
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
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    run = args.run_name or f"hybrid_{time.time():.0f}"
    prob = HybridInverseProblem(args.n_trial, args.n_timestep,
                                args.n_episode, args.delta_time,
                                args.speed_limit, run, args.n_cell,
                                args.cell_length, seed=args.seed,
                                log_root=args.log_root, device=args.device)
    return prob.evaluate(methods=tuple(args.methods.split(",")))


if __name__ == "__main__":
    main()
