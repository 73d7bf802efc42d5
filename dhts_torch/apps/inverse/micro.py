"""Inverse problem: microscopic platoon initial-state estimation (port of
:mod:`dhts.apps.inverse.micro`).

One unbounded micro lane of ``n_vehicle`` default IDM vehicles spaced about
four lengths apart behind the default virtual leader; recover the initial
(position, speed) from the end state. Defaults are the JAX CLI's (10
vehicles of 5 m, dt 0.01, 500 steps, 100 episodes, Adam lr 1e-2, each
position bounded to a window of two vehicle lengths).

Run on the card through kernel K3::

    python -m dhts_torch.apps.inverse.micro --fused_rollout

``--device cpu`` runs the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dhts_torch.apps.inverse.problem import InverseProblem, as_numpy
from dhts_torch.models import lane
from dhts_torch.models.network import (DEFAULT_HEAD_POSITION_DELTA,
                                       DEFAULT_HEAD_SPEED_DELTA)
from dhts_torch.models.vehicle import default_params


class MicroInverseProblem(InverseProblem):

    batched = True

    def __init__(self, num_trial, num_timestep, num_episode, delta_time,
                 speed_limit, run_name, num_vehicle, vehicle_length,
                 gd_lr=1e-2, fused_rollout: bool = False, **kw):
        super().__init__(num_trial, num_timestep, num_episode, delta_time,
                         speed_limit, run_name, gd_lr=gd_lr, **kw)
        self.num_vehicle = num_vehicle
        self.vehicle_length = vehicle_length
        self.params = default_params(speed_limit, (num_vehicle,),
                                     vehicle_length, device=self.device)
        self.active = torch.ones(num_vehicle, dtype=torch.bool,
                                 device=self.device)
        # kernel K3: the whole T-step rollout and its backward as one launch
        # each, instead of the lane.micro_rollout loop
        self.fused_rollout = fused_rollout
        self._fused_cache = {}

    def build_scene(self, rng):
        pass  # a single unbounded lane; nothing in the scene is random

    def random_initial_state(self, rng):
        n, vl = self.num_vehicle, self.vehicle_length
        if self.true_state is None:
            start = np.arange(n) * 4.0 * vl
            pos = start + rng.uniform(0, 1, n) * 2.0 * vl
            spd = (0.3 + 0.4 * rng.uniform(0, 1, n)) * self.speed_limit
            return pos.astype(np.float32), spd.astype(np.float32)
        lb, ub = self.bounds()
        pos = as_numpy(self.true_state[0]) + rng.normal(size=n) * 0.1 * vl
        spd = (as_numpy(self.true_state[1]) +
               rng.normal(size=n) * 1e-2 * self.speed_limit)
        return (np.clip(pos, lb[0], ub[0]).astype(np.float32),
                np.clip(spd, lb[1], ub[1]).astype(np.float32))

    def _fused(self, batch):
        if batch not in self._fused_cache:
            from dhts_torch.ops.cuda.micro_rollout import \
                make_fused_micro_rollout
            self._fused_cache[batch] = make_fused_micro_rollout(
                self.delta_time, self.num_timestep, self.num_vehicle, batch,
                self.params, DEFAULT_HEAD_POSITION_DELTA,
                DEFAULT_HEAD_SPEED_DELTA, device=self.device)
        return self._fused_cache[batch]

    def end_state_of(self, est, differentiable):
        if self.fused_rollout:
            shape = est[0].shape
            pos0 = est[0].reshape(-1, self.num_vehicle)
            pT, vT = self._fused(pos0.shape[0])(
                pos0, est[1].reshape(-1, self.num_vehicle))
            return pT.reshape(shape), vT.reshape(shape)
        res = lane.micro_rollout(est[0], est[1], self.params, self.active,
                                 DEFAULT_HEAD_POSITION_DELTA,
                                 DEFAULT_HEAD_SPEED_DELTA, self.delta_time,
                                 self.num_timestep)
        return res.position, res.speed

    def bounds(self):
        n, vl = self.num_vehicle, self.vehicle_length
        pos_lb = np.arange(n, dtype=np.float32) * np.float32(4.0 * vl)
        return ((pos_lb, np.zeros(n, np.float32)),
                (pos_lb + np.float32(2.0 * vl),
                 np.full(n, self.speed_limit, np.float32)))


def build_parser():
    p = argparse.ArgumentParser(
        "Inverse problem: microscopic traffic simulation, PyTorch/CUDA port")
    p.add_argument("--n_trial", type=int, default=5)
    p.add_argument("--n_vehicle", type=int, default=10)
    p.add_argument("--n_timestep", type=int, default=500)
    p.add_argument("--vehicle_length", type=float, default=5.0)
    p.add_argument("--speed_limit", type=float, default=30.0)
    p.add_argument("--delta_time", type=float, default=0.01)
    p.add_argument("--n_episode", type=int, default=100)
    p.add_argument("--methods", type=str,
                   default="gd,cma-es,nelder-mead,slsqp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--log_root", type=str, default="result/inverse_torch")
    p.add_argument("--fused_rollout", action="store_true",
                   help="the rollout and its backward through kernel K3")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    run = args.run_name or f"micro_{time.time():.0f}"
    prob = MicroInverseProblem(args.n_trial, args.n_timestep, args.n_episode,
                               args.delta_time, args.speed_limit, run,
                               args.n_vehicle, args.vehicle_length,
                               fused_rollout=args.fused_rollout,
                               seed=args.seed, log_root=args.log_root,
                               device=args.device)
    return prob.evaluate(methods=tuple(args.methods.split(",")))


if __name__ == "__main__":
    main()
