"""The lane-sharded step's B and D3 on the card (skipped without a CUDA
device): each lane its own signals in registers, the forward's counts by
a barrier's count. At the 3x3 hybrid preset of ``run_itscp_hybrid.sh`` (T
= 600, 144 lanes), S = 2 and 4, B = 1 and 4: every launch of every 25th
step and of each step that emits or deposits against its plain body
(hard and soft; integers equal, floats allclose(rtol 1e-6, atol 1e-6), as
``chip_smoke.py`` holds them: PyTorch's CUDA operators may round
otherwise), and the derivative's B and D3 at steps 7, 107, ... 507
against their plain bodies under forward-mode AD (values allclose(rtol
1e-6, atol 1e-6), tangents allclose(rtol 1e-5, atol 1e-5 times the
output's largest)); the 9x9 scene (1,296 lanes, T = 60; the derivative's
first 30 steps) at S = 4, every 10th step. This file imports nothing of
JAX::

    python -m pytest --noconftest -q tests/test_torch_card_shard_bd3.py
"""

import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from tests.test_torch_card_shard import NINE, PRESET, episode_inputs

torch.set_num_threads(1)


def card_env(cfg):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU path")
    e = ItscpEnv(config=cfg, schedule_fn=problem.problem_1,
                 device=torch.device("cuda"))
    e.reset(3)
    return e


def step_events(plan, inputs):
    """The steps at which the plain STEP episode emits or deposits."""
    _, ev, _ = k6.plain_spatial_episode(plan, *inputs)
    return set(torch.nonzero(ev[..., 1:].sum((0, 2))).flatten().tolist())


@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [2, 4])
def test_forward_b_d3_match_plain_bodies(S, B, mode):
    env = card_env(PRESET)
    plan = k6.make_plan(env, mode == "soft")
    inputs = episode_inputs(env, plan, B, 70 + B)
    marks = step_events(plan, inputs)
    assert marks, "nothing emitted or deposited"
    run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, S)),
                      inputs, dual=False)
    for t in range(plan.T):
        if t % 25 == 3 or t in marks:
            run.checked_step(t, 1e-6, 1e-6)
        else:
            run.step(t)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [2, 4])
def test_derivative_b_d3_match_plain_forward_mode(S, B):
    env = card_env(PRESET)
    plan = k6.make_plan(env, True)
    inputs = episode_inputs(env, plan, B, 80 + B)
    run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, S)),
                      inputs, dual=True)
    for t in range(plan.T):
        if t % 100 == 7:
            run.checked_dual_step(t, bodies=("B", "D3"),
                                  value_tol=(1e-6, 1e-6))
        else:
            run.step(t)
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", ["hard", "soft", "dual"])
def test_nine_by_nine_b_d3(mode):
    env = card_env(NINE)
    plan = k6.make_plan(env, mode != "hard")
    inputs = episode_inputs(env, plan, 1, 9)
    dual = mode == "dual"
    T = 30 if dual else 60
    plan = plan._replace(T=T)
    a, rand, sched, mnext, mprev, routes = inputs
    inputs = (a, rand[:, :T].contiguous(), sched[:T].contiguous(),
              mnext[:T].contiguous(), mprev[:T].contiguous(), routes)
    run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, 4)),
                      inputs, dual=dual)
    for t in range(plan.T):
        if t % 10 == 4 and dual:
            run.checked_dual_step(t, bodies=("B", "D3"),
                                  value_tol=(1e-6, 1e-6))
        elif t % 10 == 4:
            run.checked_step(t, 1e-6, 1e-6)
        else:
            run.step(t)
    torch.cuda.synchronize()
