"""The next step's A rows that the lane-sharded step's D3 launch writes, on
the card (skipped without a CUDA device), against ``plain_body_A`` on
``plain_body_D``'s carry with the next step's draws and schedule.

* At the 3x3 hybrid preset of ``run_itscp_hybrid.sh`` (T = 600, 144
  lanes), S = 2 and 4, B = 1 and 4, hard and soft: every launch of every
  100th step, of the last but one and of the last step
  (``ShardRun.checked_step``: D3's carry, static terms, counts and next
  A rows, and every other launch's outputs; integers equal, floats
  allclose(rtol 1e-6, atol 1e-6), as ``chip_smoke.py`` holds them:
  PyTorch's CUDA operators may round otherwise); A launched once an
  episode and shard, B, C, D3 and E once a step; the episode's queues,
  events and waves equal to the single-shard STEP kernel's.
* The derivative (``Dual``) at S = 2 and 4, B = 1 and 4: D3 at every
  150th step and the last but one under forward-mode AD (values
  allclose(rtol 1e-6, atol 1e-6), tangents allclose(rtol 1e-5, atol
  1e-5 times the output's largest)); the gradient equal to the STEP
  derivative's.
* The 9x9 scene (1,296 lanes, T = 60; the derivative's first 30 steps) at
  S = 4, hard, soft and ``Dual``, every 10th step and the last but one.

This file imports nothing of JAX::

    python -m pytest --noconftest -q tests/test_torch_card_shard_next_a.py
"""

import pytest
import torch

from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from tests.test_torch_card_shard import (NINE, PRESET, episode_inputs,
                                         step_kernel_episode)
from tests.test_torch_card_shard_bd3 import card_env

torch.set_num_threads(1)


def sharded(plan, inputs, S, dual):
    return ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, S)),
                       inputs, dual=dual)


@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [2, 4])
def test_forward_next_rows_match_plain(S, B, mode):
    env = card_env(PRESET)
    plan = k6.make_plan(env, mode == "soft")
    inputs = episode_inputs(env, plan, B, 110 + B)
    run = sharded(plan, inputs, S, False)
    before = dict(ks.launches)
    T = plan.T
    for t in range(T):
        if t % 100 == 41 or t >= T - 2:
            run.checked_step(t, 1e-6, 1e-6)
        else:
            run.step(t)
    got = run.outputs()
    launched = {k: ks.launches[k] - before[k] for k in before}
    assert launched["A"] == S
    assert all(launched[b] == S * T for b in ks.EVERY_STEP)
    ref = step_kernel_episode(plan, inputs, B)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [2, 4])
def test_derivative_next_rows_match_plain_forward_mode(S, B):
    env = card_env(PRESET)
    plan = k6.make_plan(env, True)
    inputs = episode_inputs(env, plan, B, 120 + B)
    run = sharded(plan, inputs, S, True)
    for t in range(plan.T):
        if t % 150 == 41 or t == plan.T - 2:
            errs = run.checked_dual_step(t, ("D3",), value_tol=(1e-6, 1e-6))
            assert "D3" in errs
        else:
            run.step(t)
    w = torch.full((B, plan.T), -1.0, device=env.device)
    got = run.gradient(w)
    ref = k6.spatial_episode_bwd(plan, w, *inputs)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("mode", ["hard", "soft", "dual"])
def test_nine_by_nine_next_rows(mode):
    env = card_env(NINE)
    plan = k6.make_plan(env, mode != "hard")
    inputs = episode_inputs(env, plan, 1, 19)
    dual = mode == "dual"
    T = 30 if dual else 60
    plan = plan._replace(T=T)
    a, rand, sched, mnext, mprev, routes = inputs
    inputs = (a, rand[:, :T].contiguous(), sched[:T].contiguous(),
              mnext[:T].contiguous(), mprev[:T].contiguous(), routes)
    run = sharded(plan, inputs, 4, dual)
    for t in range(T):
        if (t % 10 == 5 or t == T - 2) and dual:
            run.checked_dual_step(t, ("D3",), value_tol=(1e-6, 1e-6))
        elif t % 10 == 5 or t == T - 2:
            run.checked_step(t, 1e-6, 1e-6)
        else:
            run.step(t)
    torch.cuda.synchronize()
