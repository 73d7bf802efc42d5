"""The fused spatial step kernels (K6's STEP body, K5's forward and
derivative) on the card against their plain PyTorch versions and against
kernel K1 (skipped without a CUDA device), at the 3x3 hybrid preset of
``run_itscp_hybrid.sh`` (144 lanes, T = 600 steps at 30 Hz, 45 actions).

* Forward, hard and soft, B = 1 and 4 episodes per launch with their own
  draws: at every 50th step the kernel's carry goes through one plain step
  on the card and one kernel step; integers equal, floats allclose(rtol
  1e-6, atol 1e-6) (the same float32 operations; lane sums in float64
  rounded once on both sides).
* The whole episode against K1 on the same draws: reward rel 1e-5, queues
  abs 1e-4, per-step injected/emitted/absorbed equal, emitted > 0.
* Derivative: against autograd of the plain episode over the first 60 steps
  (cosine > 0.9999, allclose(rtol 2e-2, atol 2e-3 max|g|), the JAX
  package's fused-vs-scan standard), and against K1's backward at T = 600,
  cosine > 0.99999; finite.

This file imports nothing of JAX::

    python -m pytest --noconftest -q tests/test_torch_card_spatial.py
"""

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1
from dhts_torch.ops.cuda import itscp_spatial_step as k6

torch.set_num_threads(1)

PRESET = dict(num_intersection=3, num_lane=1, lane_length=5, speed_limit=60,
              policy_length=20, signal_length=4, simulation_frequency=30,
              mode="hybrid", random_seed=3)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def env(cuda):
    e = ItscpEnv(config=PRESET, schedule_fn=problem.problem_1, device=cuda)
    e.reset()
    return e


def inputs_of(env, B, seed, action=0.55):
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    if np.isscalar(action):
        action = np.full(env.action_size(), action)
    a = torch.as_tensor(action, dtype=torch.float32, device=env.device)
    d = env.data
    return (a.reshape(env.n_phases, -1).contiguous(), rand, d.schedule,
            d.mroute_next, d.mroute_prev,
            k6.route_table(d.inj_routes, env.base_state.route_pool))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
def test_forward_matches_plain_step(env, differentiable, B):
    plan = k6.make_plan(env, differentiable)
    ins = inputs_of(env, B, 11 + B)
    dev = env.device
    fb, ib = k6.empty_state(plan, B, dev)
    q = torch.zeros((B, plan.T), device=dev)
    ev = torch.zeros((B, plan.T, 3), dtype=torch.int32, device=dev)
    w = torch.zeros((B, plan.T), device=dev)
    g = k6.geometry(plan, dev)
    for t in range(plan.T):
        check = t % 50 == 0
        if check:
            carry, sg, ss = k6.unpack(plan, fb, ib)
            carry = tuple(x.clone() for x in carry)
            sg, ss = sg.clone(), ss.clone()
        k6.spatial_step_fwd(plan, fb, ib, t, 1, ins, q, ev, w)
        if check:
            out = k6.plain_spatial_step(plan, carry, sg, ss, t, ins[0],
                                        ins[1][:, t], ins[2][t], ins[3][t],
                                        ins[4][t], ins[5], g)
            f2, i2 = k6.pack(plan, out.carry, out.sg_ms, out.ss_ms)
            assert torch.equal(i2, ib), t
            torch.testing.assert_close(f2, fb, rtol=1e-6, atol=1e-6)
            assert torch.equal(out.events, ev[:, t]), t
            torch.testing.assert_close(out.queue, q[:, t], rtol=1e-6,
                                       atol=1e-6)
    assert torch.isfinite(q).all()


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
def test_episode_matches_k1(env, differentiable, B):
    plan = k6.make_plan(env, differentiable)
    ins = inputs_of(env, B, 21 + B)
    queues, events, _ = k6.spatial_episode_fwd(plan, *ins)
    p1 = env.fused_plan(differentiable)
    for b in range(B):
        reward, q1, e1 = k1.itscp_hybrid_episode_fwd(
            p1, ins[0], ins[2], ins[3], ins[4], ins[1][b],
            env.data.inj_routes, env.base_state.route_pool)
        assert torch.equal(events[b].float(), e1[:, :3]), b
        assert float(-queues[b].sum()) == pytest.approx(float(reward),
                                                        rel=1e-5)
        assert float((queues[b] - q1).abs().max()) <= 1e-4
    assert int(events[..., 1].sum()) > 0


def test_derivative_matches_autograd_over_60_steps(env):
    plan = k6.make_plan(env, True)._replace(T=60)
    rng = np.random.default_rng(3)
    ins = list(inputs_of(env, 2, 31, rng.uniform(0.3, 0.7,
                                                 env.action_size())))
    ins[1] = ins[1][:, :60].contiguous()
    ins[2:5] = [x[:60].contiguous() for x in ins[2:5]]
    w = torch.as_tensor(rng.uniform(-1, 1, (2, 60)), dtype=torch.float32,
                        device=env.device)
    got = k6.spatial_episode_bwd(plan, w, *ins).double().flatten()
    ref = k6.plain_spatial_episode_bwd(plan, w, *ins).double().flatten()
    assert torch.isfinite(got).all() and got.norm() > 0
    assert float(got @ ref / (got.norm() * ref.norm())) > 0.9999
    torch.testing.assert_close(got, ref, rtol=2e-2,
                               atol=2e-3 * float(ref.abs().max()))


def test_derivative_matches_k1_backward(env):
    plan = k6.make_plan(env, True)
    rng = np.random.default_rng(4)
    ins = inputs_of(env, 1, 41, rng.uniform(0.3, 0.7, env.action_size()))
    w = torch.full((1, plan.T), -1.0, device=env.device)
    got = k6.spatial_episode_bwd(plan, w, *ins).double().flatten()
    ref = k1.itscp_hybrid_episode_bwd(
        env.fused_plan(True), w[0], ins[0], ins[2], ins[3], ins[4],
        ins[1][0], env.data.inj_routes,
        env.base_state.route_pool).double().flatten()
    assert torch.isfinite(got).all() and got.norm() > 0
    assert float(got @ ref / (got.norm() * ref.norm())) > 0.99999
