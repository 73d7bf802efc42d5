"""Kernel K1 with an episode axis on the card (skipped without a CUDA
device): one launch of B = 3 episodes against three launches of one
episode, bit for bit (reward, queues, all eight event rows, the backward's
gradients), for three scenarios of ``reset_batch(3, seed=11)`` and for
E = 3 draws of one scene (scene data and action shared). The draws case
runs an all-micro grid whose open boundaries inject by the draws. A train
step of E episodes with one shared action is one forward and one backward
launch, and its gradient is the sum of the episodes'. This file imports
nothing of JAX::

    python -m pytest --noconftest -q tests/test_torch_card_batch.py
"""

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

torch.set_num_threads(1)

EMISSION_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                    speed_limit=20.0, cell_length=5.0, policy_length=16,
                    signal_length=2, simulation_frequency=10, random_seed=3,
                    max_num_micro_vehicle_per_lane=4, mode="hybrid",
                    use_fused_episode=True)
MICRO_CFG = dict(num_intersection=2, num_lane=2, lane_length=20.0,
                 speed_limit=30.0, policy_length=8, signal_length=2,
                 simulation_frequency=10, random_seed=5, mode="micro",
                 use_fused_episode=True)
CFG = {"scenarios": EMISSION_CFG, "draws": MICRO_CFG}
B = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU path")
    return torch.device("cuda")


def batch_case(kind, dev, differentiable, gate_mode="soft"):
    cfg = CFG[kind]
    env = ItscpEnv(config=dict(cfg, gate_mode=gate_mode),
                   schedule_fn=problem.problem_1 if cfg["mode"] == "hybrid"
                   else problem.random_schedule, device=dev)
    lead = (B,) if kind == "scenarios" else ()
    if kind == "scenarios":
        env.reset_batch(B, seed=11)
        d = env.batch_data
    else:
        env.reset(seed=11)
        d = env.data
    action = torch.as_tensor(np.random.default_rng(4).uniform(0.2, 0.8, (
        *lead, env.n_phases, env.action_size() // env.n_phases)),
        dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    inputs = (action, d.schedule, d.mroute_next, d.mroute_prev, rand,
              d.inj_routes, env.base_state.route_pool)
    return env, env.fused_plan(differentiable), inputs


def row(plan, inputs, e):
    return tuple((x[e] if x.dim() == len(shape) + 1 else x).contiguous()
                 for x, (shape, _) in zip(inputs, k1._rows(plan)))


@pytest.mark.parametrize("kind", ["scenarios", "draws"])
@pytest.mark.parametrize("mode", ["hard", "soft", "st"])
def test_batched_forward_equals_single_launches(cuda, mode, kind):
    _, plan, inputs = batch_case(kind, cuda, mode != "hard",
                                 "st" if mode == "st" else "soft")
    before = k1.itscp_hybrid_episode_fwd.launches[plan.mode]
    reward, queues, events = k1.itscp_hybrid_episode_fwd(plan, *inputs)
    assert k1.itscp_hybrid_episode_fwd.launches[plan.mode] == before + 1
    assert events.shape == (B, plan.T, 8)
    for e in range(B):
        r, q, ev = k1.itscp_hybrid_episode_fwd(plan, *row(plan, inputs, e))
        assert torch.equal(reward[e], r), e
        assert torch.equal(queues[e], q), e
        assert torch.equal(events[e], ev), e
    assert len(set(reward.tolist())) == B
    assert float(events[..., 1:4].sum()) > 0


@pytest.mark.parametrize("kind", ["scenarios", "draws"])
def test_batched_backward_equals_single_launches(cuda, kind):
    _, plan, inputs = batch_case(kind, cuda, True)
    w = torch.as_tensor(np.random.default_rng(9).uniform(
        -1.0, 1.0, (B, plan.T)), dtype=torch.float32, device=cuda)
    before = k1.itscp_hybrid_episode_bwd.launches
    grad = k1.itscp_hybrid_episode_bwd(plan, w, *inputs)
    assert k1.itscp_hybrid_episode_bwd.launches == before + 1
    assert grad.shape == (B, plan.n_phases, plan.n_inter)
    for e in range(B):
        g = k1.itscp_hybrid_episode_bwd(plan, w[e].contiguous(),
                                        *row(plan, inputs, e))
        assert torch.equal(grad[e], g), e
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_shared_action_gradient_sums_the_episodes(cuda):
    env, _, inputs = batch_case("draws", cuda, True)
    one = env._fused_episode_one(True)
    action = inputs[0].reshape(-1).clone().requires_grad_(True)
    rand = inputs[4]
    fwd0 = k1.itscp_hybrid_episode_fwd.launches[k1.SOFT]
    bwd0 = k1.itscp_hybrid_episode_bwd.launches
    res = one(action, env.data, rand)
    torch.mean(res.reward).backward()
    assert k1.itscp_hybrid_episode_fwd.launches[k1.SOFT] == fwd0 + 1
    assert k1.itscp_hybrid_episode_bwd.launches == bwd0 + 1
    ref = torch.zeros_like(action)
    for e in range(B):
        a = action.detach().clone().requires_grad_(True)
        r = one(a, env.data, rand[e]).reward
        (r / B).backward()
        ref += a.grad
        assert float(r) == float(res.reward[e])
    torch.testing.assert_close(action.grad, ref, rtol=1e-6, atol=1e-9)
