"""The port's CUDA kernel on the card (skipped without a CUDA device).

This file imports nothing of JAX, so it also runs on a machine that has
only PyTorch; there, skip the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_card.py

Tolerances as in chip_smoke.py: events[T, 8] exact (the kernel repeats the
plain version's IEEE float32 ops), reward rel 1e-4, queues abs 1e-4.
"""

import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

# small tensors: one intra-op thread is fastest and leaves the cores to
# the other test workers
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU path")
    return torch.device("cuda")


def card_env(cfg, dev, schedule_fn=problem.problem_1):
    env = ItscpEnv(config=cfg, schedule_fn=schedule_fn, device=dev)
    env.reset()
    env._fused_episode_one(False)
    return env, env._fused[0].plan


def inputs_for(env, a, seed):
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    rand = env.draw_rand(gen)
    action = torch.full((env.action_size(),), a, device=env.device)
    return (action.reshape(env.n_phases, -1).contiguous(), env.data.schedule,
            env.data.mroute_next, env.data.mroute_prev, rand,
            env.data.inj_routes, env.base_state.route_pool)


@pytest.mark.parametrize("cfg,a", [(EMISSION_CFG, 0.6), (MICRO_CFG, 0.5)],
                         ids=["hybrid", "micro"])
def test_kernel_matches_plain_version(cuda, cfg, a):
    env, plan = card_env(cfg, cuda, problem.problem_1 if cfg is EMISSION_CFG
                         else problem.random_schedule)
    inputs = inputs_for(env, a, 3)
    before = k1.itscp_hybrid_episode_fwd.launches
    kr, kq, ke = k1.itscp_hybrid_episode_fwd(plan, *inputs)
    pr, pq, pe = k1.plain_episode(plan, *inputs)
    torch.cuda.synchronize()
    assert k1.itscp_hybrid_episode_fwd.launches == before + 1
    assert torch.equal(ke, pe)
    assert float(kr) == pytest.approx(float(pr), rel=1e-4)
    assert float((kq - pq).abs().max()) <= 1e-4
    assert float(pe[:, :3].sum()) > 0  # events happened


def test_env_runs_on_the_card_by_default(cuda):
    env = ItscpEnv(config=EMISSION_CFG, schedule_fn=problem.problem_1)
    assert env.device.type == "cuda"
    env.reset()
    action = torch.full((env.action_size(),), 0.6, device=cuda)
    before = k1.itscp_hybrid_episode_fwd.launches
    res = env.episode(action, False, generator=torch.Generator(
        device=cuda).manual_seed(0))
    assert k1.itscp_hybrid_episode_fwd.launches == before + 1
    assert res.reward.device.type == "cuda"
    assert torch.isfinite(res.reward)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        env.episode(action, True)


def test_wrapper_rejects_bad_inputs_on_the_card(cuda):
    env, plan = card_env(EMISSION_CFG, cuda)
    inputs = list(inputs_for(env, 0.5, 0))
    bad = list(inputs)
    bad[1] = inputs[1].double()
    with pytest.raises(TypeError):
        k1.itscp_hybrid_episode_fwd(plan, *bad)
    bad = list(inputs)
    bad[4] = inputs[4].cpu()
    with pytest.raises(ValueError):
        k1.itscp_hybrid_episode_fwd(plan, *bad)
    bad = list(inputs)
    bad[2] = inputs[2][:, :-1]
    with pytest.raises(ValueError):
        k1.itscp_hybrid_episode_fwd(plan, *bad)
