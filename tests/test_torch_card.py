"""The port's CUDA kernels on the card (skipped without a CUDA device).

This file imports nothing of JAX, so it also runs on a machine that has
only PyTorch; there, skip the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -q tests/test_torch_card.py

Tolerances as in chip_smoke.py: events[T, 8] exact (the kernel repeats the
plain version's IEEE float32 ops), reward rel 1e-4, queues abs 1e-4; the
backward's gradient cosine > 0.999 and allclose(rtol 2e-2, atol 2e-3 *
max|g|) against autograd of the plain version.
"""

import json

import numpy as np
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
    return env, env.fused_plan(False)


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
    before = k1.itscp_hybrid_episode_fwd.launches[k1.HARD]
    kr, kq, ke = k1.itscp_hybrid_episode_fwd(plan, *inputs)
    pr, pq, pe = k1.plain_episode(plan, *inputs)
    torch.cuda.synchronize()
    assert k1.itscp_hybrid_episode_fwd.launches[k1.HARD] == before + 1
    assert torch.equal(ke, pe)
    assert float(kr) == pytest.approx(float(pr), rel=1e-4)
    assert float((kq - pq).abs().max()) <= 1e-4
    assert float(pe[:, :3].sum()) > 0  # events happened


def test_env_runs_on_the_card_by_default(cuda):
    env = ItscpEnv(config=EMISSION_CFG, schedule_fn=problem.problem_1)
    assert env.device.type == "cuda"
    env.reset()
    action = torch.full((env.action_size(),), 0.6, device=cuda)
    before = k1.itscp_hybrid_episode_fwd.launches[k1.HARD]
    res = env.episode(action, False, generator=torch.Generator(
        device=cuda).manual_seed(0))
    assert k1.itscp_hybrid_episode_fwd.launches[k1.HARD] == before + 1
    assert res.reward.device.type == "cuda"
    assert torch.isfinite(res.reward)
    # the differentiable episode runs K1's soft forward and its backward
    counts = (k1.itscp_hybrid_episode_fwd.launches[k1.SOFT],
              k1.itscp_hybrid_episode_bwd.launches)
    a = action.clone().requires_grad_(True)
    env.episode(a, True, generator=torch.Generator(
        device=cuda).manual_seed(0)).reward.backward()
    assert (k1.itscp_hybrid_episode_fwd.launches[k1.SOFT],
            k1.itscp_hybrid_episode_bwd.launches) == (counts[0] + 1,
                                                     counts[1] + 1)
    assert torch.isfinite(a.grad).all() and float(a.grad.norm()) > 0


@pytest.mark.parametrize("gate_mode", ["soft", "st"])
def test_soft_kernels_match_plain_version(cuda, gate_mode):
    """The soft/st forward (events exact, reward rel 1e-4, queues abs 1e-4)
    and the backward (cosine > 0.999, allclose(rtol 2e-2, atol 2e-3 *
    max|g|)) against the plain version and its autograd, on the card."""
    env = ItscpEnv(config=dict(EMISSION_CFG, gate_mode=gate_mode),
                   schedule_fn=problem.problem_1, device=cuda)
    env.reset()
    plan = env.fused_plan(True)
    inputs = list(inputs_for(env, 0.5, 3))
    # off the signal-progress grid, where the st gradient is not all zero
    action = np.random.default_rng(1).uniform(0.3, 0.7, env.action_size())
    inputs[0] = torch.as_tensor(action, dtype=torch.float32,
                                device=cuda).reshape(env.n_phases, -1)
    kr, kq, ke = k1.itscp_hybrid_episode_fwd(plan, *inputs)
    with torch.no_grad():
        pr, pq, pe = k1.plain_episode(plan, *inputs)
    assert torch.equal(ke, pe)
    assert float(kr) == pytest.approx(float(pr), rel=1e-4)
    assert float((kq - pq).abs().max()) <= 1e-4
    w = torch.full((plan.T,), -1.0, device=cuda)
    got = k1.itscp_hybrid_episode_bwd(plan, w, *inputs).double().flatten()
    ref = k1.plain_episode_bwd(plan, w, *inputs).double().flatten()
    assert torch.isfinite(got).all() and float(got.norm()) > 0
    assert float(got @ ref / (got.norm() * ref.norm())) > 0.999
    assert torch.allclose(got, ref, rtol=2e-2,
                          atol=2e-3 * float(ref.abs().max()))


@pytest.mark.parametrize("signal_length", [2, 8])
@pytest.mark.parametrize("a", [0.45, 0.5, 0.55])
def test_st_gradient_on_the_progress_grid_matches_plain_version(
        cuda, a, signal_length):
    """A constant action on the signal-progress grid: at the tied step
    both hard gates of an intersection are red. The backward's gradient
    equals autograd of the plain version to allclose(rtol 2e-2, atol 2e-3
    * max|g|), so it is exactly 0 where the plain one is, with cosine >
    0.999 where the plain one is nonzero. On the CPU, at signal_length 2
    (progress k / 20) the plain gradient is 0 at these points, at 8
    (k / 80) it is not. Prints both norms (``pytest -s``)."""
    env = ItscpEnv(config=dict(EMISSION_CFG, gate_mode="st",
                               signal_length=signal_length),
                   schedule_fn=problem.problem_1, device=cuda)
    env.reset()
    plan = env.fused_plan(True)
    inputs = inputs_for(env, a, 3)
    assert bool((plan.prog == inputs[0][0, 0]).any())  # a grid point
    w = torch.full((plan.T,), -1.0, device=cuda)
    got = k1.itscp_hybrid_episode_bwd(plan, w, *inputs).double().flatten()
    ref = k1.plain_episode_bwd(plan, w, *inputs).double().flatten()
    print(json.dumps({"st_on_grid": a, "signal_length": signal_length,
                      "kernel_norm": float(got.norm()),
                      "plain_norm": float(ref.norm()),
                      "max_abs_diff": float((got - ref).abs().max())}))
    assert torch.isfinite(got).all()
    assert torch.allclose(got, ref, rtol=2e-2,
                          atol=2e-3 * float(ref.abs().max()))
    if float(ref.norm()) > 0:
        assert float(got @ ref / (got.norm() * ref.norm())) > 0.999


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
