"""The port's ITSCP environment against :mod:`dhts.apps.control.itscp.env`.

Scene: the 3x3 hybrid emission config of ``test_itscp_hybrid_fused.py``
(T = 160, ``random_seed=3`` — a seed > 0, since seed 0 draws from an
unseeded generator and two envs would then see different scenarios), plus
one hard episode at the full ``run_itscp_hybrid.sh`` preset (T = 600,
144 lanes). Both envs reset with the same seed; the port gets the JAX
env's ``rand[T, L]`` as numpy.

Tolerances: reset data bit-equal; per-step events exact; reward rel 1e-4;
per-step queues abs 1e-4 (float32 sums over lanes in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.apps.control.itscp import problem as jproblem
from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv
from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv

# small tensors: one intra-op thread is fastest and leaves the cores to
# the other test workers
torch.set_num_threads(1)

EMISSION_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                    speed_limit=20.0, cell_length=5.0, policy_length=16,
                    signal_length=2, simulation_frequency=10, random_seed=3,
                    max_num_micro_vehicle_per_lane=4, mode="hybrid")
PRESET_CFG = dict(num_intersection=3, num_lane=1, lane_length=5,
                  speed_limit=60, policy_length=20, signal_length=4,
                  mode="hybrid", random_seed=3)


@pytest.fixture(scope="module")
def envs():
    jenv = JaxEnv(config=EMISSION_CFG, schedule_fn=jproblem.problem_1)
    jobs = jenv.reset()
    tenv = ItscpEnv(config=EMISSION_CFG, schedule_fn=problem.problem_1,
                    device="cpu")
    tobs = tenv.reset()
    key = jax.random.PRNGKey(0)
    rand = np.array(jax.random.uniform(key, (jenv.num_timestep,
                                               jenv.spec.num_lanes)))
    return jenv, tenv, jobs, tobs, key, rand


def test_reset_data_bit_equal(envs):
    jenv, tenv, jobs, tobs, _, _ = envs
    np.testing.assert_array_equal(tobs, jobs)
    for name in ("schedule", "mroute_next", "mroute_prev", "inj_routes"):
        np.testing.assert_array_equal(getattr(tenv.data, name).numpy(),
                                      np.asarray(getattr(jenv.data, name)),
                                      name)
    np.testing.assert_array_equal(tenv.base_state.route_pool.numpy(),
                                  np.asarray(jenv.base_state.route_pool))
    for name in ("is_macro", "length", "num_cell", "cell_length", "cell_mask",
                 "next_lanes", "prev_lanes", "num_next", "num_prev"):
        np.testing.assert_array_equal(getattr(tenv.spec, name).numpy(),
                                      np.asarray(getattr(jenv.spec, name)),
                                      name)
    for name in ("approaching", "is_we", "inter", "has_prev"):
        np.testing.assert_array_equal(getattr(tenv.meta, name).numpy(),
                                      np.asarray(getattr(jenv.meta, name)),
                                      name)
    assert tenv.action_size() == jenv.action_size()
    assert tenv.observation_size() == jenv.observation_size()
    assert tenv.action_bounds() == jenv.action_bounds()
    assert tenv._fused_win_needed == jenv._fused_win_needed


def test_reset_with_new_seed_matches_dhts():
    """A second reset redraws the pools and the schedule in the same order."""
    jenv = JaxEnv(config=EMISSION_CFG, schedule_fn=jproblem.problem_2)
    tenv = ItscpEnv(config=EMISSION_CFG, schedule_fn=problem.problem_2,
                    device="cpu")
    for seed in (3, 11):
        np.testing.assert_array_equal(tenv.reset(seed), jenv.reset(seed))
        np.testing.assert_array_equal(tenv.data.mroute_next.numpy(),
                                      np.asarray(jenv.data.mroute_next))
        np.testing.assert_array_equal(tenv.base_state.route_pool.numpy(),
                                      np.asarray(jenv.base_state.route_pool))


def check_episode(ref, got):
    ev_ref = np.asarray(ref.events_per_step)
    ev = got.events_per_step.numpy()
    np.testing.assert_array_equal(ev, ev_ref)
    assert float(got.reward) == pytest.approx(float(ref.reward), rel=1e-4)
    np.testing.assert_allclose(got.queue_per_step.numpy(),
                               np.asarray(ref.queue_per_step), rtol=0,
                               atol=1e-4)
    assert int(got.emitted) == int(ref.emitted)
    assert int(got.absorbed) == int(ref.absorbed)
    assert int(got.injected) == int(ref.injected)
    assert float(got.max_wave_speed) == pytest.approx(
        float(ref.max_wave_speed), rel=1e-5)


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("a", [0.3, 0.6])
def test_episode_matches_dhts(envs, differentiable, a):
    jenv, tenv, _, _, key, rand = envs
    action = np.full(jenv.action_size(), a, np.float32)
    ref = jenv.episode(jnp.asarray(action), differentiable, key)
    got = tenv.episode(torch.as_tensor(action), differentiable,
                       rand=torch.as_tensor(rand))
    check_episode(ref, got)
    if a == 0.6:  # the scene is not vacuous: vehicles emitted and absorbed
        assert int(got.emitted) >= 2 and int(got.absorbed) >= 1


def test_episode_gradient_is_finite(envs):
    """The eager differentiable episode back-propagates (its gradient is
    held against dhts in test_torch_itscp_grad.py)."""
    _, tenv, _, _, _, rand = envs
    action = torch.full((tenv.action_size(),), 0.55, requires_grad=True)
    res = tenv.episode(action, True, rand=torch.as_tensor(rand))
    res.reward.backward()
    assert torch.isfinite(action.grad).all()
    assert float(action.grad.abs().sum()) > 0.0


def test_fused_episode_on_cpu_matches_dhts(envs):
    """``use_fused_episode`` on the CPU runs K1's plain version: the hard
    episode matches dhts, and the differentiable one's action gradient
    matches ``jax.grad`` of the dhts episode (cosine > 0.999,
    ``allclose(rtol=2e-2, atol=2e-3 * max|g|)``, soft gates)."""
    jenv, _, _, _, key, rand = envs
    tenv = ItscpEnv(config=dict(EMISSION_CFG, use_fused_episode=True),
                    schedule_fn=problem.problem_1, device="cpu")
    tenv.reset()
    action = np.full(jenv.action_size(), 0.6, np.float32)
    ref = jenv.episode(jnp.asarray(action), False, key)
    got = tenv.episode(torch.as_tensor(action), False,
                       rand=torch.as_tensor(rand))
    check_episode(ref, got)
    g_ref = np.asarray(jax.grad(lambda a: jenv.episode(a, True, key).reward)(
        jnp.asarray(action)))
    a = torch.tensor(action, requires_grad=True)
    res = tenv.episode(a, True, rand=torch.as_tensor(rand))
    res.reward.backward()
    g = a.grad.numpy()
    assert np.all(np.isfinite(g)) and np.linalg.norm(g) > 0
    cos = float(g @ g_ref / (np.linalg.norm(g) * np.linalg.norm(g_ref)))
    assert cos > 0.999
    np.testing.assert_allclose(g, g_ref, rtol=2e-2,
                               atol=2e-3 * np.abs(g_ref).max())


def test_full_preset_hard_episode_matches_dhts():
    """run_itscp_hybrid.sh's 3x3 hybrid preset: 144 lanes, T = 600."""
    jenv = JaxEnv(config=PRESET_CFG, schedule_fn=jproblem.problem_1)
    jenv.reset()
    tenv = ItscpEnv(config=PRESET_CFG, schedule_fn=problem.problem_1,
                    device="cpu")
    tenv.reset()
    assert tenv.spec.num_lanes == 144 and tenv.num_timestep == 600
    assert int(tenv.spec.is_macro.sum()) == 128
    assert tenv.action_size() == 45 and tenv.observation_size() == 1440
    key = jax.random.PRNGKey(1)
    rand = np.array(jax.random.uniform(key, (600, 144)))
    action = np.full(jenv.action_size(), 0.7, np.float32)
    ref = jenv.episode(jnp.asarray(action), False, key)
    got = tenv.episode(torch.as_tensor(action), False,
                       rand=torch.as_tensor(rand))
    check_episode(ref, got)
    assert int(got.emitted) >= 1


def test_generator_draw_is_reproducible(envs):
    _, tenv, _, _, _, _ = envs
    action = torch.full((tenv.action_size(),), 0.5)
    runs = [tenv.episode(action, False,
                         generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert float(runs[0].reward) == float(runs[1].reward)
    assert torch.equal(runs[0].events_per_step, runs[1].events_per_step)
