"""The port's action gradients against :mod:`dhts`, in ``soft`` and
straight-through (``st``) gate mode.

Scene: the 3x3 hybrid emission config of ``test_itscp_hybrid_fused.py``
(T = 160, ``random_seed=3``). Both envs reset with the same seed; the port
gets the JAX env's ``rand[T, L]`` as numpy. Tolerance, the JAX package's
own fused-vs-scan standard (``tests/test_itscp_hybrid_fused.py:89-91``):
cosine > 0.999 and ``allclose(rtol=2e-2, atol=2e-3 * max|g_ref|)``, finite
and nonzero.

* the port's eager episode (autograd) against ``jax.grad`` of the scan env;
* K1's plain pair (``make_fused_itscp_episode(differentiable=True)`` on the
  CPU: the plain forward and autograd through it) against the JAX fused
  kernel's gradient in interpret mode.

In ``st`` mode the forward values are the hard gates' and the gradients
come from soft gates saturated at the clip bound (``sigmoid'(16)``), so
they are small. Before the clip-tie repair the port's ``st`` gradient was
2.000x JAX's.

Both modes are also held at every one of fourteen action draws
(``default_rng(0)`` to ``default_rng(13)``). In ``st`` mode the reference
for these is JAX's gradient with the acceleration floor's derivative
made exact: a vehicle stopped by the floor gets ``sp + dt * (-sp / dt)``,
which does not depend on ``sp``, but reverse mode returns ``g - (g * dt) /
dt``, a rounding residue of the incoming gradient ``g``. The port gives
that speed a zero gradient (``dhts_torch/ops/idm.py``); JAX's residue,
amplified by the soft queue gates, is as large as the whole
straight-through gradient and made 10 of the 14 draws miss the tolerance
(cosine down to 0.889). The test wraps ``dhts.ops.idm.euler_step`` while
it traces JAX's gradient, so that the new speed of a vehicle whose
acceleration equals the floor gets ``stop_gradient``; the values are
unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.apps.control.itscp import problem as jproblem
from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv
from dhts.ops.pallas import itscp_hybrid_episode as jk1
from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv

# small tensors: one intra-op thread is fastest and leaves the cores to
# the other test workers
torch.set_num_threads(1)

EMISSION_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                    speed_limit=20.0, cell_length=5.0, policy_length=16,
                    signal_length=2, simulation_frequency=10, random_seed=3,
                    max_num_micro_vehicle_per_lane=4, mode="hybrid")


def check_grad(got, ref):
    got, ref = np.asarray(got).ravel(), np.asarray(ref).ravel()
    assert np.all(np.isfinite(got)) and np.linalg.norm(got) > 0
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos > 0.999, (cos, got, ref)
    np.testing.assert_allclose(got, ref, rtol=2e-2,
                               atol=2e-3 * np.abs(ref).max())


@pytest.fixture(scope="module", params=["soft", "st"])
def case(request):
    cfg = dict(EMISSION_CFG, gate_mode=request.param)
    jenv = JaxEnv(config=cfg, schedule_fn=jproblem.problem_1)
    jenv.reset()
    key = jax.random.PRNGKey(0)
    rand = np.array(jax.random.uniform(key, (jenv.num_timestep,
                                               jenv.spec.num_lanes)))
    action = np.random.default_rng(1).uniform(
        0.3, 0.7, jenv.action_size()).astype(np.float32)
    g_ref = np.asarray(jax.grad(
        lambda a: jenv.episode(a, True, key).reward)(jnp.asarray(action)))
    return cfg, jenv, key, rand, action, g_ref


def port_grad(env, action, rand):
    a = torch.tensor(action, requires_grad=True)
    res = env.episode(a, True, rand=torch.as_tensor(rand))
    res.reward.backward()
    return a.grad.numpy()


def test_episode_gradient_matches_dhts(case):
    cfg, _, _, rand, action, g_ref = case
    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    check_grad(port_grad(env, action, rand), g_ref)


def test_fused_plain_pair_gradient_matches_jax_fused_kernel(case):
    cfg, jenv, key, rand, action, _ = case
    V = jenv.base_state.micro.position.shape[1]
    R = jenv.base_state.micro.route.shape[2]
    P = jenv.data.inj_routes.shape[1]
    P2 = jenv.base_state.route_pool.shape[1]
    fused = jk1.make_fused_itscp_episode(
        jenv.spec, jenv.meta, jenv.config, V, R, P, P2, differentiable=True,
        window=jenv._fused_win_needed, interpret=True)
    n_phases = cfg["policy_length"] // cfg["signal_length"]
    g_ref = np.asarray(jax.grad(lambda a: fused(
        a.reshape(n_phases, -1), jenv.data.schedule, jenv.data.mroute_next,
        jenv.data.mroute_prev, jnp.asarray(rand), jenv.data.inj_routes,
        jenv.base_state.route_pool)[0])(jnp.asarray(action)))
    env = ItscpEnv(config=dict(cfg, use_fused_episode=True),
                   schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    assert env.fused_plan(True).mode == (2 if cfg["gate_mode"] == "st"
                                         else 1)
    check_grad(port_grad(env, action, rand), g_ref)


DRAWS = range(14)


def _euler_step_exact_floor(position, speed, acceleration, delta_time):
    """``dhts.ops.idm.euler_step`` whose new speed has a zero gradient
    where the acceleration floor ``-speed / dt`` binds."""
    new_speed = speed + delta_time * acceleration
    stopped = acceleration == (-speed) / delta_time
    return (position + delta_time * speed,
            jnp.where(stopped, jax.lax.stop_gradient(new_speed), new_speed))


def draws_pair(mode):
    """``pair(seed) -> (port gradient, JAX gradient)`` at the action drawn
    from ``default_rng(seed)``, float64. In ``st`` mode JAX's gradient is
    traced and compiled with the exact floor derivative."""
    from dhts.ops import idm as jidm

    cfg = dict(EMISSION_CFG, gate_mode=mode)
    jenv = JaxEnv(config=cfg, schedule_fn=jproblem.problem_1)
    jenv.reset()
    key = jax.random.PRNGKey(0)
    rand = np.array(jax.random.uniform(key, (jenv.num_timestep,
                                               jenv.spec.num_lanes)))
    like = jnp.zeros(jenv.action_size(), jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        if mode == "st":
            mp.setattr(jidm, "euler_step", _euler_step_exact_floor)
        grad = jax.jit(jax.grad(lambda a: jenv.episode(a, True, key).reward)
                       ).lower(like).compile()
    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device="cpu")
    env.reset()

    def pair(seed):
        action = np.random.default_rng(seed).uniform(
            0.3, 0.7, jenv.action_size()).astype(np.float32)
        return (port_grad(env, action, rand).astype(np.float64),
                np.asarray(grad(jnp.asarray(action)), dtype=np.float64))

    return pair


@pytest.fixture(scope="module", params=["soft", "st"])
def draws(request):
    return draws_pair(request.param)


@pytest.mark.parametrize("seed", DRAWS)
def test_episode_gradient_matches_dhts_over_draws(draws, seed):
    got, ref = draws(seed)
    if not np.any(ref):
        # every straight-through path is clipped at this action
        np.testing.assert_array_equal(got, ref)
        return
    check_grad(got, ref)
