"""The action gradient of the port's fused spatial episode (autograd of the
plain version on the CPU) against the JAX package, at the JAX package's
fused spatial standard (``tests/test_spatial_fused.py:64``): cosine >
0.99999, finite and nonzero.

* Against ``jax.grad`` of the scan env with ``dhts.ops.idm.euler_step``
  wrapped so that a speed stopped by the acceleration floor gets a zero
  gradient (the method of ``test_torch_itscp_grad.py``). A vehicle stopped
  by the floor gets ``sp + dt * (-sp / dt)``, which does not depend on
  ``sp``; the port gives it a zero gradient (``dhts_torch/ops/idm.py``),
  while JAX's reverse mode leaves a rounding residue that soft queue gates
  amplify. These draws hit the floor (asserted), so the wrapper matters.
* Against ``jax.grad`` of JAX's own fused spatial episode on a one-device
  mesh (Pallas in interpret mode). Its step computes ``vel + dt * acc``
  inline, out of the wrapper's reach, so it is held at a draw off the
  floor: the floor-hit count of that draw is asserted to be 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dhts.apps.control.itscp import problem as jproblem
from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv
from dhts.ops import idm as jidm
from dhts.ops.pallas.itscp_spatial_step import \
    make_fused_spatial_episode as jax_spatial_episode
from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from dhts_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

MICRO_CFG = dict(num_intersection=1, num_lane=2, lane_length=20.0,
                 speed_limit=20.0, cell_length=5.0, policy_length=4,
                 signal_length=2, simulation_frequency=10, random_seed=3,
                 max_num_micro_vehicle_per_lane=4, mode="micro")
HYBRID_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                  speed_limit=20.0, cell_length=5.0, policy_length=16,
                  signal_length=2, simulation_frequency=10, random_seed=3,
                  max_num_micro_vehicle_per_lane=4, mode="hybrid")


def _euler_step_exact_floor(position, speed, acceleration, delta_time):
    """``dhts.ops.idm.euler_step`` whose new speed has a zero gradient
    where the acceleration floor ``-speed / dt`` binds."""
    new_speed = speed + delta_time * acceleration
    stopped = acceleration == (-speed) / delta_time
    return (position + delta_time * speed,
            jnp.where(stopped, jax.lax.stop_gradient(new_speed), new_speed))


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def port_case(cfg, action, rand):
    """``(gradient, floor hits)`` of the port's spatial episode."""
    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    ep = k6.make_fused_spatial_episode(
        env, make_mesh({"data": 1, "lane": 1}, "cpu"), differentiable=True)
    a = torch.tensor(action, requires_grad=True)
    ep(a, torch.as_tensor(rand)).reward.backward()
    plan = ep.plan()
    d = env.data
    hits = k6.floor_hits(plan, a.detach().reshape(plan.n_phases, -1),
                         torch.as_tensor(rand)[None], d.schedule,
                         d.mroute_next, d.mroute_prev,
                         k6.route_table(d.inj_routes,
                                        env.base_state.route_pool))
    return a.grad.numpy(), int(hits)


def jax_setup(cfg):
    jenv = JaxEnv(config=cfg, schedule_fn=jproblem.problem_1)
    jenv.reset()
    key = jax.random.PRNGKey(0)
    rand = np.array(jax.random.uniform(key, (jenv.num_timestep,
                                             jenv.spec.num_lanes)))
    return jenv, key, rand


@pytest.mark.parametrize("cfg", [MICRO_CFG, HYBRID_CFG],
                         ids=["micro", "hybrid"])
def test_gradient_matches_floor_wrapped_jax_scan(cfg):
    jenv, key, rand = jax_setup(cfg)
    action = np.random.default_rng(1).uniform(
        0.3, 0.7, jenv.action_size()).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jidm, "euler_step", _euler_step_exact_floor)
        g_ref = np.asarray(jax.jit(jax.grad(
            lambda a: jenv.episode(a, True, key).reward))(
                jnp.asarray(action)))
    got, hits = port_case(cfg, action, rand)
    assert hits > 0
    assert np.all(np.isfinite(got)) and np.linalg.norm(got) > 0
    assert cosine(got, g_ref) > 0.99999, (got, g_ref)


def test_gradient_matches_jax_spatial_episode_off_the_floor():
    jenv, key, rand = jax_setup(HYBRID_CFG)
    action = np.random.default_rng(2).uniform(
        0.1, 0.15, jenv.action_size()).astype(np.float32)
    ep = jax_spatial_episode(jenv, Mesh(np.array(jax.devices()[:1]),
                                        ("lane",)), differentiable=True)
    g_ref = np.asarray(jax.grad(lambda a: ep(a, key).reward)(
        jnp.asarray(action)))
    got, hits = port_case(HYBRID_CFG, action, rand)
    assert hits == 0
    assert np.all(np.isfinite(got)) and np.linalg.norm(got) > 0
    assert cosine(got, g_ref) > 0.99999, (got, g_ref)
