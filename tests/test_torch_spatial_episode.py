"""The port's fused spatial episode (the plain version on the CPU, through
``make_fused_spatial_episode`` on a one-device mesh) against the JAX
package's scan episode and against the port's K1 episode, on the same
draws.

* Against ``dhts``'s ``env.episode`` (the parity root of the JAX spatial
  tests) at the JAX package's own standard for its fused spatial episode
  (``tests/test_spatial_fused.py:41-71``): reward rtol 1e-5 / atol 1e-6,
  queues per step rtol 1e-4 / atol 1e-6, injected, emitted and absorbed
  totals equal.
* Against the port's K1 plain episode (the fused whole-episode kernel's
  specification, built on the scan env): per-step injected, emitted and
  absorbed equal, reward rel 1e-5, queues abs 1e-4 (the spatial step sums
  its running means once per step; K1 folds the static one in two parts).

Hard and soft, on the micro and the 3x3 hybrid scene of the JAX spatial
tests; the hybrid scene must emit vehicles. Both envs reset with seed 3;
the port takes JAX's draw ``uniform(PRNGKey(0), (T, L))``.
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


@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
@pytest.mark.parametrize("cfg", [MICRO_CFG, HYBRID_CFG],
                         ids=["micro", "hybrid"])
def test_episode_matches_jax_scan_and_k1(cfg, differentiable):
    jenv = JaxEnv(config=cfg, schedule_fn=jproblem.problem_1)
    jenv.reset()
    key = jax.random.PRNGKey(0)
    action = np.full(jenv.action_size(), 0.45, np.float32)
    ref = jenv.episode(jnp.asarray(action), differentiable, key)
    rand = torch.as_tensor(np.array(jax.random.uniform(
        key, (jenv.num_timestep, jenv.spec.num_lanes))))

    env = ItscpEnv(config=dict(cfg, use_fused_episode=True),
                   schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    ep = k6.make_fused_spatial_episode(
        env, make_mesh({"data": 1, "lane": 1}, "cpu"),
        differentiable=differentiable)
    with torch.no_grad():
        res = ep(torch.as_tensor(action), rand)
    np.testing.assert_allclose(float(res.reward), float(ref.reward),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.queue_per_step.numpy(),
                               np.asarray(ref.queue_per_step), rtol=1e-4,
                               atol=1e-6)
    for name in ("injected", "emitted", "absorbed"):
        assert int(getattr(res, name)) == int(getattr(ref, name)), name
    if cfg is HYBRID_CFG:
        assert int(res.emitted) > 0
    else:
        assert int(res.injected) > 0

    with torch.no_grad():
        k1 = env.episode(torch.as_tensor(action), differentiable, rand=rand)
    assert torch.equal(res.events_per_step, k1.events_per_step)
    assert float(res.reward) == pytest.approx(float(k1.reward), rel=1e-5)
    assert float((res.queue_per_step - k1.queue_per_step).abs().max()) \
        <= 1e-4


def test_batch_of_episodes_is_the_episodes_one_by_one():
    env = ItscpEnv(config=HYBRID_CFG, schedule_fn=problem.problem_1,
                   device="cpu")
    env.reset()
    ep = k6.make_fused_spatial_episode(
        env, make_mesh({"data": 1, "lane": 1}, "cpu"), differentiable=True)
    gen = torch.Generator().manual_seed(5)
    rand = torch.stack([env.draw_rand(gen) for _ in range(3)])
    action = torch.full((env.action_size(),), 0.55)
    with torch.no_grad():
        batch = ep(action, rand)
        for b in range(3):
            one = ep(action, rand[b])
            assert torch.equal(batch.queue_per_step[b], one.queue_per_step)
            assert torch.equal(batch.events_per_step[b],
                               one.events_per_step)
