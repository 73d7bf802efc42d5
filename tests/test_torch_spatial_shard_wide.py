"""The lane-sharded step on a scene wider than one block: the 9x9 hybrid
grid (1,296 lanes) of the JAX package's sharded test
(``tests/test_spatial_fused.py::test_hybrid_9x9_sharded_short_horizon``:
policy_length 2, T = 20 steps, 81 actions), which runs only on this path.
Each body runs one thread per *local* lane, so the cap of 1,024 threads a
block holds applies to a shard, not to the scene.

* The sharded episode at S = 4 (324 lanes a shard) in four gloo processes
  (``dhts_torch.parallel.local_ranks``; the plain bodies on the CPU),
  hard and soft, against JAX's scan env of the same scene on the same
  draw (``uniform(PRNGKey(0), (T, L))``), to the tolerances of JAX's
  ``_check``: reward rtol 1e-5 (atol 1e-6), queues rtol 1e-4 (atol
  1e-6), injected, emitted and absorbed counts equal; and against the
  port's scan env to the same tolerances and the largest wave speed rtol
  1e-5. At this horizon no vehicle converts yet: the soft episode's
  queue gates and the waves carry the check.
* The bodies' CUDA source compiled for the host at that width: every launch
  of the first steps equals its plain body bit for bit
  (``ShardRun.checked_step``), and the whole episode equals the plain
  single-shard episode.
* A shard of more than 1,024 lanes is still refused.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from dhts_torch.parallel.local_ranks import run_local
from dhts_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

WIDE_CFG = dict(num_intersection=9, num_lane=1, lane_length=5.0,
                speed_limit=20.0, cell_length=5.0, policy_length=2,
                signal_length=2, simulation_frequency=10, random_seed=3,
                max_num_micro_vehicle_per_lane=4, mode="hybrid")
S = 4


@functools.lru_cache(maxsize=None)
def wide_env():
    env = ItscpEnv(config=WIDE_CFG, schedule_fn=problem.problem_1,
                   device="cpu")
    env.reset()
    assert env.spec.num_lanes == 1296
    return env


def draw():
    env = wide_env()
    return env.draw_rand(torch.Generator().manual_seed(0))


def jax_episodes(action):
    """JAX's scan env of the scene: its hard and soft episodes at
    ``PRNGKey(0)`` and that key's draw ``[T, L]``."""
    import jax
    import jax.numpy as jnp

    from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv
    from dhts.apps.control.itscp.problem import problem_1

    jenv = JaxEnv(config=WIDE_CFG, schedule_fn=problem_1)
    jenv.reset()
    key = jax.random.PRNGKey(0)
    rand = np.array(jax.random.uniform(key, (jenv.num_timestep,
                                             jenv.spec.num_lanes)))
    return rand, {diff: jenv.episode(jnp.asarray(action), diff, key)
                  for diff in (False, True)}


def _rank(rank, S, rand, action):
    """One rank's sharded episodes, hard and soft."""
    env = wide_env()
    mesh = make_mesh({"data": 1, "lane": S}, "cpu")
    out = {}
    for diff in (False, True):
        ep = k6.make_fused_spatial_episode(env, mesh, differentiable=diff)
        with torch.no_grad():
            res = ep(torch.as_tensor(action), torch.as_tensor(rand))
        out[diff] = res
    return out


def _check(res, ref):
    """JAX's ``_check`` (``tests/test_spatial_fused.py``)."""
    np.testing.assert_allclose(float(res.reward), float(ref.reward),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.queue_per_step.numpy(),
                               np.asarray(ref.queue_per_step), rtol=1e-4,
                               atol=1e-6)
    for name in ("injected", "emitted", "absorbed"):
        assert int(getattr(res, name)) == int(getattr(ref, name)), name


def test_wide_scene_runs_sharded_across_ranks():
    env = wide_env()
    action = np.full(env.action_size(), 0.45, np.float32)
    rand, jax_ref = jax_episodes(action)
    outs = run_local(_rank, S, args=(rand, action), timeout=300)
    for diff in (False, True):
        with torch.no_grad():
            ref = env.episode(torch.as_tensor(action), diff,
                              rand=torch.as_tensor(rand))
        for rank, o in enumerate(outs):
            res = o[diff]
            _check(res, jax_ref[diff])
            _check(res, ref)
            np.testing.assert_allclose(float(res.max_wave_speed),
                                       float(ref.max_wave_speed), rtol=1e-5)
            assert torch.equal(res.queue_per_step,
                               outs[0][diff].queue_per_step), rank
    # at this horizon no vehicle converts yet; the soft queue gates see the
    # macro flow the signals hold back
    assert float(jax_ref[True].reward) < 0 and float(ref.max_wave_speed) > 0


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation(
            "itscp_spatial_shard", tmp_path_factory.mktemp("k6wide"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return ks.bind(ctypes.CDLL(str(path)))


@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
def test_host_build_matches_plain_bodies_at_the_wide_scene(lib,
                                                           differentiable):
    env = wide_env()
    plan = k6.make_plan(env, differentiable)
    d = env.data
    inputs = (torch.full((plan.n_phases, plan.n_inter), 0.45),
              draw()[None], d.schedule, d.mroute_next, d.mroute_prev,
              k6.route_table(d.inj_routes, env.base_state.route_pool))
    comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, S))
    run = ks.ShardRun(plan, comm, inputs, dual=False, lib=lib)
    for t in range(plan.T):
        if t < 3:
            run.checked_step(t)
        else:
            run.step(t)
    queues, events, waves = run.outputs()
    ref = k6.plain_spatial_episode(plan, *inputs)
    assert torch.equal(queues, ref[0]) and torch.equal(events, ref[1])
    assert torch.equal(waves, ref[2])


def test_a_shard_above_the_block_cap_is_refused():
    env = wide_env()
    plan = k6.make_plan(env, False)
    d = env.data
    inputs = (torch.full((plan.n_phases, plan.n_inter), 0.45),
              draw()[None], d.schedule, d.mroute_next, d.mroute_prev,
              k6.route_table(d.inj_routes, env.base_state.route_pool))
    whole = ks.LaneComm.whole(plan.L)
    with pytest.raises(ValueError, match="shard of 1296 lanes exceeds"):
        ks.shard_episode_fwd(plan, whole, *inputs)
    # two shards of 648 lanes pass the check (the plain bodies then run)
    halves = ks.LaneComm(plan.L, ks.shards_of(plan.L, 2))
    assert ks._check(plan, halves, inputs, False) == inputs[1].device
