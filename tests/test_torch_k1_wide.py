"""K1 on scenes wider than one block: the plan's layout, and the plain
version against :mod:`dhts` on the 5x5 and 9x9 hybrid grids.

Scenes: ``run_itscp_5x5.sh``'s flags (lane length 5, 60 m/s, 30 Hz, signal
length 4, ``random_seed=3``: a seed > 0, since seed 0 draws from an
unseeded generator) on the 5x5 and 9x9 grids (400 and 1,296 lanes), cut to
``policy_length`` 5, T = 150 steps: at T = 60 neither grid has an
injection or a conversion yet, and at T = 150 both emit vehicles. Both
envs reset with the same seed; the port gets the JAX env's ``rand[T,
L]``.

* ``make_plan`` picks the layout the kernel's shared memory and threads
  imply: 3x3 in shared memory both ways; 5x5 forward in shared memory,
  backward in global memory; 7x7 global both ways; 9x9 global both ways,
  two lanes a thread; a grid no layout takes raises, naming its sizes.
* K1's plain pair (the port's env with ``use_fused_episode`` on the CPU)
  against the JAX scan env's episode, hard, soft and ``st``: events exact,
  reward rel 1e-4, queues abs 1e-4;
* its action gradient, soft and ``st``, against ``jax.grad`` of the scan
  env with ``dhts.ops.idm.euler_step`` wrapped to stop the gradient at the
  acceleration floor (the port's deliberate difference;
  ``tests/test_torch_itscp_grad.py`` says why): cosine > 0.999,
  ``allclose(rtol=2e-2, atol=2e-3 * max|g|)``. At 5x5 in ``st`` mode the
  reference is ``jax.grad`` of the JAX env's own step function
  (``boundary_and_step``) in a Python loop, op by op: the jitted scan env
  disagrees with it there. XLA's compiled arithmetic differs from the
  op-by-op evaluation by an ulp from the first step on (lane 352's density
  at step 0), and at this scene in ``st`` mode that flips a derivative
  branch in one or two action entries by 20-40 % (at action draws 2, 3,
  4 and 5 of 2-6), where the port agrees with the op-by-op evaluation to
  a few 1e-7. That reference takes about 3.5 minutes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.apps.control.itscp import problem as jproblem
from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv
from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

torch.set_num_threads(1)

# run_itscp_5x5.sh's flags
SCRIPT = dict(num_lane=1, lane_length=5, speed_limit=60, signal_length=4,
              policy_length=20, mode="hybrid", random_seed=3)
T150 = dict(SCRIPT, policy_length=5)
LAYOUTS = {3: (1, ("shared", "shared")), 5: (1, ("shared", "global")),
           7: (1, ("global", "global")), 9: (2, ("global", "global"))}


def port_env(cfg):
    env = ItscpEnv(config=dict(cfg, use_fused_episode=True),
                   schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    return env


@pytest.mark.parametrize("n", sorted(LAYOUTS))
def test_make_plan_picks_the_layout_the_sizes_imply(n):
    env = port_env(dict(SCRIPT, num_intersection=n))
    for differentiable in (False, True):
        plan = env.fused_plan(differentiable)
        assert (plan.C, plan.V, plan.K) == (4, 16, 2)
        assert (plan.lanes_per_thread, plan.placement) == LAYOUTS[n]
        assert plan.lane_perm.numel() % (32 * plan.lanes_per_thread) == 0
        threads = plan.lane_perm.numel() // plan.lanes_per_thread + 32
        assert threads <= 1024
        perm = plan.lane_perm.numpy()
        assert sorted(perm[perm >= 0].tolist()) == list(range(plan.L))
        for tangent, where in enumerate(plan.placement):
            assert k1.check_layout(plan, bool(tangent)) == where
            assert k1.block_bytes(plan.L, 4, 16, 2, bool(tangent),
                                  where)[0] <= k1.H100_SMEM_PER_BLOCK
    # each row of a thread warp is one lane kind
    is_macro = plan.spec.is_macro.numpy()
    for w in perm.reshape(-1, 32):
        assert len(set(is_macro[w[w >= 0]].tolist())) <= 1


def test_a_scene_no_layout_takes_raises_with_its_sizes():
    env = port_env(dict(SCRIPT, num_intersection=11, policy_length=1))
    plan = env.fused_plan(True)
    assert plan.L == 1936 and plan.placement == (None, None)
    for tangent in (False, True):
        with pytest.raises(ValueError, match="L = 1936 lanes.*C = 4, V = 16"):
            k1.check_layout(plan, tangent)
    with pytest.raises(ValueError, match="cannot take this scene"):
        k1.kernel_args(plan, (torch.zeros(1),) * 7, (torch.zeros(1),) * 3,
                       0)
    # more lanes than two a thread of 1,024 threads take
    layout = k1.choose_layout(np.zeros(2000, bool), 1, 1, 1)
    assert layout == k1.Layout(0, (None, None))


@functools.lru_cache(maxsize=None)
def pair(n, gate_mode):
    cfg = dict(T150, num_intersection=n, gate_mode=gate_mode)
    jenv = JaxEnv(config=cfg, schedule_fn=jproblem.problem_1)
    jenv.reset()
    key = jax.random.PRNGKey(0)
    rand = np.array(jax.random.uniform(key, (jenv.num_timestep,
                                               jenv.spec.num_lanes)))
    return jenv, port_env(cfg), key, rand


def _euler_step_exact_floor(position, speed, acceleration, delta_time):
    """``dhts.ops.idm.euler_step`` whose new speed has a zero gradient
    where the acceleration floor ``-speed / dt`` binds."""
    new_speed = speed + delta_time * acceleration
    stopped = acceleration == (-speed) / delta_time
    return (position + delta_time * speed,
            jnp.where(stopped, jax.lax.stop_gradient(new_speed), new_speed))


def action_of(env, seed):
    return np.random.default_rng(seed).uniform(
        0.3, 0.7, env.action_size()).astype(np.float32)


@pytest.mark.parametrize("mode", ["hard", "soft", "st"])
@pytest.mark.parametrize("n", [5, 9])
def test_plain_episode_matches_jax_scan_env(n, mode):
    jenv, env, key, rand = pair(n, "st" if mode == "st" else "soft")
    diff = mode != "hard"
    action = action_of(env, 1)
    ref = jenv.episode(jnp.asarray(action), diff, key)
    got = env.episode(torch.as_tensor(action), diff,
                      rand=torch.as_tensor(rand))
    np.testing.assert_array_equal(got.events_per_step.numpy(),
                                  np.asarray(ref.events_per_step))
    assert float(got.reward) == pytest.approx(float(ref.reward), rel=1e-4)
    np.testing.assert_allclose(got.queue_per_step.detach().numpy(),
                               np.asarray(ref.queue_per_step), rtol=0,
                               atol=1e-4)
    assert int(got.emitted) == int(ref.emitted) >= 1


def step_by_step_reward(jenv, n_phases, rand):
    """``reward(action_flat)`` of the JAX env's episode: its step function
    ``boundary_and_step`` (the body of its scan) in a Python loop over T,
    each operation dispatched on its own, without ``jax.jit``."""
    from dhts.utils import rms as jrms

    fn = jenv._episode_soft.__wrapped__
    step = dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))[
        "boundary_and_step"]
    d, meta, spec = jenv.data, jenv.meta, jenv.spec
    inj0 = jnp.where(~meta.has_prev & ~spec.is_macro,
                     d.inj_routes.shape[1], 0).astype(jnp.int32)

    def reward(action_flat):
        action2d = action_flat.reshape(n_phases, -1)
        state, inj_left = jenv.base_state, inj0
        ms_stat, ms_sig = jrms.init_mean_state(), jrms.init_mean_state()
        total = 0.0
        for t in range(jenv.num_timestep):
            state = state._replace(macro_next=d.mroute_next[t],
                                   macro_prev=d.mroute_prev[t])
            state, inj_left, ms_stat, ms_sig, queue, *_ = step(
                state, t, action2d, d.schedule[t], jnp.asarray(rand[t]),
                d.inj_routes, inj_left, ms_stat, ms_sig)
            total = total + queue
        return -total

    return reward


@pytest.mark.parametrize("n, mode, reference", [
    (5, "soft", "scan"), (9, "soft", "scan"), (9, "st", "scan"),
    (5, "st", "step_by_step")])
def test_plain_gradient_matches_jax_grad(n, mode, reference):
    from dhts.ops import idm as jidm

    jenv, env, key, rand = pair(n, mode)
    action = action_of(env, 2)
    reward = (step_by_step_reward(jenv, env.n_phases, rand)
              if reference == "step_by_step"
              else lambda a: jenv.episode(a, True, key).reward)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jidm, "euler_step", _euler_step_exact_floor)
        ref = np.asarray(jax.grad(reward)(jnp.asarray(action)),
                         dtype=np.float64).ravel()
    a = torch.tensor(action, requires_grad=True)
    env.episode(a, True, rand=torch.as_tensor(rand)).reward.backward()
    got = a.grad.numpy().astype(np.float64).ravel()
    assert np.all(np.isfinite(got)) and np.linalg.norm(got) > 0
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos > 0.999, (cos, got, ref)
    np.testing.assert_allclose(got, ref, rtol=2e-2,
                               atol=2e-3 * np.abs(ref).max())
