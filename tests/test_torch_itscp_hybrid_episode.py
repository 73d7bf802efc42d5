"""Kernel K1's forward in the port: plain version, kernel source, card.

* The plain PyTorch version against the JAX fused kernel
  (``make_fused_itscp_episode(..., differentiable=False, interpret=True)``,
  ``with_events=True``) on the JAX env's inputs: event rows 0-6 exact,
  max wave speed rel 1e-5, reward rel 1e-4, queues abs 1e-4.
* The CUDA source compiled for the host (``csrc/cpu_emulation.h``: one host
  thread per CUDA thread, a barrier per ``__syncthreads``) against the plain
  version: all 8 event rows bit-equal (the same IEEE float32 ops in the
  same order), reward rel 1e-5, queues abs 1e-5 (lane sums in another
  order).

The kernel itself runs only on the card: tests/test_torch_card.py.
"""

import ctypes

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
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

# small tensors: one intra-op thread is fastest and leaves the cores to
# the other test workers
torch.set_num_threads(1)

EMISSION_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                    speed_limit=20.0, cell_length=5.0, policy_length=16,
                    signal_length=2, simulation_frequency=10, random_seed=3,
                    max_num_micro_vehicle_per_lane=4, mode="hybrid")
# all-micro grid: boundary injection, transfers and exits
MICRO_CFG = dict(num_intersection=2, num_lane=2, lane_length=20.0,
                 speed_limit=30.0, policy_length=8, signal_length=2,
                 simulation_frequency=10, random_seed=5, mode="micro")
MACRO_CFG = dict(MICRO_CFG, mode="macro")


def port_env(cfg, schedule_fn=problem.problem_1):
    env = ItscpEnv(config=dict(cfg, use_fused_episode=True),
                   schedule_fn=schedule_fn, device="cpu")
    env.reset()
    return env, env.fused_plan(False)


def k1_inputs(env, action_value, rand):
    action = torch.full((env.action_size(),), float(action_value))
    return (action.reshape(env.n_phases, -1).contiguous(), env.data.schedule,
            env.data.mroute_next, env.data.mroute_prev, rand,
            env.data.inj_routes, env.base_state.route_pool)


@pytest.fixture(scope="module")
def jax_case():
    jenv = JaxEnv(config=EMISSION_CFG, schedule_fn=jproblem.problem_1)
    jenv.reset()
    V = jenv.base_state.micro.position.shape[1]
    R = jenv.base_state.micro.route.shape[2]
    P = jenv.data.inj_routes.shape[1]
    P2 = jenv.base_state.route_pool.shape[1]
    fused = jk1.make_fused_itscp_episode(
        jenv.spec, jenv.meta, jenv.config, V, R, P, P2,
        differentiable=False, window=jenv._fused_win_needed, interpret=True)
    key = jax.random.PRNGKey(0)
    rand = jax.random.uniform(key, (jenv.num_timestep, jenv.spec.num_lanes))
    return jenv, fused, rand


@pytest.mark.parametrize("a", [0.3, 0.6])
def test_plain_version_matches_jax_fused_kernel(jax_case, a):
    jenv, fused, rand = jax_case
    n_phases = EMISSION_CFG["policy_length"] // EMISSION_CFG["signal_length"]
    action = jnp.full((jenv.action_size(),), a)
    ref_r, ref_q, ref_e = fused(action.reshape(n_phases, -1),
                                jenv.data.schedule, jenv.data.mroute_next,
                                jenv.data.mroute_prev, rand,
                                jenv.data.inj_routes,
                                jenv.base_state.route_pool, with_events=True)
    env, plan = port_env(EMISSION_CFG)
    np.testing.assert_array_equal(env.base_state.route_pool.numpy(),
                                  np.asarray(jenv.base_state.route_pool))
    assert plan.W == jenv._fused_win_needed
    got_r, got_q, got_e = k1.plain_episode(
        plan, *k1_inputs(env, a, torch.as_tensor(np.array(rand))))
    ref_e = np.asarray(ref_e)
    np.testing.assert_array_equal(got_e[:, :7].numpy(), ref_e[:, :7])
    np.testing.assert_allclose(got_e[:, 7].numpy(), ref_e[:, 7], rtol=1e-5)
    assert float(got_r) == pytest.approx(float(ref_r), rel=1e-4)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(ref_q), rtol=0,
                               atol=1e-4)
    if a == 0.6:
        assert ref_e[:, 1].sum() >= 2 and ref_e[:, 2].sum() >= 1


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation(
            "itscp_hybrid_episode", tmp_path_factory.mktemp("k1"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    fn = ctypes.CDLL(str(path)).launch_itscp_hybrid_episode_fwd
    fn.argtypes = k1._ARGTYPES
    fn.restype = ctypes.c_int

    def run(plan, inputs):
        out = (torch.zeros(()), torch.zeros(plan.T), torch.zeros(plan.T, 8))
        assert fn(*k1.kernel_args(plan, inputs, out, 0)) == 0
        return out

    return run


@pytest.mark.parametrize("cfg,a", [(EMISSION_CFG, 0.3), (EMISSION_CFG, 0.6),
                                   (MICRO_CFG, 0.5), (MACRO_CFG, 0.4)],
                         ids=["hybrid-0.3", "hybrid-0.6", "micro", "macro"])
def test_kernel_source_matches_plain_version(emulated, cfg, a):
    env, plan = port_env(cfg, problem.random_schedule
                         if cfg is not EMISSION_CFG else problem.problem_1)
    rand = env.draw_rand(torch.Generator().manual_seed(7))
    inputs = k1_inputs(env, a, rand)
    pr, pq, pe = k1.plain_episode(plan, *inputs)
    kr, kq, ke = emulated(plan, inputs)
    assert torch.equal(ke, pe), (ke - pe).abs().amax(0)
    assert float(kr) == pytest.approx(float(pr), rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(kq.numpy(), pq.numpy(), rtol=0, atol=1e-5)
    if cfg is MICRO_CFG:
        assert pe[:, 0].sum() > 0 and pe[:, 4].sum() > 0  # inject, transfer
    if cfg is EMISSION_CFG and a == 0.6:
        assert pe[:, 1].sum() >= 2 and pe[:, 5].sum() >= 1  # emit, deposit


def test_leader_window_matches_dhts():
    rng = np.random.default_rng(0)
    is_macro = rng.random(40) < 0.4
    routes = rng.integers(-1, 40, (6, 5, 32))
    assert k1.leader_window(is_macro, routes) == jk1.leader_window(
        is_macro, routes)
    assert k1.leader_window(is_macro, np.full((0, 4), -1)) == \
        jk1.leader_window(is_macro, np.full((0, 4), -1))


def test_wrapper_runs_plain_version_for_cpu_tensors():
    env, plan = port_env(EMISSION_CFG)
    rand = env.draw_rand(torch.Generator().manual_seed(1))
    inputs = k1_inputs(env, 0.6, rand)
    before = dict(k1.itscp_hybrid_episode_fwd.launches)
    got = k1.itscp_hybrid_episode_fwd(plan, *inputs)
    ref = k1.plain_episode(plan, *inputs)
    assert k1.itscp_hybrid_episode_fwd.launches == before  # no kernel
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_input_checks_raise():
    x = torch.zeros(4, 3)
    k1._check("x", x, (4, 3), torch.float32, x.device)
    with pytest.raises(TypeError):
        k1._check("x", x.to(torch.int32), (4, 3), torch.float32, x.device)
    with pytest.raises(ValueError):
        k1._check("x", x, (3, 4), torch.float32, x.device)
    with pytest.raises(ValueError):
        k1._check("x", x.T, (3, 4), torch.float32, x.device)
