"""A NaN running mean through the gated kernels, compiled for the host,
against the plain versions, and the plain versions against ``dhts``.

A soft gate takes its sharpness from a detached running mean,
``x / max(|mean|, 1e-6)``. ``dhts`` and the plain versions take that max
with ``jnp.maximum`` / ``torch.maximum``, which keep a NaN, and so does
every clamp after it (the soft gate's clip, the IDM's and the Riemann
solver's floors, the wave maxima). The kernels of the ITSCP step (K1, K4,
STEP and the lane-sharded bodies) keep it too: a NaN mean gives NaN gates,
and NaN flows on as through the plain version.

The CUDA sources are built with g++ against ``csrc/cpu_emulation.h`` and
called through the card's C launchers. Each case feeds a NaN where it
reaches the running means: one action entry in soft or ``st`` mode (the
signals of that entry's lanes, then the signal mean through the blend,
the ghosts and the cells, then the static mean), one carried vehicle's
speed (the static mean's term, and that vehicle's and its follower's
update), or the gathered terms of a shard's fold. "The same" means the
same NaN positions and the other entries bit-equal (K1's queues allclose
atol 1e-5: K1 sums its lanes in another order than the plain version, as
in ``tests/test_torch_itscp_hybrid_episode.py``). The cases and helpers
are those of ``tests/test_torch_card_nan_gate.py``, the card's copy of
these checks.

* K1 (T = 160, hybrid and micro scenes, soft and ``st``, the action
  entry of phase 0 or 2): reward, queues and events the same as the plain episode's.
* K4 (the small macro scene, T = 60): reward and queues the same, from
  the empty state with a NaN action entry and from a seeded state with a
  NaN cell.
* STEP (hybrid and micro scenes, soft, B = 2, 12 steps of one launch
  each): the packed carry after each step, the queues, events and waves.
* The shards (S = 2 and 4, soft, B = 2): every launch (A-E) of the step
  whose gathered fold terms hold a NaN and of the step after it; every
  launch of 4 steps after a NaN carried vehicle speed.
* ``dhts``: the plain K1 and STEP episodes against the JAX scan env
  (``ItscpEnv.episode``) in hybrid mode, and the plain K4 episode against
  it in macro mode, on the same NaN action: the same NaN positions of the
  queues, and K1's events. (JAX's K4 kernel selects the phase's action
  entry by a one-hot product, which spreads a NaN entry of any phase to
  every step; the scan env and the port take the entry itself.)
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.apps.control.itscp import problem as jproblem
from dhts.apps.control.itscp.env import ItscpEnv as JaxEnv
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1
from dhts_torch.ops.cuda import itscp_macro_episode as k4
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from tests.test_torch_card_nan_gate import (HYBRID, K1_CASES, MACRO,
                                            check_shard_fold_nan,
                                            check_shard_speed_nan,
                                            check_steps, k1_case, k4_case,
                                            nan_action, port_env, same,
                                            shard_run, step_case)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("nangate")
    try:
        paths = {name: _build.build_cpu_emulation(name, out) for name in (
            "itscp_hybrid_episode", "itscp_macro_episode",
            "itscp_spatial_step", "itscp_spatial_shard")}
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel sources: {err}")
    return {"k1": k1.bind(ctypes.CDLL(str(paths["itscp_hybrid_episode"]))),
            "k4": k4.bind(ctypes.CDLL(str(paths["itscp_macro_episode"]))),
            "step": k6.bind(ctypes.CDLL(str(paths["itscp_spatial_step"]))),
            "shard": ks.bind(ctypes.CDLL(str(
                paths["itscp_spatial_shard"])))}


@pytest.mark.parametrize("scene, gate, entry", K1_CASES)
def test_k1_nan_action_gives_plain_nan_outputs(libs, scene, gate, entry):
    plan, ins = k1_case(scene, gate, entry)
    ref = k1.plain_episode(plan, *ins)
    got = (torch.zeros(()), torch.zeros(plan.T), torch.zeros(plan.T, 8))
    assert libs["k1"].launch_itscp_hybrid_episode_fwd(*k1.kernel_args(
        plan, ins, got, 0)) == 0
    assert bool(ref[1].isnan().any()), "the NaN reached no queue"
    assert same(got[0], ref[0], 1e-5) and same(got[1], ref[1], 1e-5)
    assert same(got[2], ref[2])


@pytest.mark.parametrize("nan", ["action", "cell"])
def test_k4_nan_gives_plain_nan_outputs(libs, nan):
    plan, ins = k4_case(nan)
    got = (torch.empty(()), torch.empty(plan.T))
    assert libs["k4"].launch_itscp_macro_episode_fwd(*k4.kernel_args(
        plan, ins, got, 0)) == 0
    ref = k4.plain_macro_episode(plan, *ins)
    assert bool(ref[1].isnan().any())
    assert same(got[0], ref[0]) and same(got[1], ref[1])


@pytest.mark.parametrize("nan", ["speed", "action"])
@pytest.mark.parametrize("scene", ["hybrid", "micro"])
def test_step_nan_gives_plain_nan_outputs(libs, scene, nan):
    plan, ins, state, t0, g = step_case(scene, nan)
    B = state[0][0].shape[0]

    def launch(fb, ib, t, q, ev, w):
        assert libs["step"].launch_itscp_spatial_step_fwd(*k6.kernel_args(
            plan, (fb, None, ib), ins, (q, ev, w), B, t, 1, 0)) == 0

    check_steps(launch, plan, ins, state, t0, g)


@pytest.mark.parametrize("S", [2, 4])
def test_shard_fold_nan_gives_plain_nan_outputs(libs, S):
    check_shard_fold_nan(shard_run(S, lib=libs["shard"]))


@pytest.mark.parametrize("S", [2, 4])
def test_shard_nan_speed_gives_plain_nan_outputs(libs, S):
    check_shard_speed_nan(shard_run(S, "micro", steps=24,
                                    lib=libs["shard"]))


@pytest.fixture(scope="module")
def jax_hybrid():
    jenv = JaxEnv(config=HYBRID, schedule_fn=jproblem.problem_1)
    jenv.reset(3)
    tenv = port_env("hybrid", use_fused_episode=True)
    key = jax.random.PRNGKey(0)
    rand = np.array(jax.random.uniform(key, (jenv.num_timestep,
                                             jenv.spec.num_lanes)))
    return jenv, tenv, key, rand


@pytest.mark.parametrize("entry", [(2, 1), (5, 7)])
def test_plain_nan_positions_equal_dhts(jax_hybrid, entry):
    jenv, tenv, key, rand = jax_hybrid
    action = nan_action(tenv, entry)
    ref = jenv.episode(jnp.asarray(action.reshape(-1).numpy()), True, key)
    j_q = np.asarray(ref.queue_per_step)
    j_ev = np.asarray(ref.events_per_step)
    assert np.isnan(j_q).any() and not np.isnan(j_q).all()
    d = tenv.data
    r = torch.as_tensor(rand)
    _, q, ev = k1.plain_episode(tenv.fused_plan(True), action, d.schedule,
                                d.mroute_next, d.mroute_prev, r,
                                d.inj_routes, tenv.base_state.route_pool)
    np.testing.assert_array_equal(q.isnan().numpy(), np.isnan(j_q))
    np.testing.assert_array_equal(ev[:, :j_ev.shape[1]].numpy(), j_ev)
    sq, _, _ = k6.plain_spatial_episode(
        k6.make_plan(tenv, True), action, r[None], d.schedule,
        d.mroute_next, d.mroute_prev,
        k6.route_table(d.inj_routes, tenv.base_state.route_pool))
    np.testing.assert_array_equal(sq[0].isnan().numpy(), np.isnan(j_q))


def test_plain_k4_nan_positions_equal_dhts():
    jenv = JaxEnv(config=MACRO, schedule_fn=jproblem.problem_1)
    jenv.reset(3)
    plan, ins = k4_case("action")  # the second phase's entry NaN
    ref = jenv.episode(jnp.asarray(ins[0].reshape(-1).numpy()), True,
                       jax.random.PRNGKey(0))
    got_r, got_q = k4.plain_macro_episode(plan, *ins)
    ref_q = np.asarray(ref.queue_per_step)
    assert np.isnan(ref_q).any() and not np.isnan(ref_q).all()
    np.testing.assert_array_equal(got_q.isnan().numpy(), np.isnan(ref_q))
    assert bool(got_r.isnan()) == bool(np.isnan(np.asarray(ref.reward)))
