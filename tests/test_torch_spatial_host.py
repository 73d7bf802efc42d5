"""The fused spatial step's CUDA source, compiled for the host, against the
plain PyTorch step.

``csrc/itscp_spatial_step.cu`` is built with g++ against
``csrc/cpu_emulation.h`` (one fiber per CUDA thread, the blocks of a grid
one after another) and called through the same C launchers as on the card.

* Forward, hard and soft, one launch per step: after every step the packed
  carry, the queue, the injected/emitted/absorbed counts and the max wave
  speed equal the plain step's bit for bit (the same float32 operations in
  the same order; lane sums in float64 rounded once on both sides). With B
  = 3 episodes per launch, each with its own draw (in the micro scene the
  draws inject different vehicles), the batch stays equal to the plain
  step's: each episode keeps its own running means.
* Derivative (forward-mode tangents, one block per episode and action
  entry, one launch per step) against autograd of the plain episode for
  random per-step loss weights: cosine > 0.9999 and allclose(rtol 2e-2,
  atol 2e-3 * max|g|), the JAX package's fused-vs-scan standard; finite and
  nonzero. The hybrid scene runs with two signal phases there: the host
  runs the grid's blocks one after another. In the micro scene the
  derivative is also held, carry and tangents, against its wrapper's plain
  version on the CPU: the plain step in PyTorch's forward-mode AD.
"""

import ctypes

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_spatial_step as k6

torch.set_num_threads(1)

MICRO_CFG = dict(num_intersection=1, num_lane=2, lane_length=20.0,
                 speed_limit=20.0, cell_length=5.0, policy_length=4,
                 signal_length=2, simulation_frequency=10, random_seed=3,
                 max_num_micro_vehicle_per_lane=4, mode="micro")
HYBRID_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                  speed_limit=20.0, cell_length=5.0, policy_length=16,
                  signal_length=2, simulation_frequency=10, random_seed=3,
                  max_num_micro_vehicle_per_lane=4, mode="hybrid")
TWO_PHASE_CFG = dict(HYBRID_CFG, signal_length=8)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation(
            "itscp_spatial_step", tmp_path_factory.mktemp("k6"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return k6.bind(ctypes.CDLL(str(path)))


def case(cfg, differentiable, B, seed=12):
    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    plan = k6.make_plan(env, differentiable)
    gen = torch.Generator().manual_seed(7)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    action = torch.as_tensor(np.random.default_rng(seed).uniform(
        0.3, 0.7, env.action_size()), dtype=torch.float32)
    d = env.data
    inputs = (action.reshape(plan.n_phases, -1).contiguous(), rand,
              d.schedule, d.mroute_next, d.mroute_prev,
              k6.route_table(d.inj_routes, env.base_state.route_pool))
    return plan, inputs


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
@pytest.mark.parametrize("cfg", [MICRO_CFG, HYBRID_CFG],
                         ids=["micro", "hybrid"])
def test_forward_source_matches_plain_step(lib, cfg, differentiable, B):
    plan, inputs = case(cfg, differentiable, B)
    a, rand, sched, mnext, mprev, routes = inputs
    fb, ib = k6.empty_state(plan, B, "cpu")
    q = torch.zeros(B, plan.T)
    ev = torch.zeros(B, plan.T, 3, dtype=torch.int32)
    w = torch.zeros(B, plan.T)
    carry, sg, ss = k6.initial_carry(plan, B, "cpu")
    g = k6.geometry(plan, "cpu")
    for t in range(plan.T):
        assert lib.launch_itscp_spatial_step_fwd(*k6.kernel_args(
            plan, (fb, None, ib), inputs, (q, ev, w), B, t, 1, 0)) == 0
        out = k6.plain_spatial_step(plan, carry, sg, ss, t, a, rand[:, t],
                                    sched[t], mnext[t], mprev[t], routes, g)
        carry, sg, ss = out.carry, out.sg_ms, out.ss_ms
        f2, i2 = k6.pack(plan, carry, sg, ss)
        assert torch.equal(f2, fb) and torch.equal(i2, ib), t
        assert torch.equal(out.queue, q[:, t]), t
        assert torch.equal(out.events, ev[:, t]), t
        assert torch.equal(out.max_wave, w[:, t]), t
    tot = ev.sum((0, 1))
    assert int(tot[0] if cfg is MICRO_CFG else tot[1]) > 0
    if B > 1 and cfg is MICRO_CFG:
        # the draws inject different vehicles (the hybrid scene injects
        # none: its episodes coincide)
        assert not torch.equal(fb[0], fb[1])


@pytest.mark.parametrize("cfg", [MICRO_CFG, TWO_PHASE_CFG],
                         ids=["micro", "hybrid"])
def test_derivative_source_matches_autograd(lib, cfg):
    B = 2
    plan, inputs = case(cfg, True, B)
    wq = torch.as_tensor(np.random.default_rng(0).uniform(
        -1, 1, (B, plan.T)), dtype=torch.float32)
    ref = k6.plain_spatial_episode_bwd(plan, wq, *inputs).numpy().ravel()
    fb, db, ib = k6.dual_state(plan, B, "cpu")
    g64 = torch.zeros(fb.shape[0], dtype=torch.float64)
    assert lib.launch_itscp_spatial_step_bwd(*k6.kernel_args(
        plan, (fb, db, ib), inputs, (wq, g64, None), B, 0, plan.T, 0)) == 0
    got = g64.view(B, -1).sum(0).numpy()
    assert np.all(np.isfinite(got)) and np.linalg.norm(got) > 0
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos > 0.9999, (cos, got, ref)
    np.testing.assert_allclose(got, ref, rtol=2e-2,
                               atol=2e-3 * np.abs(ref).max())


def test_derivative_source_matches_forward_mode_plain_step(lib):
    """The derivative wrapper's plain version on the CPU: the plain step in
    PyTorch's forward-mode AD, one action entry at a time. Values equal,
    tangents and gradient allclose(rtol 1e-5, atol 1e-6 * max); the two
    round their tangent formulas differently."""
    B = 2
    plan, inputs = case(MICRO_CFG, True, B)
    wq = torch.as_tensor(np.random.default_rng(1).uniform(
        -1, 1, (B, plan.T)), dtype=torch.float32)
    plain = k6.dual_state(plan, B, "cpu")
    kern = k6.dual_state(plan, B, "cpu")
    g_plain = torch.zeros(plain[0].shape[0], dtype=torch.float64)
    g_kern = torch.zeros_like(g_plain)
    k6.spatial_step_bwd(plan, *plain, 0, plan.T, inputs, wq, g_plain)
    assert k6.launches["bwd"] == 0  # the plain version launched nothing
    assert lib.launch_itscp_spatial_step_bwd(*k6.kernel_args(
        plan, kern, inputs, (wq, g_kern, None), B, 0, plan.T, 0)) == 0
    assert torch.equal(plain[0], kern[0]) and torch.equal(plain[2], kern[2])
    for a, b in ((plain[1], kern[1]), (g_plain, g_kern)):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))


def test_launchers_refuse_bad_launches(lib):
    plan, inputs = case(MICRO_CFG, True, 1)
    fb, db, ib = k6.dual_state(plan, 1, "cpu")
    g64 = torch.zeros(fb.shape[0], dtype=torch.float64)
    w = torch.ones(1, plan.T)
    hard = plan._replace(mode=k6.HARD)
    assert lib.launch_itscp_spatial_step_bwd(*k6.kernel_args(
        hard, (fb, db, ib), inputs, (w, g64, None), 1, 0, 1, 0)) != 0
    # past the last step
    assert lib.launch_itscp_spatial_step_bwd(*k6.kernel_args(
        plan, (fb, db, ib), inputs, (w, g64, None), 1, plan.T, 1, 0)) != 0
    assert lib.itscp_spatial_step_smem(plan.L, 1) > \
        lib.itscp_spatial_step_smem(plan.L, 0)
