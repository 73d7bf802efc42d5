"""Kernel K1's soft/straight-through forward and its backward, compiled for
the host, against the plain PyTorch version.

The CUDA source is built with g++ against ``csrc/cpu_emulation.h`` (one
fiber per CUDA thread, the blocks of a grid one after another) and called
through the same C launchers as on the card.

* Forward in ``soft`` and ``st`` mode: events[T, 8] bit-equal to the plain
  version's (the same float32 ops in the same order; the gates' sigmoid is
  taken in float64 and rounded once on both sides, so the host's libm and
  PyTorch's CPU ``exp`` agree), reward rel 1e-5, queues abs 1e-5 (lane sums
  in another order).
* Backward (forward-mode tangents, one block per action entry) against
  autograd of the plain version for random per-step loss weights: cosine
  > 0.999 and ``allclose(rtol=2e-2, atol=2e-3 * max|g|)``, the JAX
  package's fused-vs-scan standard (``tests/test_itscp_hybrid_fused.py``),
  finite and nonzero.

Actions are drawn off the signal-progress grid (a grid point makes the
hard gate's ``a > progress`` and ``progress > a`` both false, where the
straight-through gradient is not defined). The backward runs the hybrid
scene with two signal phases: the host runs the grid's blocks one after
another, so fewer action entries keep the test short.

Straight-through gradients are small, and forward and reverse mode round
differently. Where the acceleration floor stops a vehicle, its new speed
``sp + dt * (-sp / dt)`` does not depend on ``sp``; the kernel gives it a
zero tangent and the plain version detaches it. Summed in either mode it
left a one-ulp residue of a large speed tangent or gradient, which a soft
queue gate turned into gradient as large as the straight-through gradient
(cosine 0.9976 at the draw of ``default_rng(11)``; a kernel gradient of 0
against a plain one of 3.2e-8 at the grid point 0.55 on the card). The
``st`` backward is held over fourteen draws and on the progress grid in
``test_torch_itscp_hybrid_episode_bwd_st.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

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
TWO_PHASE_CFG = dict(EMISSION_CFG, signal_length=8)
MICRO_CFG = dict(num_intersection=2, num_lane=2, lane_length=20.0,
                 speed_limit=30.0, policy_length=8, signal_length=2,
                 simulation_frequency=10, random_seed=5, mode="micro")
MACRO_CFG = dict(MICRO_CFG, mode="macro")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation(
            "itscp_hybrid_episode", tmp_path_factory.mktemp("k1"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return k1.bind(ctypes.CDLL(str(path)))


def case(cfg, gate_mode, seed=12):
    env = ItscpEnv(config=dict(cfg, use_fused_episode=True,
                               gate_mode=gate_mode),
                   schedule_fn=problem.problem_1 if cfg["mode"] == "hybrid"
                   else problem.random_schedule, device="cpu")
    env.reset()
    plan = env.fused_plan(True)
    rand = env.draw_rand(torch.Generator().manual_seed(7))
    rng = np.random.default_rng(seed)
    action = torch.as_tensor(rng.uniform(0.3, 0.7, env.action_size()),
                             dtype=torch.float32)
    inputs = (action.reshape(env.n_phases, -1).contiguous(),
              env.data.schedule, env.data.mroute_next, env.data.mroute_prev,
              rand, env.data.inj_routes, env.base_state.route_pool)
    return plan, inputs


@pytest.mark.parametrize("gate_mode", ["soft", "st"])
@pytest.mark.parametrize("cfg", [EMISSION_CFG, MICRO_CFG, MACRO_CFG],
                         ids=["hybrid", "micro", "macro"])
def test_soft_forward_source_matches_plain_version(lib, cfg, gate_mode):
    plan, inputs = case(cfg, gate_mode)
    assert plan.mode == (k1.ST if gate_mode == "st" else k1.SOFT)
    pr, pq, pe = k1.plain_episode(plan, *inputs)
    out = (torch.zeros(()), torch.zeros(plan.T), torch.zeros(plan.T, 8))
    assert lib.launch_itscp_hybrid_episode_fwd(
        *k1.kernel_args(plan, inputs, out, 0)) == 0
    kr, kq, ke = out
    assert torch.equal(ke, pe), (ke - pe).abs().amax(0)
    assert float(kr) == pytest.approx(float(pr), rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(kq.numpy(), pq.detach().numpy(), rtol=0,
                               atol=1e-5)
    if cfg is EMISSION_CFG:
        assert pe[:, 1].sum() >= 1  # emissions happened
    if cfg is MICRO_CFG:
        assert pe[:, 0].sum() > 0 and pe[:, 4].sum() > 0  # inject, transfer


@pytest.mark.parametrize("cfg,gate_mode", [
    (TWO_PHASE_CFG, "soft"), (TWO_PHASE_CFG, "st"), (MICRO_CFG, "soft"),
    (MACRO_CFG, "soft"), (MACRO_CFG, "st")],
    ids=["hybrid-soft", "hybrid-st", "micro-soft", "macro-soft", "macro-st"])
def test_backward_source_matches_autograd(lib, cfg, gate_mode):
    plan, inputs = case(cfg, gate_mode)
    w = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, plan.T),
                        dtype=torch.float32)
    ref = k1.plain_episode_bwd(plan, w, *inputs).numpy().ravel()
    grad = torch.zeros(plan.n_phases, plan.n_inter)
    assert lib.launch_itscp_hybrid_episode_bwd(
        *k1.kernel_args(plan, inputs, (w, grad), 0)) == 0
    got = grad.numpy().ravel()
    assert np.all(np.isfinite(got)) and np.linalg.norm(got) > 0
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos > 0.999, (cos, got, ref)
    np.testing.assert_allclose(got, ref, rtol=2e-2,
                               atol=2e-3 * np.abs(ref).max())


def test_backward_launcher_refuses_hard_mode(lib):
    plan, inputs = case(MACRO_CFG, "soft")
    hard = plan._replace(mode=k1.HARD)
    grad = torch.zeros(plan.n_phases, plan.n_inter)
    w = torch.ones(plan.T)
    assert lib.launch_itscp_hybrid_episode_bwd(
        *k1.kernel_args(hard, inputs, (w, grad), 0)) != 0
