"""Kernel K4 (the fused all-macro ITSCP episode) on the card against its
plain PyTorch version (skipped without a CUDA device), at the macro preset
of ``run_itscp_macro.sh`` (one intersection, 3 lanes per arm, lane length
30, speed limit 60, policy length 10, signal length 2, 30 Hz: L = 40 lanes,
C = 7 cells, T = 300 steps, 5 actions), problem 1, seed 3.

The checks of ``chip_smoke.py``'s ``k4_vs_plain`` phase, at two actions and
two initial states (empty, the ITSCP case; and a seeded state on the valid
cells): reward rel <= 1e-5 and queues abs <= 1e-4 (the kernel repeats the
plain version's float32 operations and sums, so it is expected to be
exact); the gradients with respect to the action, r0 and y0 against
autograd of the plain version, cosine > 0.999 and allclose(rtol 2e-2, atol
2e-3 * max|g|) (the fused standard with soft gates that K1's checks use:
forward and reverse mode round differently), finite, nonzero, exactly 0 on
the cells beyond a lane's ``num_cell``. This file imports nothing of JAX:

    python -m pytest --noconftest -q tests/test_torch_card_macro_episode.py
"""

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops import arz
from dhts_torch.ops.cuda import itscp_macro_episode as k4

torch.set_num_threads(1)

MACRO_PRESET = dict(num_intersection=1, num_lane=3, lane_length=30,
                    speed_limit=60, policy_length=10, signal_length=2,
                    mode="macro", random_seed=3)


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU path")
    env = ItscpEnv(config=MACRO_PRESET, schedule_fn=problem.problem_1,
                   device="cuda")
    env.reset()
    fn = k4.make_fused_itscp_macro_episode(env.spec, env.meta, env.config)
    return env, fn


def inputs(env, plan, action, seeded):
    """The kernel's inputs: ``action`` everywhere, and an empty or a
    seeded initial state (r0 in [0.05, 0.6] on the valid cells, y0 of
    speeds in [0.3, 1] u_max)."""
    dev = env.device
    L, C, u_max = plan.L, plan.C, plan.floats[0]
    r0 = torch.zeros((L, C), device=dev)
    y0 = torch.zeros((L, C), device=dev)
    if seeded:
        rng = np.random.default_rng(11)
        t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        m = plan.cell_mask
        r0 = torch.where(m, t(rng.uniform(0.05, 0.6, (L, C))), 0.0)
        u0 = t(rng.uniform(0.3, 1.0, (L, C)) * u_max)
        y0 = torch.where(m, arz.compute_y(r0, u0, u_max), 0.0)
    a = torch.full((plan.n_phases, plan.n_inter), action, device=dev)
    d = env.data
    return (a, d.schedule, d.mroute_next, d.mroute_prev, r0.contiguous(),
            y0.contiguous())


@pytest.mark.parametrize("seeded", [False, True], ids=["empty", "seeded"])
@pytest.mark.parametrize("action", [0.3, 0.7])
def test_forward_matches_plain_version(scene, action, seeded):
    env, fn = scene
    plan = fn.plan
    ins = inputs(env, plan, action, seeded)
    n = k4.macro_episode_fwd.launches
    reward, queues = k4.macro_episode_fwd(plan, *ins)
    ref_r, ref_q = k4.plain_macro_episode(plan, *ins)
    torch.cuda.synchronize()
    assert k4.macro_episode_fwd.launches == n + 1
    assert queues.shape == (plan.T,) and torch.isfinite(queues).all()
    assert abs(float(reward) - float(ref_r)) <= 1e-5 * abs(float(ref_r))
    assert float((queues - ref_q).abs().max()) <= 1e-4


@pytest.mark.parametrize("seeded", [False, True], ids=["empty", "seeded"])
@pytest.mark.parametrize("action", [0.3, 0.7])
def test_backward_matches_autograd(scene, action, seeded):
    env, fn = scene
    plan = fn.plan
    ins = inputs(env, plan, action, seeded)
    # the reward's cotangent, and on the seeded state a loss on queues[t]
    w = torch.full((plan.T,), -1.0, device=env.device)
    if seeded:
        w = w + torch.linspace(0.0, 2.0, plan.T, device=env.device)
    got = k4.macro_episode_bwd(plan, w, *ins)
    want = k4.plain_macro_episode_bwd(plan, w, *ins)
    torch.cuda.synchronize()
    pad = ~plan.cell_mask
    for name, a, b in zip(("action", "r0", "y0"), got, want):
        if name != "action":
            assert float(a[pad].abs().max()) == 0.0, name
        a, b = a.double().flatten(), b.double().flatten()
        scale = float(b.abs().max())
        assert torch.isfinite(a).all() and scale > 0, name
        assert float(a @ b / (a.norm() * b.norm())) > 0.999, name
        assert torch.allclose(a, b, rtol=2e-2, atol=2e-3 * scale), name


def test_factory_launches_only_the_requested_blocks(scene):
    env, fn = scene
    plan = fn.plan
    a, sched, mnext, mprev, r0, y0 = inputs(env, plan, 0.4, True)
    n_f, n_b = k4.macro_episode_fwd.launches, k4.macro_episode_bwd.launches
    blocks = k4.macro_episode_tangents.blocks
    a = a.requires_grad_(True)
    reward, _ = fn(a, sched, mnext, mprev, r0, y0)
    reward.backward()
    assert k4.macro_episode_fwd.launches == n_f + 1
    # the reverse sweep: one launch (a grid of one block), whatever is
    # asked for, and none of the forward-mode blocks
    assert k4.macro_episode_bwd.launches == n_b + 1
    assert k4.macro_episode_tangents.blocks == blocks
    g_a = a.grad.clone()
    a.grad = None
    r0 = r0.clone().requires_grad_(True)
    reward, _ = fn(a, sched, mnext, mprev, r0, y0)
    reward.backward()
    assert k4.macro_episode_bwd.launches == n_b + 2
    assert k4.macro_episode_tangents.blocks == blocks
    assert torch.equal(a.grad, g_a)
    assert r0.grad is not None and torch.isfinite(r0.grad).all()


def test_factory_on_the_card_never_runs_the_plain_version(scene,
                                                          monkeypatch):
    env, fn = scene

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(k4, "plain_macro_episode", refuse)
    monkeypatch.setattr(k4, "plain_macro_episode_bwd", refuse)
    a, sched, mnext, mprev, r0, y0 = inputs(env, fn.plan, 0.5, False)
    a = a.requires_grad_(True)
    reward, queues = fn(a, sched, mnext, mprev, r0, y0)
    (-reward).backward()
    assert torch.isfinite(a.grad).all() and float(a.grad.abs().max()) > 0
