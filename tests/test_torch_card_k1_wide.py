"""Kernel K1 on scenes wider than one block, on the card (skipped without a
CUDA device; this file imports nothing of JAX)::

    python -m pytest --noconftest -q tests/test_torch_card_k1_wide.py

The scenes are the 5x5, 7x7 and 9x9 hybrid grids of ``run_itscp_5x5.sh``'s
flags (lane length 5, 60 m/s, 30 Hz, signal length 4; 400, 784 and 1,296
lanes) cut to ``policy_length`` 5, T = 150 steps: at T = 60 no vehicle is
injected or emitted yet on any of them, and at T = 150 every grid
converts vehicles. ``make_plan``
picks the layouts: 5x5 forward in shared memory and backward in global
memory, 7x7 global both ways, 9x9 global with two lanes a thread.

* the forward, hard, soft and ``st``, against the plain version on the
  card: events exact, reward rel 1e-5, queues abs 1e-4;
* the backward, soft and ``st``, against autograd of the plain version:
  cosine > 0.999, ``allclose(rtol=2e-2, atol=2e-3 * max|g|)``;
* at 5x5, a launch of four episodes bit-equal to four single launches;
* at 5x5 and 7x7, which the fused spatial step also takes, K1's episode
  against STEP's on the same draws: events equal, reward rel 1e-5;
* at 3x3 and on each grid, the layout the library picks on the card from
  its kernels' attributes is the one a CPU plan records.
"""

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1
from dhts_torch.ops.cuda import itscp_spatial_step as k6

torch.set_num_threads(1)

# run_itscp_5x5.sh's flags at T = 150
WIDE = dict(num_lane=1, lane_length=5, speed_limit=60, signal_length=4,
            policy_length=5, mode="hybrid", use_fused_episode=True,
            random_seed=3)
GRIDS = (5, 7, 9)
LAYOUTS = {5: (1, ("shared", "global")), 7: (1, ("global", "global")),
           9: (2, ("global", "global"))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU path")
    return torch.device("cuda")


_envs = {}


def wide_env(n, dev, gate_mode="soft"):
    key = (n, gate_mode)
    if key not in _envs:
        cfg = dict(WIDE, num_intersection=n, gate_mode=gate_mode)
        env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device=dev)
        env.reset()
        _envs[key] = env
    return _envs[key]


def inputs_for(env, seed):
    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    action = torch.as_tensor(np.random.default_rng(seed).uniform(
        0.3, 0.7, (env.n_phases, env.action_size() // env.n_phases)),
        dtype=torch.float32, device=dev)
    return (action, env.data.schedule, env.data.mroute_next,
            env.data.mroute_prev, env.draw_rand(gen), env.data.inj_routes,
            env.base_state.route_pool)


@pytest.mark.parametrize("mode", ["hard", "soft", "st"])
@pytest.mark.parametrize("n", GRIDS)
def test_wide_forward_matches_plain_version(cuda, n, mode):
    env = wide_env(n, cuda, "st" if mode == "st" else "soft")
    plan = env.fused_plan(mode != "hard")
    assert (plan.lanes_per_thread, plan.placement) == LAYOUTS[n]
    ins = inputs_for(env, 3)
    before = k1.itscp_hybrid_episode_fwd.launches[plan.mode]
    kr, kq, ke = (x.cpu() for x in k1.itscp_hybrid_episode_fwd(plan, *ins))
    assert k1.itscp_hybrid_episode_fwd.launches[plan.mode] == before + 1
    with torch.no_grad():
        pr, pq, pe = (x.cpu() for x in k1.plain_episode(plan, *ins))
    assert torch.equal(ke, pe), (ke != pe).any(1).sum()
    assert float(kr) == pytest.approx(float(pr), rel=1e-5)
    assert float((kq - pq).abs().max()) <= 1e-4
    assert pe[:, 1].sum() >= 1  # vehicles emitted: conversions ran


@pytest.mark.parametrize("mode", ["soft", "st"])
@pytest.mark.parametrize("n", GRIDS)
def test_wide_backward_matches_autograd(cuda, n, mode):
    env = wide_env(n, cuda, mode)
    plan = env.fused_plan(True)
    ins = inputs_for(env, 4)
    w = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, plan.T),
                        dtype=torch.float32, device=cuda)
    before = k1.itscp_hybrid_episode_bwd.launches
    got = k1.itscp_hybrid_episode_bwd(plan, w, *ins).cpu().double().ravel()
    assert k1.itscp_hybrid_episode_bwd.launches == before + 1
    ref = k1.plain_episode_bwd(plan, w, *ins).cpu().double().ravel()
    assert torch.isfinite(got).all() and float(got.norm()) > 0
    cos = float(got @ ref / (got.norm() * ref.norm()))
    assert cos > 0.999, cos
    assert torch.allclose(got, ref, rtol=2e-2,
                          atol=2e-3 * float(ref.abs().max()))


@pytest.mark.parametrize("mode", ["hard", "soft", "bwd"])
def test_wide_batch_equals_single_launches(cuda, mode):
    env = wide_env(5, cuda)
    plan = env.fused_plan(mode != "hard")
    B = 4
    rows = [inputs_for(env, 10 + e) for e in range(B)]
    stacked = tuple(torch.stack([r[i] for r in rows]) if i in (0, 4)
                    else rows[0][i] for i in range(7))
    if mode == "bwd":
        w = torch.as_tensor(np.random.default_rng(1).uniform(
            -1, 1, (B, plan.T)), dtype=torch.float32, device=cuda)
        batch = (k1.itscp_hybrid_episode_bwd(plan, w, *stacked),)
        singles = [(k1.itscp_hybrid_episode_bwd(plan, w[e].contiguous(),
                                                *rows[e]),)
                   for e in range(B)]
    else:
        batch = k1.itscp_hybrid_episode_fwd(plan, *stacked)
        singles = [k1.itscp_hybrid_episode_fwd(plan, *rows[e])
                   for e in range(B)]
    for e in range(B):
        for x, y in zip(batch, singles[e]):
            assert torch.equal(x[e], y), (mode, e)


@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("n", [5, 7])
def test_wide_episode_matches_step_kernel(cuda, n, mode):
    env = wide_env(n, cuda)
    soft = mode == "soft"
    plan = env.fused_plan(soft)
    ins = inputs_for(env, 5)
    r1, q1, e1 = (x.cpu() for x in k1.itscp_hybrid_episode_fwd(plan, *ins))
    splan = k6.make_plan(env, soft)
    d = env.data
    q, ev, _ = k6.spatial_episode_fwd(
        splan, ins[0], ins[4][None], d.schedule, d.mroute_next,
        d.mroute_prev, k6.route_table(d.inj_routes,
                                      env.base_state.route_pool))
    assert torch.equal(ev[0].cpu().float(), e1[:, :3])
    reward = -float(q[0].sum())
    assert reward == pytest.approx(float(r1), rel=1e-5)


@pytest.mark.parametrize("n", (3, *GRIDS))
def test_card_layout_is_the_cpu_plans(cuda, n):
    layouts = {}
    for dev in ("cpu", cuda):
        env = ItscpEnv(config=dict(WIDE, num_intersection=n),
                       schedule_fn=problem.problem_1, device=dev)
        env.reset()
        layouts[str(dev)] = [(p.lanes_per_thread, p.placement) for p in
                             (env.fused_plan(False), env.fused_plan(True))]
    expected = LAYOUTS.get(n, (1, ("shared", "shared")))
    assert layouts["cpu"] == [expected] * 2
    assert layouts[str(cuda)] == layouts["cpu"]
