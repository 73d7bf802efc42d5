"""STEP's launch of many steps on the card (skipped without a CUDA device),
at the 3x3 hybrid preset of ``run_itscp_hybrid.sh`` (144 lanes, T = 600
steps at 30 Hz, 45 actions).

* Forward, hard and soft, B = 1 and 4 episodes: one launcher call of T
  steps, T calls of one step and calls split at odd steps give the same
  carry, queues, events and waves, bit for bit.
* Derivative, B = 1 and 4 (45 B dual episodes), over steps 100-111 from
  the soft forward's state after 100 steps (zero tangents there): against
  the wrapper's plain version on the card (the plain step in PyTorch's
  forward-mode AD, action entry by action entry; 12 steps keep it to
  seconds): integer carry equal, float carry allclose(rtol 1e-6, atol
  1e-6) (the chip_smoke step check's standard), tangents and float64
  gradient allclose(rtol 1e-4, atol 1e-6 * max) and the gradient's cosine
  > 0.99999; one call and split calls bit-equal.
* The lane-sharded episode at S = 2 (both shards in this process) against
  the STEP episode on the same draws: queues, events and waves bit-equal
  (both add each step's lanes in lane order); its derivative's cosine >
  0.99999 against STEP's.

This file imports nothing of JAX::

    python -m pytest --noconftest -q tests/test_torch_card_spatial_redesign.py
"""

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6

torch.set_num_threads(1)

PRESET = dict(num_intersection=3, num_lane=1, lane_length=5, speed_limit=60,
              policy_length=20, signal_length=4, simulation_frequency=30,
              mode="hybrid", random_seed=3)


@pytest.fixture(scope="module")
def env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    e = ItscpEnv(config=PRESET, schedule_fn=problem.problem_1,
                 device=torch.device("cuda"))
    e.reset()
    return e


def inputs_of(env, B, seed, action=0.55):
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    if np.isscalar(action):
        action = np.full(env.action_size(), action)
    a = torch.as_tensor(action, dtype=torch.float32, device=env.device)
    d = env.data
    return (a.reshape(env.n_phases, -1).contiguous(), rand, d.schedule,
            d.mroute_next, d.mroute_prev,
            k6.route_table(d.inj_routes, env.base_state.route_pool))


def splits(T, how):
    if how == "one":
        return [(0, T)]
    if how == "steps":
        return [(t, 1) for t in range(T)]
    cuts = [0, 1, 8, 21, 250, 377, T]
    return [(a, b - a) for a, b in zip(cuts, cuts[1:])]


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
def test_forward_calls_give_the_same_bits(env, differentiable, B):
    plan = k6.make_plan(env, differentiable)
    ins = inputs_of(env, B, 51 + B)
    dev = env.device
    runs = {}
    for how in ("one", "steps", "odd"):
        fb, ib = k6.empty_state(plan, B, dev)
        q = torch.full((B, plan.T), float("nan"), device=dev)
        ev = torch.full((B, plan.T, 3), -1, dtype=torch.int32, device=dev)
        w = torch.full((B, plan.T), float("nan"), device=dev)
        before = dict(k6.kernel_launches)
        for t0, n in splits(plan.T, how):
            k6.spatial_step_fwd(plan, fb, ib, t0, n, ins, q, ev, w)
        assert k6.kernel_launches["fwd"] - before["fwd"] == \
            len(splits(plan.T, how))
        runs[how] = (fb, ib, q, ev, w)
    for how in ("steps", "odd"):
        for a, b in zip(runs["one"], runs[how]):
            assert torch.equal(a, b), how
    q, ev = runs["one"][2], runs["one"][3]
    assert torch.isfinite(q).all() and int(ev[..., 1].sum()) > 0


@pytest.mark.parametrize("B", [1, 4])
def test_derivative_rows_match_forward_mode_plain_step(env, B):
    T0, N = 100, 12
    plan = k6.make_plan(env, True)
    n_act = plan.n_phases * plan.n_inter
    rng = np.random.default_rng(5 + B)
    ins = inputs_of(env, B, 61 + B, rng.uniform(0.3, 0.7, env.action_size()))
    dev = env.device
    wq = torch.as_tensor(rng.uniform(-1, 1, (B, plan.T)),
                         dtype=torch.float32, device=dev)
    # the dual rows start from the soft forward's state after T0 steps,
    # with zero tangents: steps T0 .. T0 + N - 1 carry traffic
    fb, ib = k6.empty_state(plan, B, dev)
    q = torch.zeros((B, plan.T), device=dev)
    ev = torch.zeros((B, plan.T, 3), dtype=torch.int32, device=dev)
    k6.spatial_step_fwd(plan, fb, ib, 0, T0, ins, q, ev, torch.zeros_like(q))
    start = (fb.repeat_interleave(n_act, 0), torch.zeros_like(
        fb.repeat_interleave(n_act, 0)), ib.repeat_interleave(n_act, 0))
    runs = []
    for cuts in ([(T0, N)], [(T0, 1), (T0 + 1, 4), (T0 + 5, N - 5)]):
        state = [x.clone() for x in start]
        g64 = torch.zeros(B * n_act, dtype=torch.float64, device=dev)
        for t0, n in cuts:
            k6.spatial_step_bwd(plan, *state, t0, n, ins, wq, g64)
        runs.append((*state, g64))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    fb, db, ib, g64 = runs[0]
    assert fb.shape[0] == 45 * B
    plain = [x.clone() for x in start]
    g_plain = torch.zeros_like(g64)
    k6.plain_spatial_step_bwd(plan, *plain, T0, N, ins, wq, g_plain)
    assert torch.equal(plain[2], ib)
    torch.testing.assert_close(fb, plain[0], rtol=1e-6, atol=1e-6)
    for got, ref in ((db, plain[1]), (g64, g_plain)):
        assert torch.isfinite(got).all() and got.abs().max() > 0
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-6 * float(ref.abs().max()))
    cos = float(g64 @ g_plain / (g64.norm() * g_plain.norm()))
    assert cos > 0.99999


def test_sharded_episode_is_bit_equal_to_step(env):
    plan = k6.make_plan(env, True)
    ins = inputs_of(env, 1, 71)
    comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, 2))
    step = k6.spatial_episode_fwd(plan, *ins)
    sharded = ks.shard_episode_fwd(plan, comm, *ins)
    for a, b in zip(step, sharded):
        assert torch.equal(a, b)
    assert int(step[1][..., 1].sum()) > 0
    w = torch.full((1, plan.T), -1.0, device=env.device)
    g_step = k6.spatial_episode_bwd(plan, w, *ins).double().flatten()
    g_shard = ks.shard_episode_bwd(plan, comm, w, *ins).double().flatten()
    assert torch.isfinite(g_step).all() and g_step.norm() > 0
    assert float(g_step @ g_shard /
                 (g_step.norm() * g_shard.norm())) > 0.99999

