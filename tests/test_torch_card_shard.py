"""The lane-sharded step's kernels on the card (skipped without a CUDA
device). C and E against their plain bodies at S = 2 and 4, B = 1 and 4,
hard, soft and the derivative, the sharded episode and gradient against
the STEP kernel's, and the 9x9 scene at S = 4 (below). Q: the episode's
queues summed from gathered ``q^2`` rows at the 3x3
hybrid preset of ``run_itscp_hybrid.sh`` (T = 600 steps, 144 lanes, 45
actions), B = 1 and 4 episodes, forward and derivative, on rows of mixed
magnitudes, against ``plain_queues`` and ``plain_gradient`` on the same
rows: bit-equal (both add each step's lanes in lane order and the
derivative's weighted terms in step order, in float64), and again after 3
launches back to back (the derivative's per-row count of finished tiles
returns to 0). This file imports nothing of JAX::

    python -m pytest --noconftest -q tests/test_torch_card_shard.py
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
    e = ItscpEnv(config=PRESET, schedule_fn=problem.problem_1,
                 device=torch.device("cuda"))
    e.reset()
    return e


@pytest.mark.parametrize("dual", [False, True], ids=["forward", "derivative"])
@pytest.mark.parametrize("B", [1, 4])
def test_queue_kernel_matches_plain_sums(env, B, dual):
    plan = k6.make_plan(env, True)
    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(B)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    d = env.data
    inputs = (torch.full((plan.n_phases, plan.n_inter), 0.55, device=dev),
              rand, d.schedule, d.mroute_next, d.mroute_prev,
              k6.route_table(d.inj_routes, env.base_state.route_pool))
    run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, 4)),
                      inputs, dual=dual)
    rng = np.random.default_rng(5 + B)
    shape = (run.N, plan.T, plan.L)
    rows = torch.as_tensor(rng.standard_normal(shape) *
                           10.0 ** rng.integers(-6, 4, shape),
                           dtype=torch.float32, device=dev)
    wq = torch.as_tensor(rng.uniform(-1, 1, (B, plan.T)),
                         dtype=torch.float32, device=dev)
    run.g = {"gq": rows, "q_weight": wq}
    want_q = ks.plain_queues(plan, rows)
    want_g = ks.plain_gradient(plan, rows, wq) if dual else None
    for repeat in (1, 3):
        run.queues.fill_(float("nan"))
        run.launch("Q", 0, [0], repeat=repeat)
        torch.cuda.synchronize()
        assert torch.equal(run.queues, want_q)
        if dual:
            got = run.grad.view(B, -1).sum(0).to(torch.float32).view(
                plan.n_phases, plan.n_inter)
            assert torch.equal(got, want_g)
            assert int(run.q_count.abs().sum()) == 0


# ---------------------------------------------------------------------------
# C and E (a reduction warp beside the lanes; C's lanes over SPLIT threads
# each) against their plain bodies, and the sharded episode against STEP's
# ---------------------------------------------------------------------------

NINE = dict(PRESET, num_intersection=9, policy_length=2)


@pytest.fixture(scope="module")
def nine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU path")
    e = ItscpEnv(config=NINE, schedule_fn=problem.problem_1,
                 device=torch.device("cuda"))
    e.reset(3)
    return e


def episode_inputs(env, plan, B, seed):
    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    d = env.data
    a = np.random.default_rng(seed).uniform(0.3, 0.7, env.action_size())
    return (torch.as_tensor(a, dtype=torch.float32, device=dev).view(
                plan.n_phases, plan.n_inter),
            rand, d.schedule, d.mroute_next, d.mroute_prev,
            k6.route_table(d.inj_routes, env.base_state.route_pool))


def step_kernel_episode(plan, inputs, B):
    """The single-shard STEP kernel's episode: queues, events, waves."""
    from dhts_torch.ops.cuda import _launch

    dev = inputs[1].device
    fb, ib = k6.empty_state(plan, B, dev)
    outs = [torch.zeros((B, plan.T), device=dev),
            torch.zeros((B, plan.T, 3), dtype=torch.int32, device=dev),
            torch.zeros((B, plan.T), device=dev)]
    lib = k6._library()
    _launch.raise_on(lib.launch_itscp_spatial_step_fwd(*k6.kernel_args(
        plan, (fb, None, ib), inputs, outs, B, 0, plan.T,
        _launch.stream(dev))), "STEP")
    return outs


@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [2, 4])
def test_forward_launches_match_plain_bodies(env, S, B, mode):
    """Every 50th step's seven launches against their plain bodies on the
    card (integers equal, floats allclose(rtol 1e-6, atol 1e-6), as in
    ``chip_smoke.py``: PyTorch's CUDA operators may round otherwise); the
    episode's queues, events and waves equal the STEP kernel's."""
    plan = k6.make_plan(env, mode == "soft")
    inputs = episode_inputs(env, plan, B, 40 + B)
    run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, S)),
                      inputs, dual=False)
    for t in range(plan.T):
        if t % 50 == 7:
            run.checked_step(t, 1e-6, 1e-6)
        else:
            run.step(t)
    got = run.outputs()
    ref = step_kernel_episode(plan, inputs, B)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    assert int(got[1][..., 1].sum()) > 0  # vehicles were emitted


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [2, 4])
def test_derivative_launches_match_plain_forward_mode(env, S, B):
    """The derivative's C and E launches at steps 107, 307 and 507 against
    their plain bodies under forward-mode AD on the card (values
    allclose(rtol 1e-6, atol 1e-6), tangents allclose(rtol 1e-5, atol 1e-5
    times the output's largest)); the gradient equals the STEP derivative
    kernel's bit for bit."""
    from dhts_torch.ops.cuda import _launch

    plan = k6.make_plan(env, True)
    inputs = episode_inputs(env, plan, B, 60 + B)
    dev = env.device
    wq = torch.as_tensor(np.random.default_rng(B).uniform(-1, 1, (
        B, plan.T)), dtype=torch.float32, device=dev)
    run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, S)),
                      inputs, dual=True)
    for t in range(plan.T):
        if t in (107, 307, 507):
            run.checked_dual_step(t, value_tol=(1e-6, 1e-6))
        else:
            run.step(t)
    got = run.gradient(wq)
    fb, db, ib = k6.dual_state(plan, B, dev)
    g64 = torch.zeros(fb.shape[0], dtype=torch.float64, device=dev)
    _launch.raise_on(k6._library().launch_itscp_spatial_step_bwd(
        *k6.kernel_args(plan, (fb, db, ib), inputs, (wq, g64, None), B, 0,
                        plan.T, _launch.stream(dev))), "STEP derivative")
    step = g64.view(B, -1).sum(0).to(torch.float32).view(plan.n_phases, -1)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, step)


@pytest.mark.parametrize("mode", ["hard", "soft", "dual"])
def test_nine_by_nine(nine, mode):
    """The 9x9 scene (1,296 lanes, T = 60) at S = 4: every 20th step's
    launches against their plain bodies (the derivative's C and E under
    forward-mode AD, the first 30 steps), the forward episode equal to the
    plain single-shard episode."""
    plan = k6.make_plan(nine, mode != "hard")
    inputs = episode_inputs(nine, plan, 1, 9)
    comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, 4))
    dual = mode == "dual"
    if dual:
        plan = plan._replace(T=30)
        a, rand, sched, mnext, mprev, routes = inputs
        inputs = (a, rand[:, :30].contiguous(), sched[:30].contiguous(),
                  mnext[:30].contiguous(), mprev[:30].contiguous(), routes)
    run = ks.ShardRun(plan, comm, inputs, dual=dual)
    for t in range(plan.T):
        if t % 20 == 5 and dual:
            run.checked_dual_step(t, value_tol=(1e-6, 1e-6))
        elif t % 20 == 5:
            run.checked_step(t, 1e-6, 1e-6)
        else:
            run.step(t)
    if dual:
        return
    got = run.outputs()
    ref = k6.plain_spatial_episode(plan, *inputs)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
