"""The lane-sharded step's CUDA source, compiled for the host, against the
plain per-shard bodies and the single-shard STEP kernel.

``csrc/itscp_spatial_shard.cu`` is built with g++ against
``csrc/cpu_emulation.h`` (one fiber per CUDA thread, the blocks of a grid
one after another) and driven through the same C launcher and the same
``ShardRun`` as on the card, S shards in one process with in-process
gathers.

* Forward, hard and soft: every launch of the five bodies (D3's the whole
  conversion, held against ``plain_body_D``) equals its plain version on
  the same inputs bit for bit
  (``ShardRun.checked_step``: carries, summary rows, events), and the whole
  episode's queues, events and wave maxima equal the single-shard plain
  episode's bit for bit.
* Derivative (``Dual`` kernels of A, B, C, D3, E, one block per episode
  and action entry): the action gradient equals the single-shard STEP
  derivative kernel's (host build of ``itscp_spatial_step.cu``) bit for bit
  over the whole episode, and the plain forward-mode sharded derivative
  within rtol 1e-5, atol 1e-6 * max|g| (the two round their tangent
  formulas differently, as for the STEP kernel), on the hybrid scene over
  its first 48 steps (the plain forward mode takes most of the test's time;
  ``test_torch_spatial_shard.py`` holds it bit-exact to the single-shard
  derivative). The hybrid scene runs with two signal phases there: the host
  runs the grid's blocks one after another.
* The launcher refuses what it does not take.
"""

import ctypes

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
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
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("k6shard")
    try:
        shard = _build.build_cpu_emulation("itscp_spatial_shard", out)
        step = _build.build_cpu_emulation("itscp_spatial_step", out)
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel sources: {err}")
    return ks.bind(ctypes.CDLL(str(shard))), k6.bind(ctypes.CDLL(str(step)))


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


@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
@pytest.mark.parametrize("cfg, S, every", [(MICRO_CFG, 2, 1),
                                           (MICRO_CFG, 4, 1),
                                           (HYBRID_CFG, 4, 8)],
                         ids=["micro-2", "micro-4", "hybrid-4"])
def test_forward_launches_match_plain_bodies(libs, cfg, S, every,
                                             differentiable):
    lib, _ = libs
    B = 2
    plan, inputs = case(cfg, differentiable, B)
    comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, S))
    before = dict(ks.launches)
    run = ks.ShardRun(plan, comm, inputs, dual=False, lib=lib)
    checked = 0
    for t in range(plan.T):
        if t % every == 0:
            run.checked_step(t)
            checked += 1
        else:
            run.step(t)
    queues, events, waves = run.outputs()
    ref = k6.plain_spatial_episode(plan, *inputs)
    assert torch.equal(queues, ref[0]) and torch.equal(events, ref[1])
    assert torch.equal(waves, ref[2])
    tot = events.sum((0, 1))
    assert int(tot[0] if cfg is MICRO_CFG else tot[1]) > 0
    # every launch of the forward counted, checked steps or not: four a
    # step and shard (D3's the conversion and the next step's A rows: no
    # D1 or D2 launch) and A once an episode and shard (step 0)
    assert 0 < checked <= plan.T
    launched = {k: ks.launches[k] - before[k] for k in before}
    for body in ("B", "C", "D3", "E"):
        assert launched[body] == S * plan.T
    assert launched["A"] == S
    assert "D1" not in launched and "D2" not in launched
    assert launched["Q"] == 1  # the queues, once per episode


@pytest.mark.parametrize("dual", [False, True], ids=["forward", "derivative"])
def test_queue_kernel_matches_plain_sums(libs, dual):
    """Q on gathered rows of mixed magnitudes: the forward's queues equal
    ``plain_queues``; the derivative's per-row terms, summed over the
    episodes as the wrapper sums them, equal ``plain_gradient``."""
    lib, _ = libs
    B = 2
    plan, inputs = case(MICRO_CFG, True, B)
    comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, 2))
    run = ks.ShardRun(plan, comm, inputs, dual=dual, lib=lib)
    rng = np.random.default_rng(5)
    rows = torch.as_tensor(rng.standard_normal((run.N, plan.T, plan.L)) *
                           10.0 ** rng.integers(-6, 4, (run.N, plan.T,
                                                        plan.L)),
                           dtype=torch.float32)
    wq = torch.as_tensor(rng.uniform(-1, 1, (B, plan.T)),
                         dtype=torch.float32)
    run.g = {"gq": rows, "q_weight": wq}
    before = ks.launches["Q_bwd" if dual else "Q"]
    run.launch("Q", 0, [0])
    assert ks.launches["Q_bwd" if dual else "Q"] == before + 1
    assert torch.equal(run.queues, ks.plain_queues(plan, rows))
    if dual:
        got = run.grad.view(B, -1).sum(0).to(torch.float32).view(
            plan.n_phases, plan.n_inter)
        assert torch.equal(got, ks.plain_gradient(plan, rows, wq))
    else:
        assert run.grad is None


@pytest.mark.parametrize("L", [None, 600], ids=["scene_L", "L600"])
@pytest.mark.parametrize("dual", [False, True], ids=["forward", "derivative"])
@pytest.mark.parametrize("B", [1, 4])
def test_queue_kernel_on_partial_tiles(libs, B, dual, L):
    """Q at T = 37, not a multiple of its tile of steps (32 at the scene's
    lanes, 20 at 600 lanes), B = 1 and 4: the queues equal
    ``plain_queues`` and the derivative's terms ``plain_gradient`` bit for
    bit, launched twice back to back (the derivative's count of finished
    tiles returns to 0 in between)."""
    lib, _ = libs
    plan, inputs = case(MICRO_CFG, True, B)
    run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, 2)),
                      inputs, dual=dual, lib=lib)
    T, L = 37, L or plan.L
    rng = np.random.default_rng(B + 10 * dual)
    rows = torch.as_tensor(rng.standard_normal((run.N, T, L)) *
                           10.0 ** rng.integers(-6, 4, (run.N, T, L)),
                           dtype=torch.float32)
    wq = torch.as_tensor(rng.uniform(-1, 1, (B, T)), dtype=torch.float32)
    queues = torch.full((run.N, T), float("nan"))
    grad = torch.zeros(run.N, dtype=torch.float64) if dual else None
    # Q reads only the sizes, dt and its own pointers: a copy of the run's
    # arguments at this T and L
    args = ks.ShardArgs.from_buffer_copy(run.shards[0][3])
    args.d_T, args.d_L = T, L
    for name, x in (("gq", rows), ("queues", queues), ("q_weight", wq),
                    ("grad", grad), ("q_count", run.q_count)):
        setattr(args, name, None if x is None else x.data_ptr())
    want = ks.plain_queues(plan, rows)
    for _ in range(2):
        assert lib.launch_itscp_shard(ks.KERNELS.index("Q"), int(dual),
                                      ctypes.byref(args), 1, None) == 0
        assert torch.equal(queues, want)
        if dual:
            got = grad.view(B, -1).sum(0).to(torch.float32).view(
                plan.n_phases, plan.n_inter)
            assert torch.equal(got, ks.plain_gradient(plan, rows, wq))
            assert int(run.q_count.abs().sum()) == 0


def cut(plan, inputs, wq, steps):
    """The first ``steps`` steps of an episode: plan, inputs, weights."""
    if steps >= plan.T:
        return plan, inputs, wq
    action, rand, sched, mnext, mprev, routes = inputs
    return (plan._replace(T=steps),
            (action, rand[:, :steps].contiguous(), sched[:steps].contiguous(),
             mnext[:steps].contiguous(), mprev[:steps].contiguous(), routes),
            wq[:, :steps].contiguous())


@pytest.mark.parametrize("cfg, S, steps", [(MICRO_CFG, 2, 1000),
                                           (TWO_PHASE_CFG, 4, 48)],
                         ids=["micro-2", "hybrid-4"])
def test_derivative_matches_step_kernel_and_forward_mode(libs, cfg, S,
                                                         steps):
    lib, step_lib = libs
    B = 2
    plan, inputs = case(cfg, True, B)
    wq = torch.as_tensor(np.random.default_rng(0).uniform(
        -1, 1, (B, plan.T)), dtype=torch.float32)
    comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, S))
    got = ks.ShardRun(plan, comm, inputs, dual=True, lib=lib).run().gradient(
        wq)
    fb, db, ib = k6.dual_state(plan, B, "cpu")
    g64 = torch.zeros(fb.shape[0], dtype=torch.float64)
    assert step_lib.launch_itscp_spatial_step_bwd(*k6.kernel_args(
        plan, (fb, db, ib), inputs, (wq, g64, None), B, 0, plan.T, 0)) == 0
    step = g64.view(B, -1).sum(0).to(torch.float32).view(plan.n_phases, -1)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, step)
    # the plain forward-mode derivative (PyTorch's forward AD through every
    # body, slow on the host) over the first `steps` steps
    plan, inputs, wq = cut(plan, inputs, wq, steps)
    got = ks.ShardRun(plan, comm, inputs, dual=True, lib=lib).run().gradient(
        wq)
    plain = ks.plain_sharded_episode_bwd(plan, comm, wq, *inputs)
    assert got.abs().max() > 0
    torch.testing.assert_close(got, plain, rtol=1e-5,
                               atol=1e-6 * float(plain.abs().max()))


def test_launcher_refuses_bad_launches(libs):
    lib, _ = libs
    plan, inputs = case(MICRO_CFG, True, 1)
    comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, 2))
    run = ks.ShardRun(plan, comm, inputs, dual=False, lib=lib)
    args = run.shards[0][3]
    run.step(0)
    call = lambda body, dual, repeat=1: lib.launch_itscp_shard(
        ks.KERNELS.index(body), dual, ctypes.byref(args), repeat, None)
    assert call("A", 0) == 0 and call("A", 0, 3) == 0
    assert call("A", 0, 0) != 0  # no launch
    assert lib.launch_itscp_shard(len(ks.KERNELS), 0, ctypes.byref(args),
                                  1, None) != 0  # no such body
    assert call("A", 1) != 0  # no tangent buffer
    assert call("Q", 0) != 0  # no gathered rows
    assert call("Q", 1) != 0  # a derivative without tangents and weights
    dual = ks.ShardRun(plan, comm, inputs, dual=True, lib=lib)
    dargs = dual.shards[0][3]
    dual.g = {"gq": dual.queues.new_zeros((dual.N, plan.T, plan.L)),
              "q_weight": dual.queues.new_zeros((1, plan.T))}
    dual.launch("Q", 0, [0])
    dargs.q_count = None
    assert lib.launch_itscp_shard(ks.KERNELS.index("Q"), 1,
                                  ctypes.byref(dargs), 1, None) != 0  # count
    args.gsg = None
    assert call("C", 0) != 0  # a soft step without the signal mean's terms
    args.t = plan.T  # past the last step
    assert call("A", 0) != 0
    args.t, args.off, args.n = 0, 1, plan.L  # the shard overruns the scene
    assert call("A", 0) != 0
    assert lib.itscp_shard_args_size() == ctypes.sizeof(ks.ShardArgs)
