"""The fused spatial step's launch of many steps, compiled for the host,
against the plain PyTorch step.

``csrc/itscp_spatial_step.cu`` runs a launcher call's steps in one launch,
one block per episode looping over the steps, the carry in shared memory
for the launch where it fits (else in place in global memory). Built with
g++ against ``csrc/cpu_emulation.h`` and called through the card's C
launchers, on the micro and hybrid scenes of
``tests/test_torch_spatial_host.py`` and a micro scene of 40 lanes (more
than a warp, not a whole number of warps), each over at most 60 steps: the
micro scenes' whole episodes (T = 40), the hybrid scene's steps 100 to 159
from the plain step's state after 100 (its macro lanes first emit vehicles
after step 120):

* Forward, hard and soft, B = 1 and 4: one call of T steps, T calls of one
  step and calls split at odd steps give the same bits, and those bits are
  the plain step's at every step (the packed carry after each one-step
  call; the queues, events and waves of every step; the final carry), with
  the carry in shared memory and a reduction warp (B = 1 and 4), and with
  the carry in global memory and the reductions in thread 0 (B = 4; the
  kernel's way beyond 992 lanes).
* Derivative (forward-mode tangents, B = 2): one call, calls split at odd
  steps and one call with the carry in global memory and the reductions in
  thread 0 give the same bits;
  in the micro scenes, against the wrapper's plain version (the plain step
  in PyTorch's forward-mode AD) values equal, tangents and the float64
  gradient allclose(rtol 1e-5, atol 1e-6 * max), as in
  ``tests/test_torch_spatial_host.py`` (the two round their tangent
  formulas differently), which holds the hybrid scene's derivative against
  autograd.
"""

import ctypes
import functools

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
WIDE_MICRO_CFG = dict(MICRO_CFG, num_lane=3)  # 40 lanes
HYBRID_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                  speed_limit=20.0, cell_length=5.0, policy_length=16,
                  signal_length=2, simulation_frequency=10, random_seed=3,
                  max_num_micro_vehicle_per_lane=4, mode="hybrid")
TWO_PHASE_CFG = dict(HYBRID_CFG, signal_length=8)
SCENES = {"micro": MICRO_CFG, "micro40": WIDE_MICRO_CFG,
          "hybrid": HYBRID_CFG}
T_MAX = 60  # the steps a test runs


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation(
            "itscp_spatial_step", tmp_path_factory.mktemp("step"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    lib = k6.bind(ctypes.CDLL(str(path)))
    yield lib
    place(lib, "smem")


def place(lib, carry):
    """The carry in shared memory with a reduction warp ("smem"), or in
    global memory with the reductions in thread 0 ("global")."""
    lib.itscp_spatial_step_set_smem_cap(-1 if carry == "smem" else 0)
    lib.itscp_spatial_step_set_reduction_warp(int(carry == "smem"))


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


def splits(t0, t1, how):
    """The launcher calls ``(t, n)`` over steps t0 .. t1 - 1: one, one per
    step, or cut at odd steps."""
    if how == "one":
        return [(t0, t1 - t0)]
    if how == "steps":
        return [(t, 1) for t in range(t0, t1)]
    cuts = [t0, t0 + 1, t0 + 8, t0 + 21, t1]
    return [(a, b - a) for a, b in zip(cuts, cuts[1:]) if b > a]


def kernel_forward(lib, plan, inputs, B, state, t0, how, after_each=None):
    fb, ib = (x.clone() for x in state)
    q = torch.full((B, plan.T), float("nan"))
    ev = torch.full((B, plan.T, 3), -1, dtype=torch.int32)
    w = torch.full((B, plan.T), float("nan"))
    for t, n in splits(t0, min(plan.T, t0 + T_MAX), how):
        assert lib.launch_itscp_spatial_step_fwd(*k6.kernel_args(
            plan, (fb, None, ib), inputs, (q, ev, w), B, t, n, 0)) == 0
        if after_each:
            after_each(t + n - 1, fb, ib)
    return fb, ib, q, ev, w


@functools.lru_cache(maxsize=None)
def plain_case(scene, differentiable, B):
    """A scene's case and its plain forward (each carry placement checks
    against the same)."""
    plan, inputs = case(SCENES[scene], differentiable, B)
    t0 = 100 if scene == "hybrid" else 0
    return plan, inputs, t0, plain_forward(plan, inputs, B, t0)


def plain_forward(plan, inputs, B, t0):
    """The plain step's packed carry at step t0 and after each step from
    there, and its outputs of those steps."""
    a, rand, sched, mnext, mprev, routes = inputs
    carry, sg, ss = k6.initial_carry(plan, B, "cpu")
    g = k6.geometry(plan, "cpu")
    packed, outs = {}, []
    for t in range(min(plan.T, t0 + T_MAX)):
        if t == t0:
            start = k6.pack(plan, carry, sg, ss)
        out = k6.plain_spatial_step(plan, carry, sg, ss, t, a, rand[:, t],
                                    sched[t], mnext[t], mprev[t], routes, g)
        carry, sg, ss = out.carry, out.sg_ms, out.ss_ms
        if t >= t0:
            packed[t] = k6.pack(plan, carry, sg, ss)
            outs.append((out.queue, out.events, out.max_wave))
    q, ev, w = (torch.stack(x, 1) for x in zip(*outs))
    return start, packed, q, ev, w


@pytest.mark.parametrize("B, carry", [(1, "smem"), (4, "smem"),
                                      (4, "global")])
@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["hard", "soft"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_forward_calls_match_plain_step(lib, scene, differentiable, B,
                                        carry):
    plan, inputs, t0, plain = plain_case(scene, differentiable, B)
    start, packed, q, ev, w = plain
    place(lib, carry)
    t1 = t0 + q.shape[1]

    def same_as_plain(t, fb, ib):
        f2, i2 = packed[t]
        assert torch.equal(f2, fb) and torch.equal(i2, ib), t

    runs = {how: kernel_forward(lib, plan, inputs, B, start, t0, how,
                                same_as_plain if how == "steps" else None)
            for how in ("one", "steps", "odd")}
    for how, (fb, ib, kq, kev, kw) in runs.items():
        same_as_plain(t1 - 1, fb, ib)
        assert torch.equal(kq[:, t0:t1], q), how
        assert torch.equal(kev[:, t0:t1], ev), how
        assert torch.equal(kw[:, t0:t1], w), how
    assert torch.isfinite(q).all()
    tot = ev.sum((0, 1))
    assert int(tot[0] if scene != "hybrid" else tot[1]) > 0


def kernel_derivative(lib, plan, inputs, wq, B, how):
    fb, db, ib = k6.dual_state(plan, B, "cpu")
    g64 = torch.zeros(fb.shape[0], dtype=torch.float64)
    for t0, n in splits(0, plan.T, how):
        assert lib.launch_itscp_spatial_step_bwd(*k6.kernel_args(
            plan, (fb, db, ib), inputs, (wq, g64, None), B, t0, n, 0)) == 0
    return fb, db, ib, g64


@pytest.mark.parametrize("scene", ["micro", "micro40", "hybrid"])
def test_derivative_calls_match_forward_mode_plain_step(lib, scene):
    B = 2
    cfg = TWO_PHASE_CFG if scene == "hybrid" else SCENES[scene]
    plan, inputs = case(cfg, True, B)
    # the host runs the hybrid scene's 36 blocks in turn
    plan = plan._replace(T=24 if scene == "hybrid" else min(plan.T, T_MAX))
    wq = torch.as_tensor(np.random.default_rng(1).uniform(
        -1, 1, (B, plan.T)), dtype=torch.float32)
    ins = (inputs[0], inputs[1][:, :plan.T].contiguous(),
           *(x[:plan.T].contiguous() for x in inputs[2:5]), inputs[5])
    runs = []
    for carry, how in (("smem", "one"), ("smem", "odd"), ("global", "one")):
        place(lib, carry)
        runs.append(kernel_derivative(lib, plan, ins, wq, B, how))
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a, b)
    fb, db, ib, g64 = runs[0]
    assert torch.isfinite(g64).all() and g64.abs().max() > 0
    if scene == "hybrid":
        return
    plain = k6.dual_state(plan, B, "cpu")
    g_plain = torch.zeros(plain[0].shape[0], dtype=torch.float64)
    k6.spatial_step_bwd(plan, *plain, 0, plan.T, ins, wq, g_plain)
    assert torch.equal(plain[0], fb) and torch.equal(plain[2], ib)
    for a, b in ((plain[1], db), (g_plain, g64)):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))


def test_launch_of_no_steps_changes_nothing(lib):
    plan, inputs = case(MICRO_CFG, True, 1)
    state = k6.empty_state(plan, 1, "cpu")
    fb, ib, q, ev, w = kernel_forward(lib, plan, inputs, 1, state, 0, "odd")
    before = [x.clone() for x in (fb, ib, q, ev, w)]
    assert lib.launch_itscp_spatial_step_fwd(*k6.kernel_args(
        plan, (fb, None, ib), inputs, (q, ev, w), 1, 5, 0, 0)) == 0
    for a, b in zip(before, (fb, ib, q, ev, w)):
        assert torch.equal(a, b)
    assert lib.itscp_spatial_step_smem_carry(plan.L, plan.C, plan.V, plan.K,
                                             1) > \
        lib.itscp_spatial_step_smem_carry(plan.L, plan.C, plan.V, plan.K, 0)

