"""NaN probes of the fused spatial step's conversion events.

A masked-out ``where`` branch with unsafe operands gives a NaN gradient
(the JAX package's dead-branch lesson); ``torch.where`` has
the same hazard. Three scenes of the 3x3 hybrid grid (soft gates), each
built by hand as one step's carry:

* a macro source lane full to capacity (r = 1, u = 0) before a micro lane,
  its flux capacitor one step from full: it empties into the green
  boundary, the capacitor fills and a vehicle is emitted;
* a micro lane with one vehicle and no leader anywhere on its route (every
  other lane empty): the head sees the free road (pd = 1000);
* two touching vehicles (gap 0) at a micro -> macro absorption: the head is
  past its lane's end by more than its length and is deposited into the
  macro lane.

In each, the event fires, the plain step's autograd gradient of the queue
and of every float output with respect to the float carry and the action is
finite, and so is the host-built derivative kernel's (its tangent carry,
seeded at random, and its action gradient after the step).
"""

import ctypes

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops import arz
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_spatial_step as k6

torch.set_num_threads(1)

HYBRID_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                  speed_limit=20.0, cell_length=5.0, policy_length=16,
                  signal_length=8, simulation_frequency=10, random_seed=3,
                  max_num_micro_vehicle_per_lane=4, mode="hybrid")
I = {n: i for i, n in enumerate(k6.CNAMES)}
FLOATS = [i for i, n in enumerate(k6.CNAMES) if i in k6.CARRY_DIFF]
T0 = 40  # the step of the probe: half way through the first signal phase


@pytest.fixture(scope="module")
def scene():
    env = ItscpEnv(config=HYBRID_CFG, schedule_fn=problem.problem_1,
                   device="cpu")
    env.reset()
    plan = k6.make_plan(env, True)
    g = k6.geometry(plan, "cpu")
    routes = k6.route_table(env.data.inj_routes, env.base_state.route_pool)
    return env, plan, g, routes


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation(
            "itscp_spatial_step", tmp_path_factory.mktemp("k6probe"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return k6.bind(ctypes.CDLL(str(path)))


def green_action(plan, g, lane):
    """An action whose signal at step T0 is green on ``lane``."""
    for v in (0.9, 0.1):
        a = torch.full((plan.n_phases, plan.n_inter), v)
        if float(k6.lane_signals(plan, a, T0, True, g)[lane]) > 0.5:
            return a
    raise AssertionError(f"no green action for lane {lane}")


def empty(plan):
    """``(carry as a list, sg_ms, ss_ms)`` of one empty episode."""
    carry, sg, ss = k6.initial_carry(plan, 1, "cpu")
    return list(carry), sg, ss


def source_full_scene(plan, g, routes):
    """Macro lane 19 (one cell, jammed) before micro lane 68."""
    src, dst = 19, 68
    assert g.is_macro[src] and not g.is_macro[dst]
    carry, sg, ss = empty(plan)
    r, y, cap = carry[I["r"]], carry[I["y"]], carry[I["cap"]]
    r[0, :, src] = 1.0
    y[0, :, src] = arz.compute_y(torch.ones(()), torch.zeros(()),
                                 float(plan.floats[0]))
    slot = int(torch.nonzero(g.next_k[:, src] == dst)[0])
    cap[0, slot, src] = plan.floats[2] - 1e-3
    mnext = torch.full((plan.L,), -1, dtype=torch.int32)
    mnext[src] = dst
    return carry, sg, ss, mnext, green_action(plan, g, src), 1


def free_road_scene(plan, g, routes):
    """One vehicle on micro lane 68, every other lane empty."""
    lane = 68
    carry, sg, ss = empty(plan)
    rid = int(torch.nonzero(routes[:, 0] == lane)[0])
    carry[I["count"]][0, lane] = 1
    carry[I["pos"]][0, 0, lane] = 1.0
    carry[I["vel"]][0, 0, lane] = 3.0
    carry[I["rid"]][0, 0, lane] = rid
    mnext = torch.full((plan.L,), -1, dtype=torch.int32)
    return carry, sg, ss, mnext, green_action(plan, g, lane), None


def absorption_scene(plan, g, routes):
    """Two touching vehicles on a micro lane whose next route lane is
    macro; the head is past the lane's end by more than its length."""
    R = routes.shape[1]
    for rid in range(routes.shape[0]):
        for j in range(R - 1):
            lane, nxt = int(routes[rid, j]), int(routes[rid, j + 1])
            if lane >= 0 and nxt >= 0 and not g.is_macro[lane] and \
                    g.is_macro[nxt]:
                break
        else:
            continue
        break
    carry, sg, ss = empty(plan)
    veh_len = plan.floats[2]
    head = float(g.length[lane]) + veh_len + 2.0
    carry[I["count"]][0, lane] = 2
    carry[I["pos"]][0, :2, lane] = torch.tensor([head - veh_len, head])
    carry[I["vel"]][0, :2, lane] = torch.tensor([4.0, 4.0])
    carry[I["av"]][0, :2, lane] = veh_len
    carry[I["rid"]][0, :2, lane] = rid
    carry[I["ridx"]][0, :2, lane] = j
    mnext = torch.full((plan.L,), -1, dtype=torch.int32)
    return carry, sg, ss, mnext, green_action(plan, g, lane), 2


SCENES = {"source_full": source_full_scene, "free_road": free_road_scene,
          "absorption": absorption_scene}


@pytest.mark.parametrize("name", list(SCENES))
def test_conversion_events_have_finite_gradients(scene, lib, name):
    env, plan, g, routes = scene
    carry, sg, ss, mnext, action, event = SCENES[name](plan, g, routes)
    L, T = plan.L, plan.T
    rand = torch.full((1, L), 2.0)
    sched = torch.zeros(L)
    mprev = torch.full((L,), -1, dtype=torch.int32)

    # plain step, autograd
    leaves = {i: carry[i].clone().requires_grad_(True) for i in FLOATS}
    a = action.clone().requires_grad_(True)
    ins = [leaves.get(i, x) for i, x in enumerate(carry)]
    out = k6.plain_spatial_step(plan, tuple(ins), sg, ss, T0, a, rand,
                                sched, mnext, mprev, routes, g)
    if event is None:
        lane = 68
        new_vel = float(out.carry[I["vel"]][0, 0, lane].detach())
        assert new_vel > 3.0 + 0.5 * float(
            plan.floats[1]) * float(plan.floats[6])  # free-road accel
    else:
        assert int(out.events[0, event]) >= 1, out.events
    rng = np.random.default_rng(0)
    loss = out.queue.sum()
    for x in out.carry:
        if x.is_floating_point():
            loss = loss + (x * torch.as_tensor(
                rng.normal(size=x.shape), dtype=torch.float32)).sum()
    loss.backward()
    for i, leaf in leaves.items():
        assert torch.isfinite(leaf.grad).all(), k6.CNAMES[i]
    assert torch.isfinite(a.grad).all()

    # host-built derivative: one step from the same carry, random tangents
    n_act = plan.n_phases * plan.n_inter
    fb, ib = k6.pack(plan, tuple(x.detach() for x in carry), sg, ss)
    fb, ib = fb.repeat(n_act, 1), ib.repeat(n_act, 1)
    db = torch.zeros_like(fb)
    fo = k6.float_layout(plan)
    for i in FLOATS:
        o, n = fo[k6.CNAMES[i]], carry[i][0].numel()
        db[:, o:o + n] = torch.as_tensor(rng.normal(size=(n_act, n)),
                                         dtype=torch.float32)

    def full(row, fill):
        x = torch.full((T, L), fill, dtype=row.dtype)
        x[T0] = row
        return x

    kins = (action.contiguous(), full(rand[0], 2.0)[None].contiguous(),
            full(sched, 0.0), full(mnext, -1), full(mprev, -1), routes)
    g64 = torch.zeros(n_act, dtype=torch.float64)
    w = torch.ones(1, T)
    assert lib.launch_itscp_spatial_step_bwd(*k6.kernel_args(
        plan, (fb, db, ib), kins, (w, g64, None), 1, T0, 1, 0)) == 0
    assert torch.isfinite(db).all() and torch.isfinite(g64).all()
    assert torch.isfinite(fb).all()
