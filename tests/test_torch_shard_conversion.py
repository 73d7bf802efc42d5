"""The lane-sharded step's conversion as one body, and the next step's A
rows written by it, on the CPU: ``plain_body_D`` (JAX's D1, D2 and D3 from
the rows gathered after C alone, the plain version of the D3 launch)
inside ``plain_shard_step`` on the kernels' schedule (the step's A rows
as the step before gathered them with its static terms) against the
seven-body composition it replaces, :func:`seven_body_step` (A and its
gather, D1, a gather of the wants, D2, a gather of the arbitration, D3:
JAX's ``step_sharded``; ``tests/test_torch_spatial_shard.py`` holds the
three bodies and ``plain_body_D`` against JAX's bodies), and against the
step with A launched at every step, :func:`a_every_step` (the schedule
before D3 wrote the next step's A rows).

* The three steps from the same state, step after step through the
  scene's last step, S = 2 and 4 local shards (no process group), hard
  and soft, B = 1 and 4: carries, running means, squared queues, events
  and wave maxima bit-equal, and the A rows each step starts from equal
  to those A gathers at the step (their injection row > 0 at some step
  of a scene that injects; none after the last step). Over the steps
  where the conversion works: the micro scene's steps 0-39 (injections,
  then transfers and exits), the hybrid scene's 116-159 from the plain
  state at 116 (emissions; in soft mode deposits), and steps 140-172 of
  the 3x3 hybrid preset of ``run_itscp_hybrid.sh`` (144 lanes, 30 Hz:
  emissions, transfers, deposits) from its plain state at 140
  (``tests/test_torch_shard_conversion_preset.py``). Each kind of event
  the scene has is asserted to happen (> 0).
* The step's collectives: ``plain_shard_step`` gathers once (``gF``
  with ``gI``) and sums twice (the running means' terms, the next step's
  A rows with the static terms; once in hard mode on a split lane axis),
  plus A's gather at the first step; :func:`a_every_step` gathers twice,
  the seven-body step four times.
* ``plain_arbitration`` equals the seven-body step's gathered wants and
  verdicts at every lane.

The sharded episode and its forward-mode derivative under the new step
stay bit-equal to the single-shard plain episode and its derivative:
``tests/test_torch_spatial_shard.py``. The D3 kernel against
``plain_body_D``: ``tests/test_torch_shard_conversion_host.py``.
"""

import functools

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6

torch.set_num_threads(1)

HYBRID = dict(num_intersection=3, num_lane=1, lane_length=5.0,
              speed_limit=20.0, cell_length=5.0, policy_length=16,
              signal_length=2, simulation_frequency=10, random_seed=3,
              max_num_micro_vehicle_per_lane=4, mode="hybrid")
MICRO = dict(num_intersection=2, num_lane=2, lane_length=20.0,
             speed_limit=30.0, policy_length=8, signal_length=2,
             simulation_frequency=10, random_seed=5, mode="micro")
PRESET = dict(num_intersection=3, num_lane=1, lane_length=5, speed_limit=60,
              policy_length=20, signal_length=4, simulation_frequency=30,
              mode="hybrid", random_seed=3)
# scene: config, first step, last step, the events it must show (of
# injected, emitted, exited, transferred, deposited)
SCENES = {"micro": (MICRO, 0, 39, ("injected", "transferred", "exited")),
          "hybrid": (HYBRID, 116, 159, ("emitted", "transferred",
                                        "deposited")),
          "preset": (PRESET, 140, 172, ("emitted", "transferred",
                                        "deposited"))}
EVENTS = ("injected", "emitted", "exited", "transferred", "deposited")


class CountingComm(ks.LaneComm):
    """A LaneComm of local shards that counts its gathers by kind."""

    def __init__(self, L, shards):
        super().__init__(L, shards)
        self.calls = {"all_gather": 0, "psum": 0}

    def gather(self, parts, kind="all_gather"):
        self.calls[kind] += 1
        return super().gather(parts, kind)


def a_every_step(plan, g, comm, states, t, action2d, rand_t, sched_t,
                 mnext_t, mprev_t, routes):
    """The step with A launched and gathered at every step: the five
    bodies (A, B, C, ``plain_body_D``, E), two gathers and two sums (one
    in hard mode on a split lane axis). Returns ``plain_shard_step``'s
    outputs and the step's gathered A rows."""
    lgs = [ks.local_geometry(g, s) for s in comm.shards]
    cols = [s.cols for s in comm.shards]
    sumA = [ks.plain_body_A(plan, lg, st[0], rand_t[:, c], sched_t[c])
            for lg, st, c in zip(lgs, states, cols)]
    (gA,) = comm.gather([[x] for x in sumA])
    outB = [ks.plain_body_B(plan, g, lg, st[0], gA, action2d, t, mnext_t[c],
                            mprev_t[c], sched_t[c], routes)
            for lg, st, c in zip(lgs, states, cols)]
    sg_ms, c_sig = states[0][1], None
    if ks.gathers_sg(plan, comm):
        (gsg,) = comm.gather([[o.sg] for o in outB], "psum")
        sg_ms, c_sig = ks.fold_sg(plan, sg_ms, gsg)
    outC = [ks.plain_body_C(plan, g, lg, o.carry, o.bc, c_sig, mnext_t[c],
                            routes) for lg, o, c in zip(lgs, outB, cols)]
    gF, gI = comm.gather([[o.sumF, o.sumI] for o in outC])
    outD3 = [ks.plain_body_D(plan, g, lg, o.carry, gF, gI)
             for lg, o in zip(lgs, outC)]
    gss, gssn = comm.gather([[o.ss, o.ssn] for o in outD3], "psum")
    ss_ms, c_st = ks.fold_ss(plan, states[0][2], gss, gssn)
    return [ks.ShardOut(d3.carry, sg_ms, ss_ms,
                        ks.plain_body_E(plan, lg, d3.carry, c_st), b.n_inj,
                        d3.ev, c.wave, c.floor_hits)
            for lg, b, c, d3 in zip(lgs, outB, outC, outD3)], gA


def seven_body_step(plan, g, comm, states, t, action2d, rand_t, sched_t,
                    mnext_t, mprev_t, routes):
    """The step as JAX's ``step_sharded`` composes it: D1, D2 and D3 as
    three bodies with the wants and the arbitration gathered between them.
    Returns ``plain_shard_step``'s outputs, the gathered wants' verdicts
    ``(pred, gV)`` over the scene and the deposits won."""
    lgs = [ks.local_geometry(g, s) for s in comm.shards]
    cols = [s.cols for s in comm.shards]
    sumA = [ks.plain_body_A(plan, lg, st[0], rand_t[:, c], sched_t[c])
            for lg, st, c in zip(lgs, states, cols)]
    (gA,) = comm.gather([[x] for x in sumA])
    outB = [ks.plain_body_B(plan, g, lg, st[0], gA, action2d, t, mnext_t[c],
                            mprev_t[c], sched_t[c], routes)
            for lg, st, c in zip(lgs, states, cols)]
    sg_ms, c_sig = states[0][1], None
    if ks.gathers_sg(plan, comm):
        (gsg,) = comm.gather([[o.sg] for o in outB], "psum")
        sg_ms, c_sig = ks.fold_sg(plan, sg_ms, gsg)
    outC = [ks.plain_body_C(plan, g, lg, o.carry, o.bc, c_sig, mnext_t[c],
                            routes) for lg, o, c in zip(lgs, outB, cols)]
    gF, gI = comm.gather([[o.sumF, o.sumI] for o in outC])
    outD1 = [ks.plain_body_D1(plan, g, lg, o.carry, o.sumF, o.sumI, gF, gI)
             for lg, o in zip(lgs, outC)]
    (gW,) = comm.gather([[w] for w, _ in outD1])
    bds = [ks.plain_body_D2(plan, lg, gI, gW) for lg in lgs]
    (gV,) = comm.gather([[bd] for bd in bds])
    outD3 = [ks.plain_body_D3(plan, g, lg, o.carry, gF, gI, gV, pred, bd,
                              o.sumI)
             for lg, o, (_, pred), bd in zip(lgs, outC, outD1, bds)]
    gss, gssn = comm.gather([[o.ss, o.ssn] for o in outD3], "psum")
    ss_ms, c_st = ks.fold_ss(plan, states[0][2], gss, gssn)
    outs = [ks.ShardOut(d3.carry, sg_ms, ss_ms,
                        ks.plain_body_E(plan, lg, d3.carry, c_st), b.n_inj,
                        d3.ev, c.wave, c.floor_hits)
            for lg, b, c, d3 in zip(lgs, outB, outC, outD3)]
    pred = torch.cat([p for _, p in outD1], -1)
    deposits = int(sum((bd[:, 1] < plan.L).sum() for bd in bds))
    return outs, (pred, gV, gF, gI), deposits


@functools.lru_cache(maxsize=None)
def scene(name, soft, B):
    """The plan (T through the scene's last step), inputs, first step and
    the single-shard plain state there (read only)."""
    cfg, t0, t1, _ = SCENES[name]
    sched = problem.random_schedule if cfg is MICRO else problem.problem_1
    env = ItscpEnv(config=cfg, schedule_fn=sched, device="cpu")
    env.reset(3)
    plan = k6.make_plan(env, soft)._replace(T=t1 + 1)
    T = plan.T
    gen = torch.Generator().manual_seed(7)
    rand = torch.stack([env.draw_rand(gen)[:T] for _ in range(B)])
    action = torch.as_tensor(np.random.default_rng(12).uniform(
        0.3, 0.7, env.action_size()), dtype=torch.float32)
    d = env.data
    inputs = (action.reshape(plan.n_phases, -1).contiguous(),
              rand.contiguous(), d.schedule[:T].contiguous(),
              d.mroute_next[:T].contiguous(), d.mroute_prev[:T].contiguous(),
              k6.route_table(d.inj_routes, env.base_state.route_pool))
    g = k6.geometry(plan, "cpu")
    carry, sg, ss = k6.initial_carry(plan, B, "cpu")
    with torch.no_grad():
        for t in range(t0):
            o = k6.plain_spatial_step(plan, carry, sg, ss, t, inputs[0],
                                      rand[:, t], inputs[2][t], inputs[3][t],
                                      inputs[4][t], inputs[5], g)
            carry, sg, ss = o.carry, o.sg_ms, o.ss_ms
    return plan, inputs, t0, (carry, sg, ss)


def local_states(state, comm):
    carry, sg, ss = state
    return [(ks.slice_carry(carry, s), sg, ss) for s in comm.shards]


def check_lockstep(name, S, mode, B):
    """The three steps from the same state over the scene's steps; raises
    on a difference or a missing event."""
    plan, inputs, t0, state = scene(name, mode == "soft", B)
    action, rand, sched, mnext, mprev, routes = inputs
    g = k6.geometry(plan, "cpu")
    shards = ks.shards_of(plan.L, S)
    fused, every, seven = (CountingComm(plan.L, shards) for _ in range(3))
    states = local_states(state, fused)
    seen = dict.fromkeys(EVENTS, 0)
    gA, inject_rows = None, 0.0
    with torch.no_grad():
        for t in range(t0, plan.T):
            args = (t, action, rand[:, t], sched[t], mnext[t], mprev[t],
                    routes)
            ahead = (rand[:, t + 1], sched[t + 1]) if t + 1 < plan.T else ()
            got = ks.plain_shard_step(plan, g, fused, states, *args, gA,
                                      *ahead)
            ref_a, gA_every = a_every_step(plan, g, every, states, *args)
            ref, (pred, gV, gF, gI), deposits = seven_body_step(
                plan, g, seven, states, *args)
            # the A rows the step started from (step t0: gathered in it)
            if gA is not None:
                assert torch.equal(gA, gA_every), t
                inject_rows += float(gA[:, 8].sum())
            for a, r, e in zip(got, ref, ref_a):
                for x, y, z in zip(a.carry + a[1:8], r.carry + r[1:8],
                                   e.carry + e[1:8]):
                    assert torch.equal(x, y) and torch.equal(x, z), t
            # the whole scene's wants and verdicts as the seven bodies
            # gathered them
            p_all, v_all = ks.plain_arbitration(plan, g, gF, gI)
            assert torch.equal(p_all, pred) and torch.equal(v_all, gV), t
            ev = sum(o.ev.sum(0) for o in got)
            for k, v in zip(EVENTS, [int(sum(o.n_inj.sum() for o in got)),
                                     int(ev[0]), int(ev[1]) - deposits,
                                     int(ev[2]), deposits]):
                seen[k] += v
            states = [(o.carry, o.sg_ms, o.ss_ms) for o in got]
            gA = got[0].gA_next
    assert gA is None  # the last step gathers no A rows
    steps = plan.T - t0
    sums = steps * (2 if mode == "soft" else 1)
    assert fused.calls == {"all_gather": steps + 1, "psum": sums}
    assert every.calls == {"all_gather": 2 * steps, "psum": sums}
    assert seven.calls == {"all_gather": 4 * steps, "psum": sums}
    if "injected" in SCENES[name][3]:
        assert inject_rows > 0
    must = SCENES[name][3]
    if name == "hybrid" and mode == "hard":  # no deposit in its window
        must = ("emitted", "transferred")
    assert all(seen[k] > 0 for k in must), seen


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", ["micro", "hybrid"])
def test_fused_conversion_equals_seven_bodies(name, S, mode, B):
    check_lockstep(name, S, mode, B)
