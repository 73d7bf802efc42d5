"""The lane-sharded step's B and D3 (each lane its own signals in
registers, nothing shared in the block; the forward's injection, emit and
absorb counts by a barrier's count), compiled for the host, against their
plain bodies.

``csrc/itscp_spatial_shard.cu`` is built with g++ against
``csrc/cpu_emulation.h`` and driven through the card's launcher, the
shards in one process, over at most 40 steps where B and D3 have work: the
micro scene's steps 0-39 (injections from step 0, then transfers and
exits: B's injections, D3's removals and inserts) and the hybrid scene's
steps 116-145 from the plain step's state at 116 (its macro lanes emit at
120 and a micro head is deposited into a macro lane at 142 in soft mode,
emit at 132 in hard mode: D3's emissions and deposits), and the 9x9 scene (1,296 lanes, T = 8 as
``tests/test_torch_shard_redesign_host.py`` cuts it).

* Forward, hard and soft, S = 1, 2, 3, 4 and uneven shards (B = 4 at S =
  2 and 4, else 1): every launch of every step equal to its plain body
  bit for bit (``ShardRun.checked_step``: B's carry, rows, signal terms
  and injection count; D3's carry, static terms and emit and absorb
  counts).
* The derivative (``Dual``; S = 2 at B = 1, S = 4 at B = 4): B's and D3's
  launches at every 3rd step and at the emission and deposit steps
  against their plain bodies under forward-mode AD
  (``ShardRun.checked_dual_step``: values equal, tangents within rtol
  1e-5, atol 1e-5 times the output's largest).
* The one-thread reference: B and D3 run one thread a lane in every
  build; the build with ``-DDHTS_SHARD_ONE_THREAD`` (C one thread a lane
  too) gives the same bits in every buffer after each step.
* The 9x9 scene at S = 4, hard and soft, every step checked, and the
  episode's queues, events and waves equal to the plain single-shard
  episode's.
* The cycle-stamped build (``-DDHTS_SHARD_CLOCK``): one launch of B and
  of D3 from the quiet step writes the same bits as the unstamped build's
  (hard, soft, ``Dual``; S = 1, 2 and 4), and stamps every part of B's and
  D3's path.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import _build, shard_clock
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
NINE = dict(num_intersection=9, num_lane=1, lane_length=5, speed_limit=60,
            policy_length=2, signal_length=4, simulation_frequency=30,
            mode="hybrid", random_seed=3)
# scene, first step, steps run (the emission and the deposit steps)
SCENES = {"micro": (MICRO, 0, 40, ()), "hybrid": (HYBRID, 116, 30,
                                                  (120, 142)),
          "nine": (NINE, 0, 8, ())}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The shard's library, its build with C one thread a lane, and its
    cycle-stamped build."""
    out = tmp_path_factory.mktemp("bd3")
    try:
        paths = [_build.build_cpu_emulation("itscp_spatial_shard", out,
                                            defines=d)
                 for d in ((), ("DHTS_SHARD_ONE_THREAD",),
                           ("DHTS_SHARD_CLOCK",))]
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return {"split": ks.bind(ctypes.CDLL(str(paths[0]))),
            "one_thread": ks.bind(ctypes.CDLL(str(paths[1]))),
            "clock": shard_clock.bind_clock(ctypes.CDLL(str(paths[2])))}


@functools.lru_cache(maxsize=None)
def case(scene, soft, b, steps=None):
    """The plan (T: the scene's last step run + 1), inputs, first step and
    the plain step's state there (None at step 0; read only)."""
    cfg, t0, n, _ = SCENES[scene]
    sched = problem.random_schedule if cfg is MICRO else problem.problem_1
    env = ItscpEnv(config=cfg, schedule_fn=sched, device="cpu")
    env.reset(3)
    plan = k6.make_plan(env, soft)
    T = t0 + (n if steps is None else steps)
    plan = plan._replace(T=T)
    gen = torch.Generator().manual_seed(7)
    rand = torch.stack([env.draw_rand(gen)[:T] for _ in range(b)])
    action = torch.as_tensor(np.random.default_rng(12).uniform(
        0.3, 0.7, env.action_size()), dtype=torch.float32)
    d = env.data
    inputs = (action.reshape(plan.n_phases, -1).contiguous(),
              rand.contiguous(), d.schedule[:T].contiguous(),
              d.mroute_next[:T].contiguous(), d.mroute_prev[:T].contiguous(),
              k6.route_table(d.inj_routes, env.base_state.route_pool))
    state = None
    if t0:
        carry, sg, ss = k6.initial_carry(plan, b, "cpu")
        g = k6.geometry(plan, "cpu")
        for t in range(t0):
            o = k6.plain_spatial_step(plan, carry, sg, ss, t, inputs[0],
                                      rand[:, t], inputs[2][t], inputs[3][t],
                                      inputs[4][t], inputs[5], g)
            carry, sg, ss = o.carry, o.sg_ms, o.ss_ms
        state = carry, sg, ss
    return plan, inputs, t0, state


def comm_of(L, shards):
    if isinstance(shards, int):
        return ks.LaneComm(L, ks.shards_of(L, shards))
    return ks.LaneComm(L, [ks.Shard(off, n) for off, n in shards])


def shard_run(lib, scene, shards, soft, b, dual=False, steps=None,
              own_inputs=False):
    """A ShardRun of ``scene`` at its first step: each shard's packed carry
    the plain state's (a derivative's B * n_act rows each their episode's,
    tangents 0); ``own_inputs``: over copies of the cached inputs, which a
    test may then edit. Returns the run and its first step."""
    plan, inputs, t0, state = case(scene, soft, b, steps)
    if own_inputs:
        inputs = tuple(x.clone() for x in inputs)
    run = ks.ShardRun(plan, comm_of(plan.L, shards), inputs, dual=dual,
                      lib=lib)
    if state is not None:
        carry, sg, ss = state
        reps = run.N // b
        if reps > 1:
            carry, sg, ss = (tuple(x.repeat_interleave(reps, 0)
                                   for x in carry),
                             sg.repeat_interleave(reps, 0),
                             ss.repeat_interleave(reps, 0))
        for s, p_n, bufs, _ in run.shards:
            fb, ib = k6.pack(p_n, ks.slice_carry(carry, s), sg, ss)
            bufs["fbuf"].copy_(fb)
            bufs["ibuf"].copy_(ib)
    return run, t0


def forward(lib, scene, shards, mode, b):
    """Every step of ``scene``'s run held launch by launch against the
    plain bodies; the per-step events summed over the episodes."""
    run, t0 = shard_run(lib, scene, shards, mode == "soft", b)
    for t in range(t0, run.plan.T):
        run.checked_step(t)
    return sum(b_["events"] for _, _, b_, _ in run.shards)[:, t0:]


@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("shards, b", [(1, 1), (2, 4), (3, 1), (4, 1),
                                       (4, 4), ("uneven", 1)])
@pytest.mark.parametrize("scene", ["micro", "hybrid"])
def test_launches_match_plain_bodies(libs, scene, shards, b, mode):
    if shards == "uneven":
        shards = ((0, 50), (50, 62 if scene == "micro" else 94))
    elif shards == 3 and scene == "micro":  # 112 lanes
        shards = ((0, 37), (37, 37), (74, 38))
    tot = forward(libs["split"], scene, shards, mode, b).sum((0, 1))
    if scene == "micro":
        assert int(tot[0]) > 0 and int(tot[2]) > 0  # injected, absorbed
    else:  # emitted (at 132 in hard mode), deposited (soft: at 142)
        assert int(tot[1]) > 0 and (mode == "hard" or int(tot[2]) > 0)


@pytest.mark.parametrize("S, b", [(2, 1), (4, 4)])
@pytest.mark.parametrize("scene", ["micro", "hybrid"])
def test_derivative_launches_match_forward_mode(libs, scene, S, b):
    # the host runs the B * n_act dual blocks in turn
    run, t0 = shard_run(libs["split"], scene, S, True, b, dual=True,
                        steps=28)
    marks = SCENES[scene][3]
    for t in range(t0, run.plan.T):
        if (t - t0) % 3 == 0 or t in marks:
            run.checked_dual_step(t, bodies=("B", "D3"))
        else:
            run.step(t)


@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("scene", ["micro", "hybrid"])
def test_one_thread_build_gives_the_same_bits(libs, scene, mode):
    runs = [shard_run(libs[k], scene, 4, mode == "soft", 2)
            for k in ("split", "one_thread")]
    t0 = runs[0][1]
    for t in range(t0, runs[0][0].plan.T):
        for run, _ in runs:
            run.step(t)
        for (_, _, a, _), (_, _, b, _) in zip(runs[0][0].shards,
                                              runs[1][0].shards):
            for name, x in a.items():
                if x is not None:
                    assert torch.equal(x, b[name]), (t, name)


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_nine_by_nine(libs, mode):
    run, _ = shard_run(libs["split"], "nine", 4, mode == "soft", 1)
    assert run.plan.L == 1296
    for t in range(run.plan.T):
        run.checked_step(t)
    ref = ks.plain_sharded_episode(run.plan, ks.LaneComm.whole(run.plan.L),
                                   *run.inputs)
    for a, r in zip(run.outputs(), ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("kind", shard_clock.KINDS)
def test_stamped_b_d3_equal_unstamped(libs, kind, S):
    plans = tuple(case("micro", soft, 2, steps=12)[0]
                  for soft in (False, True))
    inputs = case("micro", True, 2, steps=12)[1]
    q = shard_clock.Quiet(plans, kind, inputs, libs["split"], S=S, warm=6)
    for body in ("B", "D3"):
        assert q.same_bits((libs["clock"], libs["split"]), body), body
        rec = shard_clock.stamp(q, libs["clock"], body, 2)
        lane = shard_clock.slowest_lane(rec, body) - q.shard.off
        rec = shard_clock.stamp(q, libs["clock"], body, 2, lane)
        parts = rec["cycles_per_launch"]
        assert rec["launches_stamped"] == 2 and rec["clock_lane"] == lane
        path = [v for k, v in parts.items() if k != f"{body}_total"]
        # B's parts; D3's with its table's three and the next step's A rows
        assert len(path) == (7 if body == "B" else 8)
        assert min(path) >= 0 and 0 < sum(path) <= parts[f"{body}_total"]
        lanes = rec[f"{body}_lane_cycles_per_launch"]
        assert sum(v["lanes"] for v in lanes.values()) == q.shard.n
