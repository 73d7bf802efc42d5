"""A NaN running mean through the gated kernels on the card (skipped
without a CUDA device), against the plain versions on the same CUDA
tensors: the cases of ``tests/test_torch_nan_gate_host.py`` (which also
holds the plain versions against ``dhts``), launched through the
wrappers. K1 (hybrid and micro scenes, soft and ``st``, a NaN action
entry), K4 (a NaN action entry, a NaN initial cell), STEP (a NaN action
entry or carried vehicle speed, one launch a step) and the shards' C and
E (NaN fold terms; a NaN carried vehicle speed, every launch held): the
same NaN positions as the plain version, the other entries bit-equal (K1's
queues allclose atol 1e-5). This file imports nothing of JAX, and the
host test imports its helpers from here::

    python -m pytest --noconftest -q tests/test_torch_card_nan_gate.py
"""

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops import arz
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1
from dhts_torch.ops.cuda import itscp_macro_episode as k4
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
MACRO = dict(num_intersection=1, num_lane=1, lane_length=20.0,
             speed_limit=20.0, cell_length=5.0, policy_length=6,
             signal_length=2, simulation_frequency=10, random_seed=3,
             max_num_micro_vehicle_per_lane=4, mode="macro")
SCENES = {"hybrid": HYBRID, "micro": MICRO, "macro": MACRO}
NAN = float("nan")
# (scene, gate mode, the NaN action entry (phase, intersection))
K1_CASES = [(s, m, e) for s, m in (("hybrid", "soft"), ("hybrid", "st"),
                                   ("micro", "soft"))
            for e in ((0, 0), (2, 1))]


def same(got, ref, atol=0.0) -> bool:
    """The same NaN positions; the other entries equal (within ``atol``)."""
    ref = ref.to(got.dtype)
    if not got.is_floating_point():
        return torch.equal(got, ref)
    n = ref.isnan()
    if not torch.equal(got.isnan(), n):
        return False
    if atol:
        return torch.allclose(got[~n], ref[~n], rtol=0.0, atol=atol)
    return torch.equal(got[~n], ref[~n])


def port_env(scene, device="cpu", **over):
    env = ItscpEnv(config=dict(SCENES[scene], **over), device=device,
                   schedule_fn=problem.random_schedule if scene == "micro"
                   else problem.problem_1)
    env.reset(3)
    return env


def nan_action(env, entry=None):
    """A uniform action ``[n_phases, n_inter]``, entry ``entry`` (phase,
    intersection) NaN."""
    a = torch.as_tensor(np.random.default_rng(12).uniform(
        0.3, 0.7, env.action_size()), dtype=torch.float32)
    a = a.reshape(env.n_phases, -1).contiguous()
    if entry is not None:
        a[entry] = NAN
    return a.to(env.device)


def k1_case(scene, gate, entry, device="cpu"):
    """K1's soft (or ``st``) plan and inputs with action entry ``entry``
    NaN."""
    env = port_env(scene, device, use_fused_episode=True, gate_mode=gate)
    plan = env.fused_plan(True)
    gen = torch.Generator(device=env.device).manual_seed(7)
    d = env.data
    return plan, (nan_action(env, entry), d.schedule, d.mroute_next,
                  d.mroute_prev, env.draw_rand(gen), d.inj_routes,
                  env.base_state.route_pool)


def k4_case(nan, device="cpu"):
    """K4's plan and inputs on the small macro scene: the second phase's
    action entry NaN from the empty state (``"action"``), or a seeded state with a NaN
    density in lane 0's second cell (``"cell"``)."""
    env = port_env("macro", device)
    plan = k4.make_plan(env.spec, env.meta, env.config)
    L, C, u_max = plan.L, plan.C, plan.floats[0]
    m = plan.cell_mask.to(env.device)
    rng = np.random.default_rng(5)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                  device=env.device)
    action = nan_action(env, (1, 0) if nan == "action" else None)
    r0 = torch.zeros((L, C), device=env.device)
    y0 = torch.zeros((L, C), device=env.device)
    if nan == "cell":
        r0 = torch.where(m, t(rng.uniform(0.05, 0.6, (L, C))), 0.0)
        y0 = torch.where(m, arz.compute_y(
            r0, t(rng.uniform(0.3, 1.0, (L, C)) * u_max), u_max), 0.0)
        r0[0, 1] = NAN
    d = env.data
    return plan, (action, d.schedule, d.mroute_next, d.mroute_prev,
                  r0.contiguous(), y0.contiguous())


def step_case(scene, nan, device="cpu", B=2, steps=12):
    """STEP's soft plan, inputs, the plain state at step t0 and t0 (the
    hybrid scene from step 130: its macro lanes emit vehicles from step
    120; the micro scene from step 20), with a NaN carried vehicle speed
    (``"speed"``: episode 0's first vehicle of its first lane that holds
    one) or a NaN action entry (``"action"``: intersection 0's of the phase
    the steps run in)."""
    env = port_env(scene, device)
    t0 = 130 if scene == "hybrid" else 20
    plan = k6.make_plan(env, True)._replace(T=t0 + steps)
    gen = torch.Generator(device=env.device).manual_seed(7)
    rand = torch.stack([env.draw_rand(gen)[:plan.T] for _ in range(B)])
    d = env.data
    a = nan_action(env)
    ins = [a, rand.contiguous(), d.schedule[:plan.T].contiguous(),
           d.mroute_next[:plan.T].contiguous(),
           d.mroute_prev[:plan.T].contiguous(),
           k6.route_table(d.inj_routes, env.base_state.route_pool)]
    carry, sg, ss = k6.initial_carry(plan, B, env.device)
    g = k6.geometry(plan, env.device)
    for t in range(t0):
        o = k6.plain_spatial_step(plan, carry, sg, ss, t, a, rand[:, t],
                                  ins[2][t], ins[3][t], ins[4][t], ins[5], g)
        carry, sg, ss = o.carry, o.sg_ms, o.ss_ms
    if nan == "speed":
        carry = tuple(x.clone() for x in carry)
        assert nan_speed(carry) >= 0, "no vehicle to carry a NaN"
    else:
        ins[0] = a.clone()
        ins[0][min(t0 // plan.nsf, plan.n_phases - 1), 0] = NAN
    return plan, tuple(ins), (carry, sg, ss), t0, g


def nan_speed(carry) -> int:
    """Make the speed of episode 0's first vehicle of its first lane that
    holds one NaN, in place; returns that lane's local index, or -1."""
    count = carry[k6.CNAMES.index("count")]
    lanes = torch.nonzero(count[0] > 0).flatten()
    if not len(lanes):
        return -1
    carry[k6.CNAMES.index("vel")][0, 0, int(lanes[0])] = NAN
    return int(lanes[0])


def check_steps(launch, plan, ins, state, t0, g):
    """``launch(fbuf, ibuf, t, queues, events, waves)``, one step a call
    from the packed ``state`` at step t0, against the plain step: the
    packed carry after each step, its queues, events and waves the
    same."""
    carry, sg, ss = state
    B = carry[0].shape[0]
    dev = carry[0].device
    fb, ib = k6.pack(plan, carry, sg, ss)
    q = torch.zeros(B, plan.T, device=dev)
    ev = torch.zeros(B, plan.T, 3, dtype=torch.int32, device=dev)
    w = torch.zeros(B, plan.T, device=dev)
    a, rand, sched, mnext, mprev, routes = ins
    for t in range(t0, plan.T):
        launch(fb, ib, t, q, ev, w)
        o = k6.plain_spatial_step(plan, carry, sg, ss, t, a, rand[:, t],
                                  sched[t], mnext[t], mprev[t], routes, g)
        carry, sg, ss = o.carry, o.sg_ms, o.ss_ms
        f2, i2 = k6.pack(plan, carry, sg, ss)
        assert same(fb, f2) and same(ib, i2), t
        assert same(q[:, t], o.queue) and same(ev[:, t], o.events), t
        assert same(w[:, t], o.max_wave), t
    assert bool(q[:, t0:].isnan().any()), "the NaN reached no queue"


def shard_run(S, scene="hybrid", steps=6, B=2, device="cpu", lib=None):
    """A soft forward ShardRun of ``scene`` on S local shards."""
    env = port_env(scene, device)
    plan = k6.make_plan(env, True)._replace(T=steps)
    gen = torch.Generator(device=env.device).manual_seed(7)
    rand = torch.stack([env.draw_rand(gen)[:steps] for _ in range(B)])
    d = env.data
    ins = (nan_action(env), rand.contiguous(),
           d.schedule[:steps].contiguous(),
           d.mroute_next[:steps].contiguous(),
           d.mroute_prev[:steps].contiguous(),
           k6.route_table(d.inj_routes, env.base_state.route_pool))
    comm = ks.LaneComm(plan.L, ks.shards_of(plan.L, S))
    return ks.ShardRun(plan, comm, ins, dual=False, lib=lib)


def nan_checked_step(run, t, edit=None):
    """Step t with every launch held against its plain body on the same
    inputs (:func:`same`); ``edit(body)`` may change the gathered rows
    after a body's gather."""
    def snap(i):
        c, sg, ss = run.carry(i)
        return tuple(x.clone() for x in c), sg.clone(), ss.clone()

    for body in run.begin(t):
        before = [snap(i) for i in range(len(run.shards))]
        run.launch(body, t)
        for i in range(len(run.shards)):
            ref = run.plain(body, i, t, before[i])
            got = ks.STEP[body].written(run.view(i, t))
            for name, r in ref.items():
                pairs = (zip(r, got[name]) if name == "carry"
                         else [(r, got[name])])
                for a, b in pairs:
                    assert same(b, a), (t, body, name)
        run.after(body, t)
        if edit:
            edit(body)


def check_shard_fold_nan(run):
    """Steps 4 and 5 of ``run`` (steps 0-3 run) with a NaN signal term
    and a NaN static term gathered at step 4."""
    for t in range(4):
        run.step(t)

    def edit(body):
        if body == "B":
            run.g["gsg"][0, 0, 3] = NAN
        elif body == "D3":
            run.g["gss"][1, 1, 7] = NAN

    nan_checked_step(run, 4, edit)
    for i in range(len(run.shards)):
        _, sg, ss = run.carry(i)
        assert bool(sg[0].isnan().any()) and bool(ss[1].isnan().any())
    nan_checked_step(run, 5)


def check_shard_speed_nan(run):
    """Steps 20-23 of ``run`` (steps 0-19 run) after a NaN carried vehicle
    speed."""
    for t in range(20):
        run.step(t)
    if all(nan_speed(run.carry(i)[0]) < 0 for i in range(len(run.shards))):
        pytest.fail("no vehicle to carry a NaN")
    run.drop_ahead()  # step 20's A reads the NaN speed
    for t in range(20, 24):
        nan_checked_step(run, t)
    assert any(bool(run.carry(i)[2].isnan().any())
               for i in range(len(run.shards)))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU path")
    return torch.device("cuda")


@pytest.mark.parametrize("scene, gate, entry", K1_CASES)
def test_k1_nan_action_gives_plain_nan_outputs(dev, scene, gate, entry):
    plan, ins = k1_case(scene, gate, entry, dev)
    got = k1.itscp_hybrid_episode_fwd(plan, *ins)
    ref = k1.plain_episode(plan, *ins)
    assert bool(ref[1].isnan().any())
    assert same(got[0], ref[0], 1e-5) and same(got[1], ref[1], 1e-5)
    assert same(got[2], ref[2])


@pytest.mark.parametrize("nan", ["action", "cell"])
def test_k4_nan_gives_plain_nan_outputs(dev, nan):
    plan, ins = k4_case(nan, dev)
    got = k4.macro_episode_fwd(plan, *ins)
    ref = k4.plain_macro_episode(plan, *ins)
    assert bool(ref[1].isnan().any())
    assert same(got[0], ref[0]) and same(got[1], ref[1])


@pytest.mark.parametrize("nan", ["speed", "action"])
@pytest.mark.parametrize("scene", ["hybrid", "micro"])
def test_step_nan_gives_plain_nan_outputs(dev, scene, nan):
    plan, ins, state, t0, g = step_case(scene, nan, dev)

    def launch(fb, ib, t, q, ev, w):
        k6.spatial_step_fwd(plan, fb, ib, t, 1, ins, q, ev, w)

    check_steps(launch, plan, ins, state, t0, g)


@pytest.mark.parametrize("S", [2, 4])
def test_shard_fold_nan_gives_plain_nan_outputs(dev, S):
    check_shard_fold_nan(shard_run(S, device=dev))


@pytest.mark.parametrize("S", [2, 4])
def test_shard_nan_speed_gives_plain_nan_outputs(dev, S):
    check_shard_speed_nan(shard_run(S, "micro", steps=24, device=dev))
