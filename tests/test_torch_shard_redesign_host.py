"""The lane-sharded step's C and E (a reduction warp beside the lanes that
folds the running means; C's lanes spread over SPLIT threads each where
they fit), compiled for the host, against the plain bodies and the
single-shard STEP kernel.

``csrc/itscp_spatial_shard.cu`` and ``csrc/itscp_spatial_step.cu`` are
built with g++ against ``csrc/cpu_emulation.h`` and driven through the
same launchers as on the card, the shards in one process; the shard's
source also with ``-DDHTS_SHARD_ONE_THREAD`` (C one thread a lane
always).

* Every launch of a forward step equals its plain body bit for bit
  (``ShardRun.checked_step``), hard and soft, B = 2, at S = 1 (C's lanes
  one thread each: 144 lanes do not fit a block of SPLIT threads a lane),
  2, 3 and 4, on uneven shards (50 and 94 lanes) and on shards whose
  widths are not multiples of 32; on a micro scene of 28 lanes (not a
  multiple of 8) whose lanes hold more than SPLIT vehicles; on a scene of
  C = 7 cells (C + 1 = SPLIT interfaces); with C's lanes split and one
  thread each (the ``-DDHTS_SHARD_ONE_THREAD`` build).
  The whole episode's queues, events and waves equal the STEP kernel's.
* The derivative: ``tests/test_torch_shard_redesign_dual_host.py``.
* The folds on terms whose order of addition changes their sum
  (magnitudes 2^60 apart), a NaN, an infinity, and plain terms: the
  carry's running mean and the launch's outputs equal ``fold_sg`` /
  ``fold_ss`` and the plain bodies (NaN where theirs are NaN).
* The 9x9 scene (1,296 lanes) at S = 4 (324 lanes a shard: C one thread
  a lane; E's staged terms 20.7 KB of shared memory) and on shards of 992
  lanes (the widest with room for the reduction warp) and 304, T cut to
  8. A shard of 1,000 lanes is refused.
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

B = 2
HYBRID = dict(num_intersection=3, num_lane=1, lane_length=5.0,
              speed_limit=20.0, cell_length=5.0, policy_length=16,
              signal_length=2, simulation_frequency=10, random_seed=3,
              max_num_micro_vehicle_per_lane=4, mode="hybrid")
# two signal phases: fewer action entries, so fewer derivative blocks
TWO_PHASE = dict(HYBRID, signal_length=8)
# 28 micro lanes of up to 18 vehicles, 10 in a lane by the end
LONG_MICRO = dict(num_intersection=1, num_lane=2, lane_length=80.0,
                  speed_limit=20.0, cell_length=5.0, policy_length=30,
                  signal_length=2, simulation_frequency=10, random_seed=3,
                  max_num_micro_vehicle_per_lane=12, mode="micro")
# 40 macro lanes of C = 7 cells
WIDE_CELLS = dict(HYBRID, num_intersection=1, num_lane=3, policy_length=8)
NINE = dict(num_intersection=9, num_lane=1, lane_length=5, speed_limit=60,
            policy_length=2, signal_length=4, simulation_frequency=30,
            mode="hybrid", random_seed=3)
SCENES = {"hybrid": HYBRID, "two_phase": TWO_PHASE, "long_micro": LONG_MICRO,
          "wide_cells": WIDE_CELLS, "nine": NINE}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The shard's library (C's lanes split where they fit), the STEP
    kernel's, and the shard's with C one thread a lane."""
    out = tmp_path_factory.mktemp("k6redesign")
    try:
        shard = _build.build_cpu_emulation("itscp_spatial_shard", out)
        step = _build.build_cpu_emulation("itscp_spatial_step", out)
        one = _build.build_cpu_emulation("itscp_spatial_shard", out,
                                         defines=("DHTS_SHARD_ONE_THREAD",))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel sources: {err}")
    return (ks.bind(ctypes.CDLL(str(shard))), k6.bind(ctypes.CDLL(str(step))),
            ks.bind(ctypes.CDLL(str(one))))


def variant(libs, name):
    """The shard's library with C's lanes split where they fit (default)
    or one thread each."""
    return libs[2] if name == "one_thread" else libs[0]


def case(scene, differentiable, b=B, steps=None):
    env = ItscpEnv(config=SCENES[scene], schedule_fn=problem.problem_1,
                   device="cpu")
    env.reset(3)
    plan = k6.make_plan(env, differentiable)
    T = plan.T if steps is None else steps
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
    return plan, inputs


def comm_of(L, shards):
    if isinstance(shards, int):
        return ks.LaneComm(L, ks.shards_of(L, shards))
    return ks.LaneComm(L, [ks.Shard(off, n) for off, n in shards])


def most_vehicles(run) -> int:
    """The most vehicles a lane of the run holds now."""
    return max(int(run.carry(i)[0][11].max()) for i in range(len(run.shards)))


def step_forward(lib, step_lib, scene, shards, mode, checked, b=B):
    """A forward episode with the steps ``checked`` held launch by launch;
    its outputs against the STEP kernel's, and the most vehicles a lane
    held."""
    plan, inputs = case(scene, mode == "soft", b)
    run = ks.ShardRun(plan, comm_of(plan.L, shards), inputs, dual=False,
                      lib=lib)
    most = 0
    for t in range(plan.T):
        if checked(t):
            run.checked_step(t)
        else:
            run.step(t)
        most = max(most, most_vehicles(run))
    got = run.outputs()
    fb, ib = k6.empty_state(plan, b, "cpu")
    ref = [torch.zeros(b, plan.T), torch.zeros(b, plan.T, 3, dtype=torch.int32),
           torch.zeros(b, plan.T)]
    assert step_lib.launch_itscp_spatial_step_fwd(*k6.kernel_args(
        plan, (fb, None, ib), inputs, ref, b, 0, plan.T, 0)) == 0
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    return most, got


@pytest.mark.parametrize("how", ["split", "one_thread"])
@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, ((0, 50), (50, 94))],
                         ids=["S1", "S2", "S3", "S4", "uneven"])
def test_hybrid_launches_match_plain_bodies(libs, shards, mode, how):
    lib, step_lib = variant(libs, how), libs[1]
    _, (queues, events, _) = step_forward(lib, step_lib, "hybrid", shards,
                                          mode, lambda t: t % 16 == 3)
    assert int(events[..., 1].sum()) > 0 and float(queues.max()) > 0


@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("scene, shards",
                         [("long_micro", 2), ("long_micro", 4),
                          ("wide_cells", 2), ("wide_cells", ((0, 13),
                                                             (13, 27)))],
                         ids=["micro-S2", "micro-S4", "cells-S2",
                              "cells-uneven"])
def test_launches_match_plain_bodies(libs, scene, shards, mode):
    lib, step_lib = variant(libs, "split"), libs[1]
    most, _ = step_forward(lib, step_lib, scene, shards, mode,
                           lambda t: t % 10 == 9)
    if scene == "long_micro":
        # lanes held more vehicles than a group has threads
        assert most > ks_split()


def ks_split():
    """C's threads a lane where a lane's interfaces and vehicles fit
    (SPLIT in the source)."""
    src = (_build.CSRC / "itscp_spatial_shard.cu").read_text()
    return int(src.split("constexpr int SPLIT = ")[1].split(",")[0])


# terms whose sum depends on the order of addition (magnitudes 2^60
# apart), a NaN, an infinity, and terms of float32 values
f32 = lambda x: x.astype(np.float32).astype(np.float64)
FOLD_CASES = {
    "spread": lambda rng, L: np.where(np.arange(L) % 7 == 0, 2.0 ** 60,
                                      f32(rng.standard_normal(L))),
    "nan": lambda rng, L: np.where(np.arange(L) == L // 2, np.nan,
                                   f32(rng.standard_normal(L))),
    "inf": lambda rng, L: np.where(np.arange(L) == 3, np.inf,
                                   f32(rng.standard_normal(L))),
    "plain": lambda rng, L: f32(rng.standard_normal(L)),
}


def same(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    a = a.to(b.dtype)
    if not b.is_floating_point():
        return torch.equal(a, b)
    n = a.isnan()
    return torch.equal(n, b.isnan()) and torch.equal(a[~n], b[~n])


@pytest.mark.parametrize("how", ["split", "one_thread"])
@pytest.mark.parametrize("kind", list(FOLD_CASES))
def test_folds_on_hard_terms(libs, kind, how):
    """C's and E's folds on crafted gathered terms (the signal terms after
    B, the static terms after D3): each launch's outputs and carry, running
    means included, equal its plain body's on the same rows (after a NaN,
    NaN where the plain body's are: the gates keep a NaN mean's NaN, as
    the plain version's maximum does)."""
    lib = variant(libs, how)
    plan, inputs = case("hybrid", True, steps=6)
    run = ks.ShardRun(plan, comm_of(plan.L, 4), inputs, dual=False, lib=lib)
    t = plan.T - 1
    for s in range(t):
        run.step(s)
    rng = np.random.default_rng(3)
    terms = lambda: torch.as_tensor(np.stack(
        [FOLD_CASES[kind](rng, plan.L) for _ in range(B)]))
    for body in run.begin(t):
        spec = ks.STEP[body]
        if body in ("C", "E"):
            before = [(tuple(x.clone() for x in c), sg.clone(), ss.clone())
                      for c, sg, ss in map(run.carry,
                                           range(len(run.shards)))]
            refs = [run.plain(body, i, t, before[i])
                    for i in range(len(run.shards))]
            run.launch(body, t)
            for i, ref in enumerate(refs):
                got = spec.written(run.view(i, t))
                for name, r in ref.items():
                    pairs = zip(r, got[name]) if name == "carry" else \
                        [(r, got[name])]
                    for a, b in pairs:
                        assert same(a, b), (body, name)
        else:
            run.launch(body, t)
        run.after(body, t)
        if body == "B":
            run.g["gsg"][:, 0] = terms().to(torch.float32)
        elif body == "D3":
            run.g["gss"][:, 0] = terms()
            run.g["gss"][:, 1] = terms() * 0.25


@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("shards", [4, ((0, ks.MAX_LANES),
                                        (ks.MAX_LANES, 1296 - ks.MAX_LANES))],
                         ids=["S4", "widest"])
def test_nine_by_nine(libs, shards, mode):
    lib = variant(libs, "split")
    plan, inputs = case("nine", mode == "soft", 1, steps=8)
    assert plan.L == 1296
    comm = comm_of(plan.L, shards)
    run = ks.ShardRun(plan, comm, inputs, dual=False, lib=lib)
    for t in range(plan.T):
        if t in (0, 7):
            run.checked_step(t)
        else:
            run.step(t)
    got = run.outputs()
    ref = ks.plain_sharded_episode(plan, ks.LaneComm.whole(plan.L), *inputs)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


def test_shard_wider_than_a_block_is_refused(libs):
    """A shard of 1,000 lanes (no room for the reduction warp beside one
    thread a lane): the entry point and the launcher refuse it."""
    lib = variant(libs, "split")
    plan, inputs = case("nine", False, 1, steps=2)
    comm = comm_of(plan.L, ((0, 1000), (1000, 296)))
    with pytest.raises(ValueError, match="exceeds the cap of 992"):
        ks.shard_episode_fwd(plan, comm, *inputs)
    run = ks.ShardRun(plan, comm, inputs, dual=False, lib=lib)
    with pytest.raises(RuntimeError):
        run.step(0)
