"""The lane-sharded step's conversion, D3's launch (JAX's D1, D2 and D3:
every lane's wants into a table in shared memory, one barrier, each
lane's arbitration where it reads a verdict), on the card (skipped
without a CUDA device), against its plain version ``plain_body_D``.

* At the 3x3 hybrid preset of ``run_itscp_hybrid.sh`` (T = 600, 144
  lanes), S = 2 and 4, B = 1 and 4, hard and soft: every launch of each
  step at which the plain single-shard episode emits or absorbs and of
  every 50th step (``ShardRun.checked_step``: integers equal, floats
  allclose(rtol 1e-6, atol 1e-6), as ``chip_smoke.py`` holds them:
  PyTorch's CUDA operators may round otherwise), and the episode's
  queues, events and waves equal to the single-shard STEP kernel's; the
  derivative's ``Dual`` D3 at the emission steps and every 100th against
  ``plain_body_D`` under forward-mode AD (values allclose(rtol 1e-6,
  atol 1e-6), tangents allclose(rtol 1e-5, atol 1e-5 times the
  output's largest)).
* The 9x9 scene (1,296 lanes, T = 60; the derivative's first 30 steps) at
  S = 4, every 6th step; the forward episode equal to the plain
  single-shard episode's.
* The crafted cases of ``tests/test_torch_shard_conversion_host.py``
  (every predecessor wanting into a lane, an emission and a transfer into
  one lane, no next lane, the last lane) on the card, forward and
  derivative, S = 2 and 4.

This file imports nothing of JAX::

    python -m pytest --noconftest -q tests/test_torch_card_shard_conversion.py
"""

import pytest
import torch

from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from tests.test_torch_card_shard import (NINE, PRESET, episode_inputs,
                                         step_kernel_episode)
from tests.test_torch_card_shard_bd3 import card_env, step_events
from tests.test_torch_shard_bd3_host import case, comm_of
from tests.test_torch_shard_conversion_host import CASES, MICRO_STEP, crafted

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [2, 4])
def test_forward_conversion_matches_plain(S, B, mode):
    env = card_env(PRESET)
    plan = k6.make_plan(env, mode == "soft")
    inputs = episode_inputs(env, plan, B, 90 + B)
    marks = step_events(plan, inputs)
    assert marks, "nothing emitted or absorbed"
    run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, S)),
                      inputs, dual=False)
    for t in range(plan.T):
        if t % 50 == 11 or t in marks:
            run.checked_step(t, 1e-6, 1e-6)
        else:
            run.step(t)
    got = run.outputs()
    ref = step_kernel_episode(plan, inputs, B)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [2, 4])
def test_derivative_conversion_matches_plain_forward_mode(S, B):
    env = card_env(PRESET)
    plan = k6.make_plan(env, True)
    inputs = episode_inputs(env, plan, B, 95 + B)
    _, ev, _ = k6.plain_spatial_episode(plan, *inputs)
    emits = set(torch.nonzero(ev[..., 1].sum(0)).flatten().tolist()[:4])
    assert emits, "nothing emitted"
    run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, S)),
                      inputs, dual=True)
    for t in range(plan.T):
        if t % 100 == 13 or t in emits:
            run.checked_dual_step(t, bodies=("D3",), value_tol=(1e-6, 1e-6))
        else:
            run.step(t)
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", ["hard", "soft", "dual"])
def test_nine_by_nine_conversion(mode):
    env = card_env(NINE)
    plan = k6.make_plan(env, mode != "hard")
    inputs = episode_inputs(env, plan, 1, 19)
    dual = mode == "dual"
    T = 30 if dual else 60
    plan = plan._replace(T=T)
    a, rand, sched, mnext, mprev, routes = inputs
    inputs = (a, rand[:, :T].contiguous(), sched[:T].contiguous(),
              mnext[:T].contiguous(), mprev[:T].contiguous(), routes)
    run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, 4)),
                      inputs, dual=dual)
    for t in range(plan.T):
        if t % 6 == 5 and dual:
            run.checked_dual_step(t, bodies=("D3",), value_tol=(1e-6, 1e-6))
        elif t % 6 == 5:
            run.checked_step(t, 1e-6, 1e-6)
        else:
            run.step(t)
    if not dual:  # STEP takes at most 992 lanes: the plain episode
        got = run.outputs()
        ref = k6.plain_spatial_episode(plan, *inputs)
        torch.cuda.synchronize()
        for x, r in zip(got, ref):
            assert torch.equal(x, r)


def card_run(scene, S, kind):
    """The host test's crafted-case run (its scene's plain state at its
    first step, B = 2) on the card: the run and its first step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU path")
    t = MICRO_STEP if scene == "micro" else None
    plan, inputs, t0, state = case(scene, kind != "hard", 2,
                                   t + 1 if t is not None else 1)
    dev = torch.device("cuda")
    inputs = tuple(x.to(dev) for x in inputs)
    # the kernels read the scene's tables on the card
    plan = plan._replace(**{k: getattr(plan, k).to(dev) for k in (
        "lane_i", "lane_f", "lane_perm", "prog")})
    run = ks.ShardRun(plan, comm_of(plan.L, S), inputs, dual=kind == "dual")
    if state is not None:
        carry, sg, ss = (tuple(x.to(dev) for x in state[0]),
                         state[1].to(dev), state[2].to(dev))
        reps = run.N // 2
        if reps > 1:
            carry = tuple(x.repeat_interleave(reps, 0) for x in carry)
            sg, ss = sg.repeat_interleave(reps, 0), ss.repeat_interleave(
                reps, 0)
        for s, p_n, bufs, _ in run.shards:
            fb, ib = k6.pack(p_n, ks.slice_carry(carry, s), sg, ss)
            bufs["fbuf"].copy_(fb)
            bufs["ibuf"].copy_(ib)
    return run, t0


@pytest.mark.parametrize("kind", ["hard", "soft", "dual"])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_crafted_conversion_matches_plain(name, S, kind):
    scene, build = CASES[name]
    run, t0 = card_run(scene, S, kind)
    for s in range(t0, run.plan.T - 1):
        run.step(s)
    t = run.plan.T - 1
    expect = []
    if kind == "dual":
        run.checked_dual_step(t, ("D3",), value_tol=(1e-6, 1e-6),
                              edit=crafted(build, expect))
    else:
        run.checked_step(t, 1e-6, 1e-6, edit=crafted(build, expect))
    torch.cuda.synchronize()
    assert len(expect) == 1
