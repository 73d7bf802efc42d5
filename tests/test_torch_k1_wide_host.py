"""K1's layouts for scenes wider than one block, compiled for the host.

The kernel keeps a block's state in shared memory or, for the scenes whose
state does not fit there, its arrays of C, V or K entries a lane in a
workspace in global memory; and it runs one lane a thread or, past 1,024
threads, two. Both are fields of the plan (``placement``,
``lanes_per_thread``), which these tests set on a 3x3 scene (4 Hz, 30 m/s,
10 m lanes: conversions within T = 60 steps; one signal phase, 9 backward
blocks) to force each layout the wide grids take, in the host build of
``csrc/itscp_hybrid_episode.cu`` (g++ against ``csrc/cpu_emulation.h``):

* the global placement, two lanes a thread, and both together: the
  global placement at one lane a thread bit-equal to the shared-memory
  kernel ``itscp_hybrid_episode_kernel``, the 3x3 preset's (forward:
  reward, queues, all eight event rows; backward: gradients), hard, soft
  and ``st``; two lanes a thread in shared memory refused by
  ``make_plan`` and by the launcher (shared memory takes one lane a
  thread); two lanes a thread in global memory bit-equal to the
  shared-memory kernel in hard mode (the soft modes' running means fold a
  thread's two lanes first); each layout that runs against the plain
  version at K1's host standard (events exact, reward rel 1e-5, queues abs
  1e-5; gradients cosine > 0.999, ``allclose(rtol=2e-2, atol=2e-3 *
  max|g|)``);
* a launch of four episodes bit-equal to four single launches, global
  placement and two lanes a thread;
* the 5x5 and 9x9 grids of ``run_itscp_5x5.sh``'s flags (T = 150: at T = 60
  neither converts a vehicle yet) in the layouts ``make_plan``
  picks for them, forward, against the plain version;
* the shared memory and workspace of every layout as the library reckons
  them, against ``block_bytes``.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

torch.set_num_threads(1)

CFG = dict(num_intersection=3, num_lane=1, lane_length=10.0,
           speed_limit=30.0, cell_length=10.0, policy_length=15,
           signal_length=15, simulation_frequency=4, random_seed=3,
           max_num_micro_vehicle_per_lane=4, mode="hybrid",
           use_fused_episode=True)
# run_itscp_5x5.sh's flags at T = 150
WIDE = dict(num_lane=1, lane_length=5, speed_limit=60, signal_length=4,
            policy_length=5, mode="hybrid", use_fused_episode=True,
            random_seed=3)
FORCED = {"global": (1, "global"), "two_lanes": (2, "shared"),
          "both": (2, "global")}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation(
            "itscp_hybrid_episode", tmp_path_factory.mktemp("k1wide"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return k1.bind(ctypes.CDLL(str(path)))


@functools.lru_cache(maxsize=None)
def scene(cfg_items, gate_mode):
    env = ItscpEnv(config=dict(dict(cfg_items), gate_mode=gate_mode),
                   schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    rand = env.draw_rand(torch.Generator().manual_seed(7))
    action = torch.as_tensor(np.random.default_rng(12).uniform(
        0.3, 0.7, env.action_size()), dtype=torch.float32).reshape(
        env.n_phases, -1)
    inputs = (action, env.data.schedule, env.data.mroute_next,
              env.data.mroute_prev, rand, env.data.inj_routes,
              env.base_state.route_pool)
    return env, inputs


def plan_of(env, mode, lpt=None, where=None):
    p = env.fused_plan(mode != "hard")
    return k1.make_plan(env.spec, env.meta, env.config, p.V, p.R, p.P, p.P2,
                        window=p.W, differentiable=mode != "hard",
                        lanes_per_thread=lpt,
                        placement=None if where is None else (where, where))


def forward(lib, plan, inputs, B=None):
    lead = () if B is None else (B,)
    out = (torch.zeros(lead), torch.zeros(*lead, plan.T),
           torch.zeros(*lead, plan.T, 8))
    strides = (0,) * 8
    if B is not None:
        _, strides = k1.episode_rows(plan, inputs, B)
        strides = (*strides, 0)
    assert lib.launch_itscp_hybrid_episode_fwd(*k1.kernel_args(
        plan, inputs, out, 0, B or 1, strides, lib=lib)) == 0
    return out


def backward(lib, plan, inputs, w, B=None):
    lead = () if B is None else (B,)
    grad = torch.zeros(*lead, plan.n_phases, plan.n_inter)
    strides = (0,) * 8
    if B is not None:
        _, strides = k1.episode_rows(plan, inputs, B)
        strides = (*strides, plan.T)
    assert lib.launch_itscp_hybrid_episode_bwd(*k1.kernel_args(
        plan, inputs, (w, grad), 0, B or 1, strides, lib=lib)) == 0
    return grad


def same_bits(x, y):
    """Bit for bit, NaN payloads included (an episode of this scene may
    turn NaN: the plain version's too)."""
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def check_forward(out, ref, rtol=1e-5, atol=1e-5):
    kr, kq, ke = out
    pr, pq, pe = ref
    assert torch.equal(ke, pe), (ke != pe).any(1).sum()
    assert float(kr) == pytest.approx(float(pr), rel=rtol, abs=1e-6)
    np.testing.assert_allclose(kq.numpy(), pq.detach().numpy(), rtol=0,
                               atol=atol)


def check_gradient(got, ref):
    got, ref = got.numpy().ravel(), ref.numpy().ravel()
    assert np.all(np.isfinite(got)) and np.linalg.norm(got) > 0
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos > 0.999, (cos, got, ref)
    np.testing.assert_allclose(got, ref, rtol=2e-2,
                               atol=2e-3 * np.abs(ref).max())


def test_library_reckons_block_bytes_as_the_wrapper(lib):
    ws = ctypes.c_size_t()
    for L, C, V, K in ((144, 4, 16, 2), (400, 4, 16, 2), (1296, 4, 16, 2),
                       (37, 3, 5, 3), (1, 1, 1, 1)):
        for tangent in (0, 1):
            for i, where in enumerate(k1.PLACEMENTS):
                smem = lib.itscp_hybrid_episode_smem_at(
                    L, C, V, K, tangent, i, ctypes.byref(ws))
                assert (smem, ws.value) == k1.block_bytes(
                    L, C, V, K, bool(tangent), where), (L, tangent, where)
            assert lib.itscp_hybrid_episode_smem(L, C, V, K, tangent) == \
                k1.block_bytes(L, C, V, K, bool(tangent), "shared")[0]


def refused(lib, env, mode, launcher, outputs, inputs):
    """Two lanes a thread in shared memory: make_plan refuses it, and so
    does the launcher, given the arguments of the global placement's plan
    with the shared placement."""
    with pytest.raises(ValueError, match="one lane a thread"):
        plan_of(env, mode, 2, "shared")
    args = list(k1.kernel_args(plan_of(env, mode, 2, "global"), inputs,
                               outputs, 0, lib=lib))
    assert args[-2] == 1  # the global placement
    args[-2] = 0
    assert launcher(*args) != 0


@pytest.mark.parametrize("mode", ["hard", "soft", "st"])
@pytest.mark.parametrize("forced", list(FORCED))
def test_forced_layout_forward(lib, forced, mode):
    env, inputs = scene(tuple(CFG.items()), "st" if mode == "st" else "soft")
    lpt, where = FORCED[forced]
    if forced == "two_lanes":
        out = (torch.zeros(()), torch.zeros(env.num_timestep),
               torch.zeros(env.num_timestep, 8))
        refused(lib, env, mode, lib.launch_itscp_hybrid_episode_fwd, out,
                inputs)
        return
    plan = plan_of(env, mode, lpt, where)
    assert (plan.lanes_per_thread, plan.placement) == (lpt, (where, where))
    assert plan.lane_perm.numel() % (32 * lpt) == 0
    out = forward(lib, plan, inputs)
    if lpt == 1 or mode == "hard":
        same = forward(lib, plan_of(env, mode, 1, "shared"), inputs)
        for x, y in zip(out, same):
            assert torch.equal(x, y)
    ref = k1.plain_episode(plan, *inputs)
    check_forward(out, ref)
    tot = ref[2][:, :7].sum(0)
    assert tot[1] >= 1 and tot[4] >= 1, tot  # emissions and transfers


@pytest.mark.parametrize("mode", ["soft", "st"])
@pytest.mark.parametrize("forced", list(FORCED))
def test_forced_layout_backward(lib, forced, mode):
    env, inputs = scene(tuple(CFG.items()), mode)
    lpt, where = FORCED[forced]
    w = torch.as_tensor(np.random.default_rng(0).uniform(
        -1, 1, env.num_timestep), dtype=torch.float32)
    if forced == "two_lanes":
        refused(lib, env, mode, lib.launch_itscp_hybrid_episode_bwd,
                (w, torch.zeros(env.n_phases, 9)), inputs)
        return
    plan = plan_of(env, mode, lpt, where)
    got = backward(lib, plan, inputs, w)
    if lpt == 1:
        same = backward(lib, plan_of(env, mode, 1, "shared"), inputs, w)
        assert torch.equal(got, same)
    check_gradient(got, k1.plain_episode_bwd(plan, w, *inputs))


@pytest.mark.parametrize("mode", ["hard", "soft", "bwd"])
def test_forced_layout_batch_equals_single_launches(lib, mode):
    env, inputs = scene(tuple(CFG.items()), "soft")
    plan = plan_of(env, "hard" if mode == "hard" else "soft", 2, "global")
    B = 4
    # episode 0 is the scene's; three more draws of the action and rand
    gen = torch.Generator().manual_seed(21)
    actions = torch.cat([inputs[0][None], torch.rand(
        (B - 1, *inputs[0].shape), generator=gen) * 0.4 + 0.3])
    rands = torch.stack([inputs[4]] + [env.draw_rand(gen)
                                       for _ in range(B - 1)])
    batched = (actions, *inputs[1:4], rands, *inputs[5:])
    rows = [(actions[e], *inputs[1:4], rands[e], *inputs[5:])
            for e in range(B)]
    if mode == "bwd":
        w = torch.as_tensor(np.random.default_rng(1).uniform(
            -1, 1, (B, plan.T)), dtype=torch.float32)
        out = (backward(lib, plan, batched, w, B),)
        singles = [(backward(lib, plan, rows[e], w[e].contiguous()),)
                   for e in range(B)]
    else:
        out = forward(lib, plan, batched, B)
        singles = [forward(lib, plan, rows[e]) for e in range(B)]
    for e in range(B):
        for x, y in zip(out, singles[e]):
            assert same_bits(x[e], y), (mode, e)
    assert torch.isfinite(out[0][0]).all()


@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("n", [5, 9])
def test_wide_grid_forward_matches_plain_version(lib, n, mode):
    env, inputs = scene(tuple(dict(WIDE, num_intersection=n).items()),
                        "soft")
    plan = env.fused_plan(mode != "hard")
    assert plan.lanes_per_thread == (2 if n == 9 else 1)
    out = forward(lib, plan, inputs)
    ref = k1.plain_episode(plan, *inputs)
    check_forward(out, ref, atol=1e-4)
    assert ref[2][:, 1].sum() >= 1  # vehicles emitted
