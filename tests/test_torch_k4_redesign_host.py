"""K4's redesigned CUDA source, compiled for the host, against the plain
PyTorch version: the forward with a lane's interfaces spread over its
threads and a reduction warp, the trajectory it saves, and the reverse
sweep.

``csrc/itscp_macro_episode.cu`` is built with g++ against
``csrc/cpu_emulation.h`` (one fiber per CUDA thread, named barriers and
warp exchanges as on the card) and called through the card's C launchers,
at ``tests/test_itscp_fused.py``'s config, the macro preset of
``run_itscp_macro.sh`` and the 3x3 preset in macro mode (its first 60
steps: a block of 800 fibers), from the empty and a seeded state:

* the forward's reward and queues equal the plain version's bit for bit,
  saving or not, and the saved trajectory equals
  ``plain_macro_trajectory``'s; on the NaN probes (a NaN action entry, a
  NaN initial cell) NaN where the plain version's are, the rest equal;
* the reverse sweep, over the saved trajectory and replaying it, against
  autograd of the plain version and against the forward-mode derivative
  (the Dual blocks): cosine > 0.9999 and allclose(rtol 2e-2, atol 2e-3 *
  max|g|), the cells beyond a lane's ``num_cell`` exactly 0; over the saved
  trajectory bit-equal to replaying; two launches bit-equal; NaN positions
  equal autograd's;
* builds that take one and three threads a lane
  (``-DDHTS_K4_LANE_THREADS``: a thread's several interfaces and cells)
  agree with the plain version to the same standard, the forward bit for
  bit;
* the cycle-stamped build (``-DDHTS_K4_CLOCK``) gives the unstamped
  build's bits, and stamps every part of the forward and of the sweep.
"""

import ctypes

import pytest
import torch

from dhts_torch.ops.cuda import _build, k4_clock
from dhts_torch.ops.cuda import itscp_macro_episode as k4
from tests.test_torch_card_k4_redesign import (
    GRID3, GRID5, H100_SMEM, PRESET, PRESET_GRID3, PRESET_GRID4, SMALL, case,
    check_gradient, check_gradients, nan_positions_equal, same_bits,
    weights)
from tests.test_torch_card_nan_gate import k4_case, same

torch.set_num_threads(1)

# the scenes and the steps the host runs of each
CASES = {"small": (SMALL, None), "preset": (PRESET, None),
         "grid3": (GRID3, 60)}
# the scenes only the wide sweep takes: blocks of 864, 800 and 704 fibers
LARGE = {"grid5": (GRID5, 20), "preset_grid3": (PRESET_GRID3, 20),
         "preset_grid4": (PRESET_GRID4, 20)}
SCENES_ALL = {"preset": PRESET, "grid3": GRID3, "grid5": GRID5,
              "preset_grid3": PRESET_GRID3, "preset_grid4": PRESET_GRID4}


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    out = tmp_path_factory.mktemp("k4redesign")
    variants = {"plain": (), "clock": ("DHTS_K4_CLOCK",),
                "one": ("DHTS_K4_LANE_THREADS=1",),
                "three": ("DHTS_K4_LANE_THREADS=3",)}
    libs = {}
    try:
        for name, defines in variants.items():
            libs[name] = k4.bind(ctypes.CDLL(str(_build.build_cpu_emulation(
                "itscp_macro_episode", out, defines=defines))))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return libs


@pytest.fixture
def lib(builds):
    return builds["plain"]


def forward(lib, plan, ins, trajectory=False):
    reward, queues = torch.empty(()), torch.empty(plan.T)
    if not trajectory:
        assert lib.launch_itscp_macro_episode_fwd(*k4.kernel_args(
            plan, ins, (reward, queues), 0)) == 0
        return reward, queues
    traj = k4.new_trajectory(plan, "cpu")
    assert lib.launch_itscp_macro_episode_fwd_traj(*k4.kernel_args(
        plan, ins, (reward, queues, *traj), 0)) == 0
    return reward, queues, traj


def sweep(lib, plan, ins, w, traj=None):
    """The reverse sweep's (g_action, g_r0, g_y0), over ``traj`` or
    replaying."""
    replay = traj is None
    if replay:
        traj = k4.new_trajectory(plan, "cpu")
    grad = torch.full((plan.n_action + 2 * plan.L * plan.C,), float("nan"))
    assert lib.launch_itscp_macro_episode_reverse(*k4.kernel_args(
        plan, ins, (w, *traj, grad), 0, replay=replay)) == 0
    return k4._grad_parts(plan, grad, (True, True, True))


def tangents(lib, plan, ins, w, needs):
    grad = torch.zeros(plan.n_action + 2 * plan.L * plan.C)
    assert lib.launch_itscp_macro_episode_bwd(*k4.kernel_args(
        plan, ins, (w, grad), 0, k4.seed_counts(plan, needs))) == 0
    return k4._grad_parts(plan, grad, needs)


@pytest.mark.parametrize("seeded", [False, True], ids=["empty", "seeded"])
@pytest.mark.parametrize("scene", list(CASES))
def test_forward_and_trajectory_are_bit_equal_to_plain(lib, scene, seeded):
    cfg, T = CASES[scene]
    plan, ins = case(cfg, seeded, T=T)
    reward, queues, traj = forward(lib, plan, ins, trajectory=True)
    r2, q2 = forward(lib, plan, ins)
    ref_r, ref_q = k4.plain_macro_episode(plan, *ins)
    ref = k4.plain_macro_trajectory(plan, *ins)
    assert torch.equal(reward, ref_r) and torch.equal(queues, ref_q)
    assert same_bits(reward, r2) and same_bits(queues, q2)
    assert torch.equal(traj.states, ref.states)
    assert torch.equal(traj.sharpness, ref.sharpness)
    assert float(queues.abs().max()) > 0


@pytest.mark.parametrize("nan", ["action", "cell"])
def test_forward_keeps_plain_nan_on_probes(lib, nan):
    plan, ins = k4_case(nan)
    reward, queues, traj = forward(lib, plan, ins, trajectory=True)
    ref_r, ref_q = k4.plain_macro_episode(plan, *ins)
    ref = k4.plain_macro_trajectory(plan, *ins)
    assert torch.isnan(queues).any()
    for got, want in ((reward, ref_r), (queues, ref_q),
                      (traj.states, ref.states),
                      (traj.sharpness, ref.sharpness)):
        assert same(got, want)


@pytest.mark.parametrize("seeded", [False, True], ids=["empty", "seeded"])
@pytest.mark.parametrize("scene", list(CASES))
def test_reverse_sweep_matches_autograd(lib, scene, seeded):
    cfg, T = CASES[scene]
    plan, ins = case(cfg, seeded, T=T)
    w = weights(plan.T)
    *_, traj = forward(lib, plan, ins, trajectory=True)
    got = sweep(lib, plan, ins, w, traj)
    check_gradients(plan, got, k4.plain_macro_episode_bwd(plan, w, *ins))
    replayed = sweep(lib, plan, ins, w)
    again = sweep(lib, plan, ins, w, traj)
    assert all(same_bits(a, b) for a, b in zip(got, replayed))
    assert all(same_bits(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("scene, needs", [
    ("small", (True, True, True)), ("preset", (True, False, False)),
    ("grid3", (True, False, False))], ids=["small", "preset", "grid3"])
def test_reverse_sweep_matches_the_tangents(lib, scene, needs):
    cfg, T = CASES[scene]
    plan, ins = case(cfg, True, T=T)
    w = weights(plan.T, seed=1)
    got = sweep(lib, plan, ins, w)
    want = tangents(lib, plan, ins, w, needs)
    pad = ~plan.cell_mask
    for g, t, n, p in zip(got, want, needs, (None, pad, pad)):
        if n:
            check_gradient(g, t, p)


@pytest.mark.parametrize("replay", [False, True], ids=["saved", "replay"])
@pytest.mark.parametrize("nan", ["action", "cell"])
def test_reverse_sweep_nan_positions_equal_autograd(lib, nan, replay):
    plan, ins = k4_case(nan)
    w = weights(plan.T)
    traj = None if replay else forward(lib, plan, ins, trajectory=True)[2]
    got = sweep(lib, plan, ins, w, traj)
    ref = k4.plain_macro_episode_bwd(plan, w, *ins)
    assert any(bool(torch.isnan(g).any()) for g in got)
    assert nan_positions_equal(got, ref)
    pad = ~plan.cell_mask
    assert float(got[1][pad].abs().max()) == 0.0
    assert float(got[2][pad].abs().max()) == 0.0


@pytest.mark.parametrize("variant", ["one", "three"])
@pytest.mark.parametrize("scene", ["small", "preset"])
def test_other_lane_layouts_agree(builds, variant, scene):
    cfg, T = CASES[scene]
    plan, ins = case(cfg, True, T=T)
    G = k4.lane_threads(builds[variant], plan, k4.KERNEL_REVERSE)
    assert G == (1 if variant == "one" else 3)
    reward, queues, traj = forward(builds[variant], plan, ins, True)
    ref_r, ref_q = k4.plain_macro_episode(plan, *ins)
    assert torch.equal(reward, ref_r) and torch.equal(queues, ref_q)
    assert torch.equal(traj.states,
                       k4.plain_macro_trajectory(plan, *ins).states)
    w = weights(plan.T)
    got = sweep(builds[variant], plan, ins, w, traj)
    check_gradients(plan, got, k4.plain_macro_episode_bwd(plan, w, *ins))


@pytest.mark.parametrize("scene, threads", [
    ("preset", (8, 8, 8)), ("grid3", (5, 3, 2)), ("grid5", (2, 1, 2)),
    ("preset_grid3", (2, 0, 2)), ("preset_grid4", (1, 0, 1))],
    ids=["preset", "grid3", "grid5", "preset_grid3", "preset_grid4"])
def test_lane_threads_of_the_scenes(lib, scene, threads):
    """The threads a lane of the forward, the forward-mode derivative and
    the sweep, as on the card: the narrow sweep's 384 threads hold the
    3x3 preset at 2 a lane; only the wide one takes the larger scenes; the
    derivative's shared memory cannot hold the preset's lanes on the 3x3
    and 4x4 grids."""
    plan, _ = case(dict(SCENES_ALL[scene]), False)
    assert tuple(k4.lane_threads(lib, plan, kernel) for kernel in
                 (k4.KERNEL_FWD, k4.KERNEL_TANGENTS,
                  k4.KERNEL_REVERSE)) == threads


@pytest.mark.parametrize("scene", list(LARGE))
def test_large_scenes_forward_and_sweep(lib, scene):
    """The scenes the narrow sweep cannot take (the wide one, its state in
    shared memory at the 5x5 grid, in global memory for the preset's lanes
    on the 3x3 and 4x4 grids, where the 4x4 grid's forward keeps its state
    in global memory too): the forward bit-equal to the plain version, the
    sweep over the saved trajectory against autograd of it and bit-equal
    to replaying."""
    cfg, T = LARGE[scene]
    plan, ins = case(cfg, True, T=T)
    if scene != "grid5":  # more than a block's shared memory
        assert lib.itscp_macro_episode_smem(plan.L, plan.C,
                                            k4.KERNEL_REVERSE) > H100_SMEM
    if scene == "preset_grid4":
        assert lib.itscp_macro_episode_smem(plan.L, plan.C,
                                            k4.KERNEL_FWD) > H100_SMEM
    reward, queues, traj = forward(lib, plan, ins, trajectory=True)
    ref_r, ref_q = k4.plain_macro_episode(plan, *ins)
    assert torch.equal(reward, ref_r) and torch.equal(queues, ref_q)
    assert torch.equal(traj.states,
                       k4.plain_macro_trajectory(plan, *ins).states)
    w = weights(plan.T)
    got = sweep(lib, plan, ins, w, traj)
    check_gradients(plan, got, k4.plain_macro_episode_bwd(plan, w, *ins))
    replayed = sweep(lib, plan, ins, w)
    assert all(same_bits(a, b) for a, b in zip(got, replayed))


def test_clock_build_is_bit_equal_and_stamps_every_part(builds):
    plain, clocked = builds["plain"], builds["clock"]
    plan, ins = case(SMALL, True)
    w = weights(plan.T)
    k4_clock.read_cycles(clocked, reset=True)
    outs = {}
    for name, lib in (("plain", plain), ("clock", clocked)):
        reward, queues, traj = forward(lib, plan, ins, trajectory=True)
        outs[name] = (reward, queues, *traj, *sweep(lib, plan, ins, w, traj),
                      *tangents(lib, plan, ins, w, (True, False, True))[::2])
    assert all(same_bits(a, b) for a, b in zip(outs["plain"],
                                               outs["clock"]))
    cyc = k4_clock.read_cycles(clocked)
    assert cyc["steps"] == 2 * plan.T  # the forward and the Dual blocks'
    assert cyc["reverse_steps"] == plan.T
    assert all(c > 0 for c in cyc.values())


def test_launchers_refuse_bad_launches(lib):
    plan, ins = case(SMALL, False)
    w = torch.ones(plan.T)
    traj = k4.new_trajectory(plan, "cpu")
    grad = torch.empty(plan.n_action + 2 * plan.L * plan.C)
    # no trajectory to sweep over and none to replay into
    null = (torch.empty(0),) * 2
    args = k4.kernel_args(plan, ins, (w, *null, grad), 0, replay=False)
    args = list(args)
    args[10] = args[11] = ctypes.c_void_p(0)
    assert lib.launch_itscp_macro_episode_reverse(*args) != 0
    # more cells per lane than the kernel takes, more intersections than
    # lanes
    for bad in (plan._replace(C=17), plan._replace(n_inter=plan.L + 1)):
        assert lib.launch_itscp_macro_episode_reverse(*k4.kernel_args(
            bad, ins, (w, *traj, grad), 0, replay=True)) != 0
        assert lib.launch_itscp_macro_episode_fwd_traj(*k4.kernel_args(
            bad, ins, (torch.empty(()), torch.empty(plan.T), *traj),
            0)) != 0
