"""The fused all-macro episode's CUDA source, compiled for the host, against
the plain PyTorch version.

``csrc/itscp_macro_episode.cu`` is built with g++ against
``csrc/cpu_emulation.h`` (one fiber per CUDA thread, the blocks of a grid
one after another) and called through the same C launchers as on the card.

* Forward: reward and queues[T] equal the plain version's bit for bit (the
  same float32 operations in the same order; a lane's cells summed in cell
  order in float32, the lanes in float64 rounded once, the queues in step
  order), at ``tests/test_itscp_fused.py``'s config, the macro preset of
  ``run_itscp_macro.sh`` and the 3x3 preset in macro mode, from an empty
  and a seeded state, and on the NaN probes.
* Backward (forward-mode tangents, one block per seeded entry) against
  autograd of the plain version for random per-step loss weights:
  cosine > 0.9999 and allclose(rtol 2e-2, atol 2e-3 * max|g|), the fused
  standard with soft gates; finite and nonzero; the cells beyond a lane's
  ``num_cell`` exactly 0. The host runs the grid's blocks one after
  another, so all three gradients are checked at the small config and the
  action's at the macro preset.
* Only the requested groups of blocks run: the other entries of the
  gradient buffer keep what the caller put there.
"""

import ctypes

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops import arz
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_macro_episode as k4

torch.set_num_threads(1)

CFG = dict(num_intersection=1, num_lane=1, lane_length=20.0,
           speed_limit=20.0, cell_length=5.0, policy_length=6,
           signal_length=2, simulation_frequency=10, random_seed=3,
           max_num_micro_vehicle_per_lane=4, mode="macro")
PRESET = dict(num_intersection=1, num_lane=3, lane_length=30.0,
              speed_limit=60.0, policy_length=10, signal_length=2,
              random_seed=3, mode="macro")
GRID3 = dict(num_intersection=3, num_lane=1, lane_length=5.0,
             speed_limit=60.0, policy_length=20, signal_length=4,
             random_seed=3, mode="macro")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation(
            "itscp_macro_episode", tmp_path_factory.mktemp("k4"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return k4.bind(ctypes.CDLL(str(path)))


def case(cfg, seeded, seed=5, probe=None):
    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    plan = k4.make_plan(env.spec, env.meta, env.config)
    rng = np.random.default_rng(seed)
    L, C, u_max = plan.L, plan.C, plan.floats[0]
    m = plan.cell_mask
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)
    r0 = torch.zeros((L, C))
    y0 = torch.zeros((L, C))
    if seeded:
        r0 = torch.where(m, t(rng.uniform(0.05, 0.6, (L, C))), 0.0)
        y0 = torch.where(m, arz.compute_y(
            r0, t(rng.uniform(0.3, 1.0, (L, C)) * u_max), u_max), 0.0)
    d = env.data
    mnext, mprev = d.mroute_next, d.mroute_prev
    if probe == "vacuum":
        r0[0], y0[0] = 0.0, 0.0
    elif probe == "jam":
        r0[1] = torch.where(m[1], 1.0, 0.0)
        y0[1] = torch.where(m[1], arz.compute_y(
            torch.ones(C), torch.zeros(C), u_max), 0.0)
    elif probe == "routes":
        mnext, mprev = torch.full_like(mnext, -1), torch.full_like(mprev, -1)
    action = t(rng.uniform(0.3, 0.7, (plan.n_phases, plan.n_inter)))
    return plan, (action, d.schedule, mnext, mprev, r0.contiguous(),
                  y0.contiguous())


def host_forward(lib, plan, ins):
    reward = torch.empty(())
    queues = torch.empty(plan.T)
    assert lib.launch_itscp_macro_episode_fwd(*k4.kernel_args(
        plan, ins, (reward, queues), 0)) == 0
    return reward, queues


def host_backward(lib, plan, ins, w, needs, fill=0.0):
    grad = torch.full((plan.n_action + 2 * plan.L * plan.C,), fill)
    seeds = k4.seed_counts(plan, needs)
    assert lib.launch_itscp_macro_episode_bwd(*k4.kernel_args(
        plan, ins, (w, grad), 0, seeds)) == 0
    return grad


@pytest.mark.parametrize("seeded", [False, True], ids=["empty", "seeded"])
@pytest.mark.parametrize("cfg", [CFG, PRESET, GRID3],
                         ids=["small", "preset", "grid3"])
def test_forward_source_is_bit_exact(lib, cfg, seeded):
    plan, ins = case(cfg, seeded)
    reward, queues = host_forward(lib, plan, ins)
    ref_r, ref_q = k4.plain_macro_episode(plan, *ins)
    assert torch.equal(reward, ref_r) and torch.equal(queues, ref_q)
    assert float(queues.abs().max()) > 0


@pytest.mark.parametrize("probe", ["vacuum", "jam", "routes"])
def test_forward_source_is_bit_exact_on_probes(lib, probe):
    plan, ins = case(CFG, True, probe=probe)
    reward, queues = host_forward(lib, plan, ins)
    ref_r, ref_q = k4.plain_macro_episode(plan, *ins)
    assert torch.isfinite(queues).all()
    assert torch.equal(reward, ref_r) and torch.equal(queues, ref_q)


def check_gradient(got, ref, pad=None):
    if pad is not None:
        assert float(got[pad].abs().max()) == 0.0
    got, ref = got.double().flatten(), ref.double().flatten()
    scale = float(ref.abs().max())
    assert torch.isfinite(got).all() and scale > 0
    assert float(got @ ref / (got.norm() * ref.norm())) > 0.9999
    assert torch.allclose(got, ref, rtol=2e-2, atol=2e-3 * scale)


@pytest.mark.parametrize("seeded", [False, True], ids=["empty", "seeded"])
def test_backward_source_matches_autograd(lib, seeded):
    plan, ins = case(CFG, seeded)
    w = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, plan.T),
                        dtype=torch.float32)
    ref = k4.plain_macro_episode_bwd(plan, w, *ins)
    grad = host_backward(lib, plan, ins, w, (True, True, True))
    NA, LC = plan.n_action, plan.L * plan.C
    pad = ~plan.cell_mask
    check_gradient(grad[:NA], ref[0])
    check_gradient(grad[NA:NA + LC].view(plan.L, plan.C), ref[1], pad)
    check_gradient(grad[NA + LC:].view(plan.L, plan.C), ref[2], pad)


def test_backward_source_matches_autograd_at_the_preset(lib):
    plan, ins = case(PRESET, False)
    w = torch.full((plan.T,), -1.0)
    ref = k4.plain_macro_episode_bwd(plan, w, *ins,
                                     needs=(True, False, False))
    grad = host_backward(lib, plan, ins, w, (True, False, False))
    check_gradient(grad[:plan.n_action], ref[0])


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, False),
                                   (False, False, True), (True, False, True)],
                         ids=["action", "r0", "y0", "action_y0"])
def test_backward_launches_only_the_requested_blocks(lib, needs):
    plan, ins = case(CFG, True, seed=6)
    w = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, plan.T),
                        dtype=torch.float32)
    full = host_backward(lib, plan, ins, w, (True, True, True))
    part = host_backward(lib, plan, ins, w, needs, fill=float("nan"))
    NA, LC = plan.n_action, plan.L * plan.C
    cells = plan.cells.long()
    groups = (torch.arange(NA), NA + cells, NA + LC + cells)
    written = torch.zeros(NA + 2 * LC, dtype=torch.bool)
    for idx, n in zip(groups, needs):
        written[idx] = n
    assert torch.equal(part[written], full[written])
    assert torch.isnan(part[~written]).all()


def test_launchers_refuse_bad_launches(lib):
    plan, ins = case(CFG, False)
    w = torch.ones(plan.T)
    grad = torch.zeros(plan.n_action + 2 * plan.L * plan.C)
    # more action blocks than entries, and more cells than the scene has
    for seeds in ((plan.n_action + 1, 0, 0), (0, plan.L * plan.C + 1, 0)):
        assert lib.launch_itscp_macro_episode_bwd(*k4.kernel_args(
            plan, ins, (w, grad), 0, seeds)) != 0
    # more cells per lane than a thread holds
    wide = plan._replace(C=17)
    assert lib.launch_itscp_macro_episode_fwd(*k4.kernel_args(
        wide, ins, (torch.empty(()), torch.empty(plan.T)), 0)) != 0
    assert lib.itscp_macro_episode_smem(plan.L, plan.C, 1) > \
        lib.itscp_macro_episode_smem(plan.L, plan.C, 0)


@pytest.mark.parametrize("header", ["dhts_scalar.cuh", "itscp_step.cuh"])
def test_editing_a_shared_header_names_a_new_library(tmp_path, header):
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    files = [f.name for f in _build._included(
        csrc / "itscp_macro_episode.cu", csrc, set())]
    assert header in files
    before = _build.library_path("itscp_macro_episode", csrc)
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("itscp_macro_episode", csrc) != before
