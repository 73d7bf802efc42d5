"""K4's redesigned kernels on the card (skipped without a CUDA device): the
forward with a lane's interfaces spread over its threads and a reduction
warp, the trajectory it saves, and the reverse sweep, against the plain
PyTorch version on the same CUDA tensors, at the macro preset of
``run_itscp_macro.sh`` (L = 40, C = 7, T = 300) and the 3x3 preset in
macro mode (L = 144, C = 4, T = 600), from the empty and a seeded state:

* forward: reward rel <= 1e-5 and queues abs <= 1e-4 against the plain
  version (``chip_smoke.py``'s standard: PyTorch's float64 lane sums on the
  card take another order); the saved states allclose(rtol 1e-6, atol
  1e-6) and the sharpness rel 1e-5 against the plain trajectory, and the
  forward that saves bit-equal to the one that does not;
* the reverse sweep's action, r0 and y0 gradients against autograd of the
  plain version and against the forward-mode derivative
  (``macro_episode_tangents``): cosine > 0.9999 and allclose(rtol 2e-2,
  atol 2e-3 * max|g|), finite, the cells beyond a lane's ``num_cell``
  exactly 0; over the saved trajectory bit-equal to replaying; two launches
  bit-equal;
* NaN positions of the sweep's gradients equal autograd's for a NaN action
  entry and a NaN initial cell (``tests/test_torch_card_nan_gate.py``'s
  cases);
* the factory: one forward launch and one reverse launch of one block for
  all three gradients, and no forward-mode blocks.

Besides the two scenes, the larger three that only the wide sweep takes:
the 5x5 grid of ``run_itscp_5x5.sh`` in macro mode (L = 400, C = 4) and the
macro preset's lanes on the 3x3 grid (L = 360, C = 7; the sweep's state in
global memory, and no forward-mode block fits it) and on the 4x4 grid (L =
640, C = 7; the forward's state in global memory too).

``tests/test_torch_k4_redesign_host.py`` imports the helpers here. This
file imports nothing of JAX::

    python -m pytest --noconftest -q tests/test_torch_card_k4_redesign.py
"""

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops import arz
from dhts_torch.ops.cuda import itscp_macro_episode as k4

torch.set_num_threads(1)

# tests/test_itscp_fused.py's config, the macro preset of run_itscp_macro.sh
# and the 3x3 preset in macro mode
SMALL = dict(num_intersection=1, num_lane=1, lane_length=20.0,
             speed_limit=20.0, cell_length=5.0, policy_length=6,
             signal_length=2, simulation_frequency=10, random_seed=3,
             max_num_micro_vehicle_per_lane=4, mode="macro")
PRESET = dict(num_intersection=1, num_lane=3, lane_length=30.0,
              speed_limit=60.0, policy_length=10, signal_length=2,
              random_seed=3, mode="macro")
GRID3 = dict(num_intersection=3, num_lane=1, lane_length=5.0,
             speed_limit=60.0, policy_length=20, signal_length=4,
             random_seed=3, mode="macro")
# the larger scenes: the 5x5 grid of run_itscp_5x5.sh in macro mode (L =
# 400, C = 4: the wide sweep, its state in shared memory), and the macro
# preset's three lanes of 30 m on the 3x3 grid (L = 360, C = 7: the wide
# sweep, its state in global memory) and on the 4x4 grid (L = 640, C = 7:
# the forward's state in global memory too)
GRID5 = dict(GRID3, num_intersection=5)
PRESET_GRID3 = dict(PRESET, num_intersection=3)
PRESET_GRID4 = dict(PRESET, num_intersection=4)
SCENES = {"small": SMALL, "preset": PRESET, "grid3": GRID3, "grid5": GRID5,
          "preset_grid3": PRESET_GRID3, "preset_grid4": PRESET_GRID4}
# the most dynamic shared memory an H100's block takes (the opt-in limit)
H100_SMEM = 227 * 1024


def case(cfg, seeded, device="cpu", seed=5, T=None):
    """A scene's plan and inputs: actions uniform in [0.3, 0.7], an empty
    or a seeded initial state (r0 in [0.05, 0.6] on the valid cells, y0 of
    speeds in [0.3, 1] u_max); ``T``: the first T steps only."""
    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device=device)
    env.reset()
    plan = k4.make_plan(env.spec, env.meta, env.config)
    d = env.data
    sched, mnext, mprev = d.schedule, d.mroute_next, d.mroute_prev
    if T is not None:
        plan = plan._replace(T=T)
        sched, mnext, mprev = (x[:T].contiguous() for x in (sched, mnext,
                                                             mprev))
    rng = np.random.default_rng(seed)
    L, C, u_max = plan.L, plan.C, plan.floats[0]
    m = plan.cell_mask
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    r0 = torch.zeros((L, C), device=device)
    y0 = torch.zeros((L, C), device=device)
    if seeded:
        r0 = torch.where(m, t(rng.uniform(0.05, 0.6, (L, C))), 0.0)
        y0 = torch.where(m, arz.compute_y(
            r0, t(rng.uniform(0.3, 1.0, (L, C)) * u_max), u_max), 0.0)
    action = t(rng.uniform(0.3, 0.7, (plan.n_phases, plan.n_inter)))
    return plan, (action, sched, mnext, mprev, r0.contiguous(),
                  y0.contiguous())


def weights(T, device="cpu", seed=0):
    """Per-step loss weights: the reward's cotangent plus a loss on the
    queues."""
    return torch.as_tensor(np.random.default_rng(seed).uniform(-1, 1, T),
                           dtype=torch.float32, device=device)


def check_gradient(got, ref, pad=None, cos_min=0.9999):
    """The fused standard: finite, cosine > cos_min, allclose(rtol 2e-2,
    atol 2e-3 * max|ref|); the cells ``pad`` exactly 0."""
    if pad is not None:
        assert float(got[pad].abs().max()) == 0.0
    got, ref = got.double().flatten(), ref.double().flatten()
    scale = float(ref.abs().max())
    assert torch.isfinite(got).all() and scale > 0
    assert float(got @ ref / (got.norm() * ref.norm())) > cos_min
    assert torch.allclose(got, ref, rtol=2e-2, atol=2e-3 * scale)


def check_gradients(plan, got, ref):
    pad = ~plan.cell_mask
    check_gradient(got[0], ref[0])
    check_gradient(got[1], ref[1], pad)
    check_gradient(got[2], ref[2], pad)


def same_bits(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def nan_positions_equal(got, ref) -> bool:
    return all(torch.equal(torch.isnan(a), torch.isnan(b))
               for a, b in zip(got, ref))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU path")
    return torch.device("cuda")


CARD_SCENES = ["preset", "grid3", "grid5", "preset_grid3", "preset_grid4"]


@pytest.mark.parametrize("seeded", [False, True], ids=["empty", "seeded"])
@pytest.mark.parametrize("scene", CARD_SCENES)
def test_forward_and_trajectory_match_plain(card, scene, seeded):
    plan, ins = case(SCENES[scene], seeded, card)
    reward, queues, traj = k4.macro_episode_fwd(plan, *ins, trajectory=True)
    r2, q2 = k4.macro_episode_fwd(plan, *ins)
    ref_r, ref_q = k4.plain_macro_episode(plan, *ins)
    ref = k4.plain_macro_trajectory(plan, *ins)
    torch.cuda.synchronize()
    assert same_bits(reward, r2) and same_bits(queues, q2)
    assert abs(float(reward) - float(ref_r)) <= 1e-5 * abs(float(ref_r))
    assert float((queues - ref_q).abs().max()) <= 1e-4
    assert torch.allclose(traj.states, ref.states, rtol=1e-6, atol=1e-6)
    assert torch.allclose(traj.sharpness, ref.sharpness, rtol=1e-5, atol=0)


@pytest.mark.parametrize("seeded", [False, True], ids=["empty", "seeded"])
@pytest.mark.parametrize("scene", CARD_SCENES)
def test_reverse_sweep_matches_autograd_and_tangents(card, scene, seeded):
    plan, ins = case(SCENES[scene], seeded, card)
    w = weights(plan.T, card)
    *_, traj = k4.macro_episode_fwd(plan, *ins, trajectory=True)
    got = k4.macro_episode_bwd(plan, w, *ins, traj=traj)
    again = k4.macro_episode_bwd(plan, w, *ins, traj=traj)
    replayed = k4.macro_episode_bwd(plan, w, *ins)
    ref = k4.plain_macro_episode_bwd(plan, w, *ins)
    torch.cuda.synchronize()
    check_gradients(plan, got, ref)
    # the forward-mode derivative where its block fits the scene
    if k4.lane_threads(k4._library(), plan, k4.KERNEL_TANGENTS):
        check_gradients(plan, got, k4.macro_episode_tangents(plan, w, *ins))
    assert all(same_bits(a, b) for a, b in zip(got, again))
    assert all(same_bits(a, b) for a, b in zip(got, replayed))


@pytest.mark.parametrize("nan", ["action", "cell"])
def test_reverse_sweep_nan_positions_equal_autograd(card, nan):
    from tests.test_torch_card_nan_gate import k4_case

    plan, ins = k4_case(nan, "cuda")
    w = weights(plan.T, card)
    got = k4.macro_episode_bwd(plan, w, *ins)
    ref = k4.plain_macro_episode_bwd(plan, w, *ins)
    torch.cuda.synchronize()
    assert nan_positions_equal(got, ref)
    assert any(bool(torch.isnan(g).any()) for g in got)


@pytest.mark.parametrize("scene", ["preset", "grid5", "preset_grid3",
                                   "preset_grid4"])
def test_factory_takes_one_reverse_block(card, scene):
    cfg = SCENES[scene]
    plan, (a, sched, mnext, mprev, r0, y0) = case(cfg, True, card)
    fn = k4.make_fused_itscp_macro_episode
    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device=card)
    env.reset()
    fn = fn(env.spec, env.meta, env.config)
    n_f, n_b = k4.macro_episode_fwd.launches, k4.macro_episode_bwd.launches
    n_t = k4.macro_episode_tangents.launches
    leaves = [x.clone().requires_grad_(True) for x in (a, r0, y0)]
    reward, queues = fn(leaves[0], sched, mnext, mprev, leaves[1], leaves[2])
    (-reward).backward()
    # one forward and one sweep (a grid of one block), no forward-mode
    # blocks
    assert k4.macro_episode_fwd.launches == n_f + 1
    assert k4.macro_episode_bwd.launches == n_b + 1
    assert k4.macro_episode_tangents.launches == n_t
    # the loss -reward = sum(queues): a weight of 1 a step
    w = torch.ones((plan.T,), device=card)
    ref = k4.plain_macro_episode_bwd(plan, w, a, sched, mnext, mprev, r0, y0)
    check_gradients(plan, [x.grad for x in leaves], ref)
