"""K1's cycle-stamped build (``-DDHTS_K1_CLOCK``, read by
``dhts_torch.ops.cuda.k1_clock``), compiled for the host, changes nothing.

The stamped and the plain build of ``csrc/itscp_hybrid_episode.cu`` are
compiled with g++ against ``csrc/cpu_emulation.h`` (where ``clock64()``
counts host nanoseconds) and called through the card's C launchers on a
short hybrid episode (T = 60) with emissions: the stamped build's reward,
queues, events and gradient equal the plain build's bit for bit, and its
events equal the plain PyTorch version's (reward rel 1e-5, queues abs
1e-5, the lane sums' order), in hard, soft and ``st`` mode and backward.
Every phase that ends at a barrier of the mode gets stamps, and so do the
reduction warp and the B2 work of a macro and a micro lane's thread; the
others none.
"""

import ctypes

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1
from dhts_torch.ops.cuda import k1_clock

torch.set_num_threads(1)

# the emission scene of test_torch_itscp_hybrid_episode_bwd.py at 4 Hz and
# 30 m/s on 10 m lanes: T = 60, an emission at step 20, an absorption, a
# deposit and transfers, one signal phase (9 action entries: 9 backward
# blocks)
CFG = dict(num_intersection=3, num_lane=1, lane_length=10.0,
           speed_limit=30.0, cell_length=10.0, policy_length=15,
           signal_length=15, simulation_frequency=4, random_seed=3,
           max_num_micro_vehicle_per_lane=4, mode="hybrid")
# the phases (csrc K1Phase) that get stamps: in hard mode C3 runs on to
# the step's end; in soft mode the blend's and the static mean's folds end
# at the barriers of the walk and of C3, and the lane queue follows
HARD_PHASES = ("A", "walk", "B2", "C1", "C2", "C3", "reduction_warp",
               "B2_macro_work", "B2_micro_work")
SOFT_PHASES = HARD_PHASES + ("lane_queue",)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("k1clock")
    try:
        plain = _build.build_cpu_emulation("itscp_hybrid_episode", out)
        clocked = _build.build_cpu_emulation(
            "itscp_hybrid_episode", out, defines=("DHTS_K1_CLOCK",))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    lib = k1.bind(ctypes.CDLL(str(clocked)))
    lib.itscp_hybrid_episode_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.itscp_hybrid_episode_clock.restype = ctypes.c_int
    return k1.bind(ctypes.CDLL(str(plain))), lib


def case(gate_mode):
    env = ItscpEnv(config=dict(CFG, use_fused_episode=True,
                               gate_mode=gate_mode),
                   schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    rand = env.draw_rand(torch.Generator().manual_seed(7))
    action = torch.as_tensor(
        np.random.default_rng(12).uniform(0.3, 0.7, env.action_size()),
        dtype=torch.float32)
    inputs = (action.reshape(env.n_phases, -1).contiguous(),
              env.data.schedule, env.data.mroute_next, env.data.mroute_prev,
              rand, env.data.inj_routes, env.base_state.route_pool)
    return env, inputs


def forward(lib, plan, inputs):
    out = (torch.zeros(()), torch.zeros(plan.T), torch.zeros(plan.T, 8))
    assert lib.launch_itscp_hybrid_episode_fwd(
        *k1.kernel_args(plan, inputs, out, 0)) == 0
    return out


@pytest.mark.parametrize("gate_mode", ["hard", "soft", "st"])
def test_stamped_forward_equals_unstamped_and_plain(libs, gate_mode):
    plain_lib, clocked = libs
    env, inputs = case("soft" if gate_mode == "hard" else gate_mode)
    plan = env.fused_plan(gate_mode != "hard")
    assert plan.T <= 60
    k1_clock.read_cycles(clocked, reset=True)
    got = forward(clocked, plan, inputs)
    cycles = dict(zip(k1_clock.PHASES, k1_clock.read_cycles(clocked)))
    ref = forward(plain_lib, plan, inputs)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    pr, pq, pe = k1.plain_episode(plan, *inputs)
    assert torch.equal(got[2], pe)
    assert pe[:, 1].sum() >= 1  # emissions happened
    assert float(got[0]) == pytest.approx(float(pr), rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(got[1].numpy(), pq.detach().numpy(), rtol=0,
                               atol=1e-5)
    stamped = HARD_PHASES if gate_mode == "hard" else SOFT_PHASES
    for name, c in cycles.items():
        assert (c > 0) == (name in stamped), (name, c)


def test_stamped_backward_equals_unstamped(libs):
    plain_lib, clocked = libs
    env, inputs = case("soft")
    plan = env.fused_plan(True)
    w = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, plan.T),
                        dtype=torch.float32)
    grads = []
    for lib in (clocked, plain_lib):
        grad = torch.zeros(plan.n_phases, plan.n_inter)
        assert lib.launch_itscp_hybrid_episode_bwd(
            *k1.kernel_args(plan, inputs, (w, grad), 0)) == 0
        grads.append(grad)
    assert torch.equal(grads[0], grads[1])
    assert torch.isfinite(grads[0]).all() and grads[0].norm() > 0
    cycles = dict(zip(k1_clock.PHASES, k1_clock.read_cycles(clocked)))
    for name, c in cycles.items():
        assert (c > 0) == (name in SOFT_PHASES), (name, c)
