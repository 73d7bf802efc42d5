"""STEP's cycle-stamped build (``-DDHTS_STEP_CLOCK``, read by
``dhts_torch.ops.cuda.spatial_clock``), compiled for the host, changes
nothing.

The stamped and the plain build of ``csrc/itscp_spatial_step.cu`` are
compiled with g++ against ``csrc/cpu_emulation.h`` (where ``clock64()``
counts host nanoseconds) and called through the same launchers on the
micro and the hybrid scene of ``tests/test_torch_spatial_host.py`` (the
first 20 steps, B = 2, in two calls): the hard and soft forward's carry,
queues, events and waves, and the derivative's carry, tangents and
gradient are bit-equal between the builds; every part of the step
(``spatial_clock.PARTS``) stamps, and the stamps count the steps run.
"""

import ctypes

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import _build, spatial_clock
from dhts_torch.ops.cuda import itscp_spatial_step as k6

torch.set_num_threads(1)

B, T = 2, 20
MICRO_CFG = dict(num_intersection=1, num_lane=2, lane_length=20.0,
                 speed_limit=20.0, cell_length=5.0, policy_length=4,
                 signal_length=2, simulation_frequency=10, random_seed=3,
                 max_num_micro_vehicle_per_lane=4, mode="micro")
HYBRID_CFG = dict(num_intersection=1, num_lane=2, lane_length=5.0,
                  speed_limit=20.0, cell_length=5.0, policy_length=16,
                  signal_length=8, simulation_frequency=10, random_seed=3,
                  max_num_micro_vehicle_per_lane=4, mode="hybrid")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("stepclock")
    try:
        plain = _build.build_cpu_emulation("itscp_spatial_step", out)
        clocked = _build.build_cpu_emulation("itscp_spatial_step", out,
                                             defines=("DHTS_STEP_CLOCK",))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return (k6.bind(ctypes.CDLL(str(plain))),
            spatial_clock.bind_clock(ctypes.CDLL(str(clocked))))


def case(cfg, kernel):
    env = ItscpEnv(config=cfg, schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    plan = k6.make_plan(env, kernel != "hard")._replace(T=T)
    gen = torch.Generator().manual_seed(7)
    rand = torch.stack([env.draw_rand(gen)[:T] for _ in range(B)])
    action = torch.as_tensor(np.random.default_rng(5).uniform(
        0.3, 0.7, env.action_size()), dtype=torch.float32)
    d = env.data
    inputs = (action.reshape(plan.n_phases, -1).contiguous(),
              rand.contiguous(), d.schedule[:T].contiguous(),
              d.mroute_next[:T].contiguous(), d.mroute_prev[:T].contiguous(),
              k6.route_table(d.inj_routes, env.base_state.route_pool))
    return plan, inputs


def run(lib, plan, inputs, kernel):
    """Two launcher calls (steps 0-6, 7-19); everything they write."""
    if kernel == "dual":
        state = list(k6.dual_state(plan, B, "cpu"))
        outs = [torch.as_tensor(np.random.default_rng(2).uniform(
            -1, 1, (B, T)), dtype=torch.float32),
            torch.zeros(state[0].shape[0], dtype=torch.float64), None]
        launcher, written = lib.launch_itscp_spatial_step_bwd, outs[1:2]
    else:
        fb, ib = k6.empty_state(plan, B, "cpu")
        state = [fb, None, ib]
        outs = [torch.zeros(B, T), torch.zeros(B, T, 3, dtype=torch.int32),
                torch.zeros(B, T)]
        launcher, written = lib.launch_itscp_spatial_step_fwd, outs
    for t0, n in ((0, 7), (7, T - 7)):
        assert launcher(*k6.kernel_args(plan, state, inputs, outs, B, t0, n,
                                        0)) == 0
    return [x for x in state if x is not None] + written


@pytest.mark.parametrize("kernel", ["hard", "soft", "dual"])
@pytest.mark.parametrize("cfg", [MICRO_CFG, HYBRID_CFG],
                         ids=["micro", "hybrid"])
def test_stamped_step_equals_unstamped(libs, cfg, kernel):
    plain, clocked = libs
    plan, inputs = case(cfg, kernel)
    spatial_clock.read_cycles(clocked, reset=True)
    stamped = run(clocked, plan, inputs, kernel)
    stamps = spatial_clock.read_cycles(clocked)
    ref = run(plain, plan, inputs, kernel)
    for a, b in zip(stamped, ref):
        assert torch.equal(a, b)
    assert all(torch.isfinite(x).all() for x in ref
               if x.is_floating_point())
    # block 0 stamps each of its steps, in every part
    assert stamps[-1] == T
    for name, c in zip(spatial_clock.PARTS, stamps[:-1]):
        assert c > 0, name
