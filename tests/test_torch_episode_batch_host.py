"""Kernel K1 with an episode axis, compiled for the host, against single
launches of the same source.

The CUDA source is built with g++ against ``csrc/cpu_emulation.h`` (one
fiber per CUDA thread, the blocks of a grid one after another) and called
through the card's C launchers. One launch of B = 3 episodes must equal
three launches of one episode bit for bit: reward, queues[T], all eight
event rows and, backward, the action gradients. Two batches:

* three scenarios of ``reset_batch(3, seed=11)`` (schedules, macro routes,
  waiting pools and actions per episode; the emission pool shared), and
* E = 3 episodes of one scene (scene data and action shared, stride 0)
  with three different draws ``rand[3, T, L]``, on an all-micro grid
  whose open boundaries inject vehicles by the draws (the 3x3 hybrid
  scene's open boundaries are macro lanes: its episodes ignore ``rand``).

Each episode keeps its own running means (the signal blend's and the
queue gates'), queue sum and events: the draws differ, so a block that
read another episode's statistics would differ from its single launch.
The backward's scenes have at most 18 action entries (the hybrid one is
shorter, with two signal phases): the host runs one block per episode and
action entry, one after another.
"""

import ctypes

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

torch.set_num_threads(1)

EMISSION_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                    speed_limit=20.0, cell_length=5.0, policy_length=16,
                    signal_length=2, simulation_frequency=10, random_seed=3,
                    max_num_micro_vehicle_per_lane=4, mode="hybrid")
TWO_PHASE_CFG = dict(EMISSION_CFG, policy_length=8, signal_length=4)
MICRO_CFG = dict(num_intersection=2, num_lane=2, lane_length=20.0,
                 speed_limit=30.0, policy_length=8, signal_length=2,
                 simulation_frequency=10, random_seed=5, mode="micro")
FWD_CFG = {"scenarios": EMISSION_CFG, "draws": MICRO_CFG}
BWD_CFG = {"scenarios": TWO_PHASE_CFG, "draws": MICRO_CFG}
B = 3


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation(
            "itscp_hybrid_episode", tmp_path_factory.mktemp("k1b"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return k1.bind(ctypes.CDLL(str(path)))


def batch_case(cfg, kind, differentiable, gate_mode="soft"):
    """The plan and the batched inputs of ``kind``: "scenarios" (every
    input but the emission pool per episode) or "draws" (only ``rand``)."""
    env = ItscpEnv(config=dict(cfg, use_fused_episode=True,
                               gate_mode=gate_mode),
                   schedule_fn=problem.problem_1 if cfg["mode"] == "hybrid"
                   else problem.random_schedule, device="cpu")
    rng = np.random.default_rng(4)
    lead = (B,) if kind == "scenarios" else ()
    if kind == "scenarios":
        env.reset_batch(B, seed=11)
        d = env.batch_data
    else:
        env.reset(seed=11)
        d = env.data
    action = torch.as_tensor(rng.uniform(0.2, 0.8, (
        *lead, env.n_phases, env.action_size() // env.n_phases)),
        dtype=torch.float32)
    gen = torch.Generator().manual_seed(7)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    plan = env.fused_plan(differentiable)
    inputs = (action, d.schedule, d.mroute_next, d.mroute_prev, rand,
              d.inj_routes, env.base_state.route_pool)
    return plan, inputs


def row(plan, inputs, e):
    """Episode e's inputs, as a launch of one episode takes them."""
    return tuple((x[e] if x.dim() == len(shape) + 1 else x).contiguous()
                 for x, (shape, _) in zip(inputs, k1._rows(plan)))


def fwd(lib, plan, inputs, batch=None):
    lead = (batch,) if batch else ()
    out = (torch.zeros(lead), torch.zeros((*lead, plan.T)),
           torch.zeros((*lead, plan.T, 8)))
    tensors, strides = k1.episode_rows(plan, inputs, batch)
    assert lib.launch_itscp_hybrid_episode_fwd(*k1.kernel_args(
        plan, tensors, out, 0, batch or 1, (*strides, 0))) == 0
    return out


def bwd(lib, plan, w, inputs, batch=None):
    lead = (batch,) if batch else ()
    grad = torch.zeros((*lead, plan.n_phases, plan.n_inter))
    tensors, strides = k1.episode_rows(plan, inputs, batch)
    assert lib.launch_itscp_hybrid_episode_bwd(*k1.kernel_args(
        plan, tensors, (w, grad), 0, batch or 1,
        (*strides, plan.T if batch else 0))) == 0
    return grad


@pytest.mark.parametrize("kind", ["scenarios", "draws"])
@pytest.mark.parametrize("mode", ["hard", "soft", "st"])
def test_batched_forward_equals_single_launches(lib, mode, kind):
    plan, inputs = batch_case(FWD_CFG[kind], kind, mode != "hard",
                              "st" if mode == "st" else "soft")
    assert k1.episode_count(inputs) == B
    strides = k1.episode_rows(plan, inputs, B)[1]
    if kind == "draws":  # scene data and action shared, stride 0
        assert strides == [0, 0, 0, 0, plan.T * plan.L, 0, 0]
    else:
        assert all(strides[:6]) and strides[6] == 0
    reward, queues, events = fwd(lib, plan, inputs, B)
    for e in range(B):
        r, q, ev = fwd(lib, plan, row(plan, inputs, e))
        assert torch.equal(reward[e], r), e
        assert torch.equal(queues[e], q), e
        assert torch.equal(events[e], ev), e
    # the episodes differ, and vehicles move between lanes
    assert len(set(reward.tolist())) == B
    assert not torch.equal(events[0], events[1])
    assert float(events[..., 1:4].sum()) > 0


@pytest.mark.parametrize("kind", ["scenarios", "draws"])
def test_batched_backward_equals_single_launches(lib, kind):
    plan, inputs = batch_case(BWD_CFG[kind], kind, True)
    assert plan.n_phases * plan.n_inter <= 18
    w = torch.as_tensor(np.random.default_rng(9).uniform(
        -1.0, 1.0, (B, plan.T)), dtype=torch.float32)
    grad = bwd(lib, plan, w, inputs, B)
    assert grad.shape == (B, plan.n_phases, plan.n_inter)
    for e in range(B):
        g = bwd(lib, plan, w[e].contiguous(), row(plan, inputs, e))
        assert torch.equal(grad[e], g), e
        assert torch.isfinite(g).all() and g.abs().max() > 0
    assert not torch.equal(grad[0], grad[1])


def test_launchers_refuse_an_empty_batch(lib):
    plan, inputs = batch_case(TWO_PHASE_CFG, "draws", True)
    tensors, strides = k1.episode_rows(plan, inputs, B)
    out = (torch.zeros(B), torch.zeros((B, plan.T)),
           torch.zeros((B, plan.T, 8)))
    assert lib.launch_itscp_hybrid_episode_fwd(*k1.kernel_args(
        plan, tensors, out, 0, 0, (*strides, 0))) != 0
