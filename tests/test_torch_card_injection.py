"""Boundary injection through kernel K1 on the card, in the soft and
straight-through modes and in the backward (skipped without a CUDA device).

The 3x3 preset has no injection, so on the card ``tests/test_torch_card.py``
runs it only in hard mode. Here two scenes that inject run K1's soft and
``st`` forward and its backward against the plain version:

* the all-micro scene (``MICRO_CFG`` of ``tests/test_torch_card.py``):
  vehicles are injected at the source lanes (event row 0);
* its all-macro twin: the source lanes' ghost cells carry the schedule's
  inflow density into the network.

Tolerances as in ``tests/test_torch_card.py``: events[T, 8] exact, reward
rel 1e-4, queues abs 1e-4; the gradient cosine > 0.999 and
allclose(rtol 2e-2, atol 2e-3 * max|g|) against autograd of the plain
version. Every test asserts that injection happened in the episode it
checks. This file imports nothing of JAX:

    python -m pytest --noconftest -q tests/test_torch_card_injection.py
"""

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_hybrid_episode as k1

torch.set_num_threads(1)

MICRO_CFG = dict(num_intersection=2, num_lane=2, lane_length=20.0,
                 speed_limit=30.0, policy_length=8, signal_length=2,
                 simulation_frequency=10, random_seed=5, mode="micro",
                 use_fused_episode=True)
MACRO_CFG = dict(MICRO_CFG, mode="macro")
SCENES = [MICRO_CFG, MACRO_CFG]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU path")
    return torch.device("cuda")


def scene(cfg, gate_mode, dev):
    env = ItscpEnv(config=dict(cfg, gate_mode=gate_mode),
                   schedule_fn=problem.random_schedule, device=dev)
    env.reset()
    plan = env.fused_plan(True)
    rand = env.draw_rand(torch.Generator(device=dev).manual_seed(3))
    action = np.random.default_rng(1).uniform(0.3, 0.7, env.action_size())
    action = torch.as_tensor(action, dtype=torch.float32, device=dev)
    inputs = (action.reshape(env.n_phases, -1).contiguous(),
              env.data.schedule, env.data.mroute_next, env.data.mroute_prev,
              rand, env.data.inj_routes, env.base_state.route_pool)
    return env, plan, inputs


def injected(env, events):
    """Vehicles injected (micro) or the inflow density the source lanes'
    ghost cells carried, summed over the episode (macro)."""
    if env.config["mode"] == "micro":
        return float(events[:, 0].sum())
    source = ~env.meta.has_prev & env.spec.is_macro
    return float(env.data.schedule[:, source].clamp(min=0).sum())


@pytest.mark.parametrize("gate_mode", ["soft", "st"])
@pytest.mark.parametrize("cfg", SCENES, ids=["micro", "macro"])
def test_soft_forward_with_injection_matches_plain_version(cuda, cfg,
                                                           gate_mode):
    env, plan, inputs = scene(cfg, gate_mode, cuda)
    before = k1.itscp_hybrid_episode_fwd.launches[plan.mode]
    kr, kq, ke = k1.itscp_hybrid_episode_fwd(plan, *inputs)
    with torch.no_grad():
        pr, pq, pe = k1.plain_episode(plan, *inputs)
    torch.cuda.synchronize()
    assert k1.itscp_hybrid_episode_fwd.launches[plan.mode] == before + 1
    assert injected(env, pe) > 0
    assert torch.equal(ke, pe)
    assert float(kr) == pytest.approx(float(pr), rel=1e-4)
    assert float((kq - pq).abs().max()) <= 1e-4
    assert float(pq.abs().max()) > 0  # the injected traffic queued


@pytest.mark.parametrize("gate_mode", ["soft", "st"])
@pytest.mark.parametrize("cfg", SCENES, ids=["micro", "macro"])
def test_backward_with_injection_matches_autograd(cuda, cfg, gate_mode):
    """Where the plain gradient is 0 (``st`` in the all-micro scene: every
    straight-through path is clipped there), the kernel's must be 0 too."""
    env, plan, inputs = scene(cfg, gate_mode, cuda)
    w = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, plan.T),
                        dtype=torch.float32, device=cuda)
    with torch.no_grad():
        _, _, pe = k1.plain_episode(plan, *inputs)
    assert injected(env, pe) > 0
    got = k1.itscp_hybrid_episode_bwd(plan, w, *inputs).double().flatten()
    ref = k1.plain_episode_bwd(plan, w, *inputs).double().flatten()
    assert torch.isfinite(got).all()
    assert torch.allclose(got, ref, rtol=2e-2,
                          atol=2e-3 * float(ref.abs().max()))
    if float(ref.norm()) > 0:
        assert float(got @ ref / (got.norm() * ref.norm())) > 0.999
