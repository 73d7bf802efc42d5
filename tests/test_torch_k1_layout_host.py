"""K1's thread layout, compiled for the host, against the plain version.

The kernel runs its lanes with one lane kind per warp: the wrapper's
``lane_layout`` puts the macro lanes first and the micro lanes after them,
each group padded to whole warps, and the kernel maps its threads to lanes
through it; a reduction warp beside the lane warps takes each step's
records in lane order. Every shared array and every sum keeps
indexing by lane id, so the outputs must not depend on where the lanes
sit. The host build of ``csrc/itscp_hybrid_episode.cu`` (g++ against
``csrc/cpu_emulation.h``, the card's C launchers) is held against
``plain_episode`` (events exact, reward rel 1e-5, queues abs 1e-5) in hard,
soft and ``st`` mode and against ``plain_episode_bwd`` (cosine > 0.999,
``allclose(rtol=2e-2, atol=2e-3 * max|g|)``; soft, and ``st`` on the first
two) on four scenes of T <= 60:

* ``interleaved``: the 3x3 hybrid scene (144 lanes, 16 micro) with its
  lanes relabelled by a seeded permutation, so that micro lanes sit
  between macro lanes and no warp of lane ids is of one kind;
* ``warp_border``: the 3x3 scene with two lanes an arm at 20 m/s (252
  lanes; its 28 micro lanes, ids 112-139, cross the border 128 of two
  warps of lane ids, and run as one warp with 4 threads of padding);
* ``tail``: the 3x3 scene relabelled so that its micro lanes end the lane
  ids (L = 144, not a multiple of 32, the last lane warp part padding);
* ``cells``: the 3x3 scene on 20 m lanes of 5 m cells (macro lanes of up
  to C = 4 cells, as the 3x3 preset's), relabelled as ``interleaved``;
  T = 56.

The first three emit, absorb and transfer vehicles within their 60 steps
(``cells`` converts none so early).
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

# 4 Hz, 30 m/s, 10 m lanes: conversions within T = 60 steps, one signal
# phase (9 action entries: 9 backward blocks)
CFG = dict(num_intersection=3, num_lane=1, lane_length=10.0,
           speed_limit=30.0, cell_length=10.0, policy_length=15,
           signal_length=15, simulation_frequency=4, random_seed=3,
           max_num_micro_vehicle_per_lane=4, mode="hybrid")
SCENES = {"interleaved": CFG,
          "warp_border": dict(CFG, num_lane=2, speed_limit=20.0),
          "tail": CFG,
          "cells": dict(CFG, lane_length=20.0, cell_length=5.0,
                        simulation_frequency=8, policy_length=7,
                        signal_length=7)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation(
            "itscp_hybrid_episode", tmp_path_factory.mktemp("k1layout"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return k1.bind(ctypes.CDLL(str(path)))


def relabel(spec, meta, inputs, perm):
    """The scene with lane i' = perm[i']: every lane-indexed axis taken at
    perm, every lane id v in a value renamed to its new index."""
    L = len(perm)
    perm = torch.as_tensor(perm, dtype=torch.long)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(L)

    def ids(x):
        return torch.where(x >= 0, inv[x.clamp(min=0).long()].to(x.dtype),
                           x)

    spec = spec._replace(
        is_macro=spec.is_macro[perm], length=spec.length[perm],
        num_cell=spec.num_cell[perm], cell_length=spec.cell_length[perm],
        cell_mask=spec.cell_mask[perm], next_lanes=ids(spec.next_lanes[perm]),
        prev_lanes=ids(spec.prev_lanes[perm]), num_next=spec.num_next[perm],
        num_prev=spec.num_prev[perm])
    meta = type(meta)(*(x[perm] for x in meta))
    action, sched, mnext, mprev, rand, inj, pool = inputs
    inputs = (action, sched[:, perm].contiguous(),
              ids(mnext[:, perm]).contiguous(),
              ids(mprev[:, perm]).contiguous(), rand[:, perm].contiguous(),
              ids(inj[perm]).contiguous(), ids(pool[perm]).contiguous())
    return spec, meta, inputs


@functools.lru_cache(maxsize=None)
def make_scene(name):
    env = ItscpEnv(config=dict(SCENES[name], use_fused_episode=True),
                   schedule_fn=problem.problem_1, device="cpu")
    env.reset()
    rand = env.draw_rand(torch.Generator().manual_seed(7))
    action = torch.as_tensor(
        np.random.default_rng(12).uniform(0.3, 0.7, env.action_size()),
        dtype=torch.float32).reshape(env.n_phases, -1)
    inputs = (action, env.data.schedule, env.data.mroute_next,
              env.data.mroute_prev, rand, env.data.inj_routes,
              env.base_state.route_pool)
    spec, meta = env.spec, env.meta
    L = spec.num_lanes
    micro = np.flatnonzero(~spec.is_macro.numpy())
    if name in ("interleaved", "cells"):
        perm = np.random.default_rng(0).permutation(L)
    elif name == "tail":
        perm = np.concatenate([np.flatnonzero(spec.is_macro.numpy()), micro])
    else:
        perm = np.arange(L)
    spec, meta, inputs = relabel(spec, meta, inputs, perm)
    plan = env.fused_plan(False)
    sizes = (plan.V, plan.R, plan.P, plan.P2)

    def make(mode):
        config = dict(env.config, gate_mode=mode)
        return k1.make_plan(spec, meta, config, *sizes, window=plan.W,
                            differentiable=mode != "hard")

    return name, make, inputs


@pytest.mark.parametrize("name", list(SCENES))
def test_scenes_have_the_layouts_they_name(name):
    name, make, _ = make_scene(name)
    plan = make("hard")
    is_macro = plan.spec.is_macro.numpy()
    perm = plan.lane_perm.numpy()
    lanes = perm[perm >= 0]
    assert sorted(lanes.tolist()) == list(range(plan.L))
    kinds = [set(is_macro[w[w >= 0]].tolist())
             for w in perm.reshape(-1, 32)]
    assert all(len(k) == 1 for k in kinds)  # one lane kind per warp
    micro = np.flatnonzero(~is_macro)
    by_id = [set(is_macro[i:i + 32].tolist()) for i in range(0, plan.L, 32)]
    if name in ("interleaved", "cells"):
        assert all(len(k) == 2 for k in by_id)
    elif name == "warp_border":
        assert micro[0] < 128 <= micro[-1] and kinds.count({False}) == 1
    else:
        assert plan.L % 32 and micro[-1] == plan.L - 1
    assert plan.L % 32 != 0
    if name == "cells":
        assert int(plan.spec.num_cell.max()) == plan.C == 4


@pytest.mark.parametrize("mode", ["hard", "soft", "st"])
@pytest.mark.parametrize("name", list(SCENES))
def test_forward_matches_plain_version(lib, name, mode):
    name, make, inputs = make_scene(name)
    plan = make(mode)
    pr, pq, pe = k1.plain_episode(plan, *inputs)
    out = (torch.zeros(()), torch.zeros(plan.T), torch.zeros(plan.T, 8))
    assert lib.launch_itscp_hybrid_episode_fwd(
        *k1.kernel_args(plan, inputs, out, 0)) == 0
    kr, kq, ke = out
    assert torch.equal(ke, pe), (ke - pe).abs().amax(0)
    assert float(kr) == pytest.approx(float(pr), rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(kq.numpy(), pq.detach().numpy(), rtol=0,
                               atol=1e-5)
    if name != "cells":
        tot = pe[:, :7].sum(0)
        assert tot[1] >= 1 and tot[2] >= 1 and tot[4] >= 1, tot


# the straight-through backward on the two scenes of other lane layouts
@pytest.mark.parametrize("name,mode", [
    *((name, "soft") for name in SCENES), ("interleaved", "st"),
    ("warp_border", "st")])
def test_backward_matches_autograd(lib, name, mode):
    name, make, inputs = make_scene(name)
    plan = make(mode)
    w = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, plan.T),
                        dtype=torch.float32)
    ref = k1.plain_episode_bwd(plan, w, *inputs).numpy().ravel()
    grad = torch.zeros(plan.n_phases, plan.n_inter)
    assert lib.launch_itscp_hybrid_episode_bwd(
        *k1.kernel_args(plan, inputs, (w, grad), 0)) == 0
    got = grad.numpy().ravel()
    assert np.all(np.isfinite(got)) and np.linalg.norm(got) > 0
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos > 0.999, (cos, got, ref)
    np.testing.assert_allclose(got, ref, rtol=2e-2,
                               atol=2e-3 * np.abs(ref).max())
