"""The lane-sharded step's Q kernel on the card (skipped without a CUDA
device): the episode's queues summed from gathered ``q^2`` rows at the 3x3
hybrid preset of ``run_itscp_hybrid.sh`` (T = 600 steps, 144 lanes, 45
actions), B = 1 and 4 episodes, forward and derivative, on rows of mixed
magnitudes, against ``plain_queues`` and ``plain_gradient`` on the same
rows: bit-equal (both add each step's lanes in lane order and the
derivative's weighted terms in step order, in float64), and again after 3
launches back to back (the derivative's per-row count of finished tiles
returns to 0). This file imports nothing of JAX::

    python -m pytest --noconftest -q tests/test_torch_card_shard.py
"""

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6

torch.set_num_threads(1)

PRESET = dict(num_intersection=3, num_lane=1, lane_length=5, speed_limit=60,
              policy_length=20, signal_length=4, simulation_frequency=30,
              mode="hybrid", random_seed=3)


@pytest.fixture(scope="module")
def env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU path")
    e = ItscpEnv(config=PRESET, schedule_fn=problem.problem_1,
                 device=torch.device("cuda"))
    e.reset()
    return e


@pytest.mark.parametrize("dual", [False, True], ids=["forward", "derivative"])
@pytest.mark.parametrize("B", [1, 4])
def test_queue_kernel_matches_plain_sums(env, B, dual):
    plan = k6.make_plan(env, True)
    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(B)
    rand = torch.stack([env.draw_rand(gen) for _ in range(B)])
    d = env.data
    inputs = (torch.full((plan.n_phases, plan.n_inter), 0.55, device=dev),
              rand, d.schedule, d.mroute_next, d.mroute_prev,
              k6.route_table(d.inj_routes, env.base_state.route_pool))
    run = ks.ShardRun(plan, ks.LaneComm(plan.L, ks.shards_of(plan.L, 4)),
                      inputs, dual=dual)
    rng = np.random.default_rng(5 + B)
    shape = (run.N, plan.T, plan.L)
    rows = torch.as_tensor(rng.standard_normal(shape) *
                           10.0 ** rng.integers(-6, 4, shape),
                           dtype=torch.float32, device=dev)
    wq = torch.as_tensor(rng.uniform(-1, 1, (B, plan.T)),
                         dtype=torch.float32, device=dev)
    run.g = {"gq": rows, "q_weight": wq}
    want_q = ks.plain_queues(plan, rows)
    want_g = ks.plain_gradient(plan, rows, wq) if dual else None
    for repeat in (1, 3):
        run.queues.fill_(float("nan"))
        run.launch("Q", 0, [0], repeat=repeat)
        torch.cuda.synchronize()
        assert torch.equal(run.queues, want_q)
        if dual:
            got = run.grad.view(B, -1).sum(0).to(torch.float32).view(
                plan.n_phases, plan.n_inter)
            assert torch.equal(got, want_g)
            assert int(run.q_count.abs().sum()) == 0
