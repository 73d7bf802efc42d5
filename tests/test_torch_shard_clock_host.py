"""The lane-sharded step's cycle-stamped build (``-DDHTS_SHARD_CLOCK``,
read by ``dhts_torch.ops.cuda.shard_clock``), compiled for the host,
changes nothing.

The stamped and the plain build of ``csrc/itscp_spatial_shard.cu`` are
compiled with g++ against ``csrc/cpu_emulation.h`` (where ``clock64()``
counts host nanoseconds). A run of the hybrid scene of
``tests/test_torch_spatial_shard_host.py`` on S shards, B = 2, is stepped
to step 6 (hard, soft, and the derivative with its ``Dual`` blocks); from
that state one launch of C and one of E on shard 0 through each build
write the same bits into every buffer of the shard, and the stamped build
counts its launches and stamps the parts it ran (a fold where the step
folds a mean: E always, C in the soft modes and on one shard).
"""

import ctypes

import numpy as np
import pytest
import torch

from dhts_torch.apps.control.itscp import problem
from dhts_torch.apps.control.itscp.env import ItscpEnv
from dhts_torch.ops.cuda import _build, shard_clock
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6

torch.set_num_threads(1)

B, T = 2, 12
HYBRID_CFG = dict(num_intersection=3, num_lane=1, lane_length=5.0,
                  speed_limit=20.0, cell_length=5.0, policy_length=16,
                  signal_length=2, simulation_frequency=10, random_seed=3,
                  max_num_micro_vehicle_per_lane=4, mode="hybrid")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("shardclock")
    try:
        plain = _build.build_cpu_emulation("itscp_spatial_shard", out)
        clocked = _build.build_cpu_emulation("itscp_spatial_shard", out,
                                             defines=("DHTS_SHARD_CLOCK",))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return (ks.bind(ctypes.CDLL(str(plain))),
            shard_clock.bind_clock(ctypes.CDLL(str(clocked))))


def case(kind):
    env = ItscpEnv(config=HYBRID_CFG, schedule_fn=problem.problem_1,
                   device="cpu")
    env.reset()
    plans = tuple(k6.make_plan(env, soft)._replace(T=T)
                  for soft in (False, True))
    gen = torch.Generator().manual_seed(7)
    rand = torch.stack([env.draw_rand(gen)[:T] for _ in range(B)])
    action = torch.as_tensor(np.random.default_rng(5).uniform(
        0.3, 0.7, env.action_size()), dtype=torch.float32)
    d = env.data
    inputs = (action.reshape(plans[0].n_phases, -1).contiguous(),
              rand.contiguous(), d.schedule[:T].contiguous(),
              d.mroute_next[:T].contiguous(), d.mroute_prev[:T].contiguous(),
              k6.route_table(d.inj_routes, env.base_state.route_pool))
    return plans, inputs


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("kind", shard_clock.KINDS)
def test_stamped_launches_equal_unstamped(libs, kind, S):
    plain, clocked = libs
    plans, inputs = case(kind)
    q = shard_clock.Quiet(plans, kind, inputs, plain, S=S, warm=6)
    assert q.t >= 6
    for body in ("C", "E"):
        assert q.same_bits((clocked, plain), body), body
        rec = shard_clock.stamp(q, clocked, body, 2)
        parts = rec["cycles_per_launch"]
        assert rec["launches_stamped"] == 2
        # the fold runs beside thread 0's path (a reduction warp); the
        # parts on the path add up to at most the launch
        path = [v for k, v in parts.items()
                if k not in (f"{body}_total", f"{body}_fold")]
        assert 0 < sum(path) <= parts[f"{body}_total"]
        folds = body == "E" or kind != "hard" or S == 1
        assert (parts[f"{body}_fold"] > 0) == folds
        if body == "C":
            lanes = rec["C_lane_cycles_per_launch"]
            assert sum(v["lanes"] for v in lanes.values()) == q.shard.n
            assert all(v["max"] > 0 for v in lanes.values())
