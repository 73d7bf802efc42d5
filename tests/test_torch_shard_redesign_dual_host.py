"""The lane-sharded step's derivative (``Dual`` C and E: a reduction warp
beside the lanes, C's lanes over SPLIT threads each), compiled for the
host, against the plain bodies under forward-mode AD and the STEP
derivative kernel.

The scenes and builds of ``tests/test_torch_shard_redesign_host.py``. A
derivative's C and E launches equal their plain bodies under forward-mode
AD on the same dual inputs (``ShardRun.checked_dual_step``: values bit for
bit, tangents within rtol 1e-5, atol 1e-5 times the output's largest
tangent, as the two round their tangent formulas differently), at S = 2,
3, 4 and on uneven shards, with C's lanes split and one thread each; the gradient of the first 64 steps equals the
STEP derivative kernel's bit for bit. On the micro scene whose lanes hold
more vehicles than C has threads a lane, every 50th step's launches.
"""

import numpy as np
import pytest
import torch

from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from tests.test_torch_shard_redesign_host import (B, case, comm_of, ks_split,
                                                  libs, most_vehicles,
                                                  variant)

torch.set_num_threads(1)
STEPS = 64


@pytest.mark.parametrize("how", ["split", "one_thread"])
@pytest.mark.parametrize("shards", [2, 3, 4, ((0, 50), (50, 94))],
                         ids=["S2", "S3", "S4", "uneven"])
def test_derivative_matches_plain_and_step_kernel(libs, shards, how):
    lib, step_lib = variant(libs, how), libs[1]
    plan, inputs = case("two_phase", True, steps=STEPS)
    wq = torch.as_tensor(np.random.default_rng(0).uniform(
        -1, 1, (B, plan.T)), dtype=torch.float32)
    run = ks.ShardRun(plan, comm_of(plan.L, shards), inputs, dual=True,
                      lib=lib)
    for t in range(plan.T):
        if t in (5, 21, 37):
            run.checked_dual_step(t)
        else:
            run.step(t)
    got = run.gradient(wq)
    fb, db, ib = k6.dual_state(plan, B, "cpu")
    g64 = torch.zeros(fb.shape[0], dtype=torch.float64)
    assert step_lib.launch_itscp_spatial_step_bwd(*k6.kernel_args(
        plan, (fb, db, ib), inputs, (wq, g64, None), B, 0, plan.T, 0)) == 0
    step = g64.view(B, -1).sum(0).to(torch.float32).view(plan.n_phases, -1)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, step)


def test_long_micro_derivative_launches(libs):
    lib = variant(libs, "split")
    plan, inputs = case("long_micro", True)
    run = ks.ShardRun(plan, comm_of(plan.L, 4), inputs, dual=True, lib=lib)
    most = 0
    for t in range(plan.T):
        if t % 50 == 49:
            run.checked_dual_step(t)
        else:
            run.step(t)
        most = max(most, most_vehicles(run))
    assert most > ks_split()
