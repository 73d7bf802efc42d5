"""Kernels K2 (fused ARZ macro rollout) and K3 (fused IDM micro rollout)
on the card against their plain PyTorch versions (skipped without a CUDA
device), at the inverse benchmarks' defaults: C = 10 cells of 5 m or V = 10
vehicles, dt 0.01, T = 500 steps, speed limit 30, at B = 1 and B = 12.

Tolerances as in ``chip_smoke.py``: the forward allclose(rtol 1e-6, atol
1e-6) (it repeats the plain version's float32 operations, so it is
expected to be exact); each backward gradient cosine > 0.9999 and
allclose(rtol 5e-3, atol 5e-4 * max|g|) for K2, atol 1e-5 * max|g| for K3,
against autograd of the plain version, finite. K2's gradient with respect
to the right ghost density is 0 on both sides: that density enters only
the right-vacuum test of the Riemann solver. This file imports nothing of
JAX:

    python -m pytest --noconftest -q tests/test_torch_card_rollout.py
"""

import numpy as np
import pytest
import torch

from dhts_torch.models.vehicle import default_params
from dhts_torch.ops import arz
from dhts_torch.ops.cuda import macro_rollout as k2
from dhts_torch.ops.cuda import micro_rollout as k3

torch.set_num_threads(1)

U_MAX, DT, DX, T = 30.0, 0.01, 5.0, 500
MACRO = k2.MacroConsts(U_MAX, DT, DX, T)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU path")
    return torch.device("cuda")


def macro_inputs(B, seed, dev, probe=False):
    rng = np.random.default_rng(seed)
    r0 = rng.uniform(0.0, 1.0, (B, 10))
    u0 = rng.uniform(0.0, U_MAX, (B, 10))
    ghosts = [rng.uniform(0, 1, B), rng.uniform(0, U_MAX, B),
              rng.uniform(0, 1, B), rng.uniform(0, U_MAX, B)]
    if probe:  # vacuum and jammed cells and ghosts
        r0[:, 2:4], u0[:, 2:4] = 0.0, 0.0
        r0[:, 6:8], u0[:, 6:8] = 1.0, 0.0
        ghosts[0][:], ghosts[3][:] = 0.0, 0.0
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    r0, u0 = t(r0), t(u0)
    y0 = arz.compute_y(r0, u0, U_MAX).contiguous()
    return (r0, y0, *map(t, ghosts))


def check_grads(got, ref, atol_scale):
    for name, a, b in zip(("r0", "y0", "bl_r", "bl_u", "br_r", "br_u"),
                          got, ref):
        a, b = a.double().flatten(), b.double().flatten()
        assert torch.isfinite(a).all(), name
        if float(b.norm()) == 0.0:
            assert float(a.abs().max()) == 0.0, name
            continue
        assert float(a @ b / (a.norm() * b.norm())) > 0.9999, name
        assert torch.allclose(a, b, rtol=5e-3,
                              atol=atol_scale * float(b.abs().max())), name


@pytest.mark.parametrize("probe", [False, True], ids=["random", "vac_jam"])
@pytest.mark.parametrize("B", [1, 12])
def test_k2_matches_plain_version(cuda, B, probe):
    inputs = macro_inputs(B, 3 + B, cuda, probe)
    n = k2.macro_rollout_fwd.launches, k2.macro_rollout_bwd.launches
    out = k2.macro_rollout_fwd(MACRO, *inputs)
    ref = k2.plain_macro_rollout(MACRO, *inputs)
    for a, b in zip(out, ref):
        assert torch.isfinite(a).all()
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(B)
    cot = [torch.as_tensor(rng.normal(size=(B, 10)), dtype=torch.float32,
                           device=cuda) for _ in range(2)]
    got = k2.macro_rollout_bwd(MACRO, *inputs, *cot)
    want = k2.plain_macro_rollout_bwd(MACRO, *inputs, *cot)
    torch.cuda.synchronize()
    assert (k2.macro_rollout_fwd.launches,
            k2.macro_rollout_bwd.launches) == (n[0] + 1, n[1] + 1)
    assert float(want[4].abs().max()) == 0.0  # d/d br_r
    check_grads(got, want, 5e-4)


def test_k2_segmented_equals_one_call(cuda):
    inputs = macro_inputs(12, 5, cuda)
    one = k2.make_fused_macro_rollout(U_MAX, DT, DX, T, 10, 12, cuda)
    seg = k2.make_segmented_macro_rollout(U_MAX, DT, DX, T, 10, 12, 128,
                                          cuda)
    for a, b in zip(one(*inputs), seg(*inputs)):
        assert torch.equal(a, b)


def micro_inputs(B, seed, dev, touching=False):
    rng = np.random.default_rng(seed)
    gap = rng.uniform(1.2, 4.0, (B, 10)) * 5.0
    if touching:  # overlapping and touching neighbours, slow: floor and
        gap[:, 3:6] = rng.uniform(4.0, 5.5, (B, 3))  # collisions
    pos0 = np.cumsum(gap, axis=1)
    vel0 = rng.uniform(0.0, 3.0 if touching else 25.0, (B, 10))
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return t(pos0), t(vel0)


@pytest.mark.parametrize("touching", [False, True], ids=["spaced", "touch"])
@pytest.mark.parametrize("B", [1, 12])
def test_k3_matches_plain_version(cuda, B, touching):
    consts = k3.micro_consts(default_params(U_MAX, (10,)), 1000.0, 0.0, DT,
                             T, cuda)
    pos0, vel0 = micro_inputs(B, 7 + B, cuda, touching)
    n = k3.micro_rollout_fwd.launches, k3.micro_rollout_bwd.launches
    out = k3.micro_rollout_fwd(consts, pos0, vel0)
    ref = k3.plain_micro_rollout(consts, pos0, vel0)
    for a, b in zip(out, ref):
        assert torch.isfinite(a).all()
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)
    if touching:
        hits = k3.floor_hits(consts, pos0, vel0)
        print(f"floor hits (B={B}): {hits.tolist()}")
        assert int(hits.sum()) > 0
    rng = np.random.default_rng(B)
    cot = [torch.as_tensor(rng.normal(size=(B, 10)), dtype=torch.float32,
                           device=cuda) for _ in range(2)]
    got = k3.micro_rollout_bwd(consts, pos0, vel0, *cot)
    want = k3.plain_micro_rollout_bwd(consts, pos0, vel0, *cot)
    torch.cuda.synchronize()
    assert (k3.micro_rollout_fwd.launches,
            k3.micro_rollout_bwd.launches) == (n[0] + 1, n[1] + 1)
    for a, b in zip(got, want):
        a, b = a.double().flatten(), b.double().flatten()
        assert torch.isfinite(a).all() and float(a.norm()) > 0
        assert float(a @ b / (a.norm() * b.norm())) > 0.9999
        assert torch.allclose(a, b, rtol=5e-3,
                              atol=1e-5 * float(b.abs().max()))
