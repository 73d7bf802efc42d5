"""Kernel K3 (the fused IDM micro rollout) on the card against its plain
PyTorch version, at the micro inverse benchmark's defaults (dt 0.01, T =
500 steps, speed limit 30, head deltas 1000 and 0), skipped without a
CUDA device: V = 1, 10 and 32 take the warp kernels (a platoon in one
warp's registers forward, a reverse sweep backward), V = 40 PR 6's
shared-memory forward and forward-mode backward; B = 1, 12 and 128, the
second half of each batch dense (the acceleration floor binds, vehicles
collide).

* The forward equals the plain version bit for bit (the same float32
  operations in the same order), and so does the trajectory it saves.
* The backward, through the wrapper with the saved trajectory, through the
  wrapper replaying its own, and through autograd of
  ``make_fused_micro_rollout``, against autograd of the plain version:
  cosine > 0.9999, allclose(rtol 5e-3, atol 1e-5 * max|g|), finite,
  nonzero; each wrapper call one launch.
* The warp kernels' checked division never accepts a quotient that is not
  the card's IEEE quotient (``torch`` division), over 2^24 random pairs
  of every exponent and every pair of special values, and accepts almost
  every pair the benchmark meets.

This file imports nothing of JAX::

    python -m pytest --noconftest -q tests/test_torch_card_k3.py
"""

import numpy as np
import pytest
import torch

from dhts_torch.models.vehicle import default_params
from dhts_torch.ops.cuda import micro_rollout as k3

torch.set_num_threads(1)

U_MAX, DT, T = 30.0, 0.01, 500


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU path")
    return torch.device("cuda")


def platoons(B, V, seed, dev):
    """Spaced platoons (about four lengths apart, 0.3-0.7 of the speed
    limit), the second half of the batch dense (gaps of -1 to 0.6 m,
    under 3 m/s)."""
    rng = np.random.default_rng(seed)
    gap = 20.0 + rng.uniform(0, 10.0, (B, V))
    vel = (0.3 + 0.4 * rng.uniform(0, 1, (B, V))) * U_MAX
    dense = slice(B // 2, B)
    gap[dense] = rng.uniform(4.0, 5.6, gap[dense].shape)
    vel[dense] = rng.uniform(0.0, 3.0, vel[dense].shape)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return t(np.cumsum(gap, axis=1)), t(vel)


def check_grads(got, want):
    for a, b in zip(got, want):
        a, b = a.double().flatten(), b.double().flatten()
        assert torch.isfinite(a).all() and float(a.norm()) > 0
        assert float(a @ b / (a.norm() * b.norm())) > 0.9999
        assert torch.allclose(a, b, rtol=5e-3,
                              atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("B", [1, 12, 128])
@pytest.mark.parametrize("V", [1, 10, 32, 40])
def test_k3_matches_plain_version(cuda, V, B):
    consts = k3.micro_consts(default_params(U_MAX, (V,)), 1000.0, 0.0, DT,
                             T, cuda)
    ins = platoons(B, V, 100 + V + B, cuda)
    if B > 1 and V > 1:  # a lone vehicle follows the distant virtual leader
        assert int(k3.floor_hits(consts, *ins).sum()) > 0
    n_fwd, n_bwd = k3.micro_rollout_fwd.launches, k3.micro_rollout_bwd.launches
    posT, velT, traj = k3.micro_rollout_fwd(consts, *ins, trajectory=True)
    ref = k3.plain_micro_rollout(consts, *ins)
    torch.cuda.synchronize()
    assert torch.equal(posT, ref[0]) and torch.equal(velT, ref[1])
    for a, b in zip(k3.micro_rollout_fwd(consts, *ins), ref):
        assert torch.equal(a, b)
    if V <= k3.WARP_VEHICLES:
        assert torch.equal(traj, k3.plain_micro_trajectory(consts, *ins))
    else:
        assert traj is None
    rng = np.random.default_rng(B)
    cot = [torch.as_tensor(rng.normal(size=(B, V)), dtype=torch.float32,
                           device=cuda) for _ in range(2)]
    want = k3.plain_micro_rollout_bwd(consts, *ins, *cot)
    check_grads(k3.micro_rollout_bwd(consts, *ins, *cot), want)
    n = 2
    if traj is not None:
        check_grads(k3.micro_rollout_bwd(consts, *ins, *cot, traj=traj),
                    want)
        n = 3
    torch.cuda.synchronize()
    assert (k3.micro_rollout_fwd.launches,
            k3.micro_rollout_bwd.launches) == (n_fwd + 2, n_bwd + n - 1)
    # autograd of the factory's function: its forward saves the
    # trajectory (V <= 32) and its backward sweeps it, one launch each
    fn = k3.make_fused_micro_rollout(DT, T, V, B,
                                     default_params(U_MAX, (V,)), 1000.0,
                                     0.0, device=cuda)
    x = [t.clone().requires_grad_(True) for t in ins]
    n_fwd, n_bwd = k3.micro_rollout_fwd.launches, k3.micro_rollout_bwd.launches
    pT, vT = fn(*x)
    torch.autograd.backward((pT, vT), cot)
    assert (k3.micro_rollout_fwd.launches,
            k3.micro_rollout_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    check_grads([t.grad for t in x], want)


def test_k3_warp_limits(cuda):
    """The warp kernels take at most 32 vehicles; a trajectory is read
    only there."""
    consts = k3.micro_consts(default_params(U_MAX, (40,)), 1000.0, 0.0, DT,
                             5, cuda)
    ins = platoons(2, 40, 1, cuda)
    lib = k3._library()
    out = (torch.empty((2, 40), device=cuda),
           torch.empty((2, 40), device=cuda))
    traj = torch.empty((2, 5, 2, 40), device=cuda)
    assert lib.launch_micro_rollout_fwd_save(*k3.kernel_args(
        consts, (*ins, *out, traj), 2, 40, 0)) == 1
    cot = [torch.ones((2, 40), device=cuda)] * 2
    with pytest.raises(ValueError, match="no trajectory"):
        k3.micro_rollout_bwd(consts, *ins, *cot, traj=traj)


def test_k3_checked_division_is_ieee(cuda):
    rng = np.random.default_rng(0)
    n = 1 << 24

    def draw():
        m = rng.uniform(1, 2, n) * rng.choice([-1, 1], n)
        return (m * np.exp2(rng.integers(-149, 128, n))).astype(np.float32)

    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.17549435e-38,
                        1.0, 2.0, 0.5, 3.0, 30.0, 0.01, 1e-5, 1e-30, 1e30,
                        3.4028235e38, np.inf, -np.inf, np.nan], np.float32)
    sa, sb = (x.ravel() for x in np.meshgrid(special, special))
    # the benchmark's dividends over its divisors: speeds, spacings, gaps
    bench = rng.uniform(0, 40, n).astype(np.float32)
    gaps = rng.uniform(1e-5, 1000, n).astype(np.float32)
    a = np.concatenate([draw(), sa, bench, bench])
    b = np.concatenate([draw(), sb, gaps, np.full(n, 30.0, np.float32)])
    ta, tb = (torch.as_tensor(x, device=cuda) for x in (a, b))
    want = (ta / tb).view(torch.int32)
    lib = k3._library()
    for rounded in (False, True):
        q, ok = k3.div_check(lib, ta, tb, rounded)
        torch.cuda.synchronize()
        assert not bool((ok & (q.view(torch.int32) != want)).any())
        tail = ok[-2 * n:]
        assert float(tail.float().mean()) > 0.99
