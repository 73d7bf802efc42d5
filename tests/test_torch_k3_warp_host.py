"""K3's warp kernels (``csrc/micro_rollout.cu``, a platoon of up to 32
vehicles in one warp: the forward in registers, the backward a reverse
sweep over a saved or replayed trajectory), compiled for the host with g++
against ``csrc/cpu_emulation.h``, against the plain PyTorch version and
JAX's K3.

* The warp forward (V = 1, 10, 31, 32) and PR 6's shared-memory forward
  (V = 33, 40; also at V = 10 through its own launcher) equal the plain
  version bit for bit, on spaced platoons at the benchmark's head deltas,
  on dense ones behind a virtual leader they overlap (the acceleration
  floor binds and vehicles collide, the head too) and on spaced ones with
  tiny and denormal speeds (whose quotients fail the checked division, so
  the kernels take their IEEE fallback), at T = 0, 1 and 60; the saved
  trajectory equals the plain one.
* The reverse sweep, over the saved trajectory and replaying its own,
  matches autograd of the plain version at T = 1, 7 (steps alone, then a
  round of four) and 60: cosine > 0.9999, allclose(rtol 5e-3, atol 1e-5 *
  max|g|), finite, nonzero; at T = 0 it returns the cotangents exactly.
* Off the floor it matches ``dhts.ops.pallas.make_fused_micro_rollout``
  (interpret mode) at ``tests/test_torch_micro_rollout.py``'s tolerance.
* The checked division accepts no quotient but the IEEE one (here with a
  reciprocal one ulp off, so its correction and check do work).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.models.vehicle import default_params as jdefault_params
from dhts.ops.pallas import micro_rollout as jk3
from dhts_torch.models.vehicle import default_params
from dhts_torch.ops import idm
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import micro_rollout as k3

torch.set_num_threads(1)

U_MAX, DT = 30.0, 0.01
# the benchmark's head deltas; dense platoons follow a virtual leader
# they overlap
HEAD = {"spaced": (1000.0, 0.0), "dense": (-0.2, 1.0), "tiny": (1000.0, 0.0)}
KINDS = tuple(HEAD)
TINY = (1e-40, -2e-39, 1e-33, 0.0, 3e-38)  # speeds of the "tiny" platoons
B = 3


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation("micro_rollout",
                                          tmp_path_factory.mktemp("k3w"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return k3.bind(ctypes.CDLL(str(path)))


def case(seed, V, kind):
    """``case(..., dense=True)`` of ``tests/test_torch_micro_rollout.py``
    for "dense": slow vehicles a few decimetres apart or overlapping; its
    spaced platoons, for "tiny" with the first vehicles' speeds from
    TINY."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        gap, vel = rng.uniform(4.0, 5.6, (B, V)), rng.uniform(0, 3, (B, V))
    else:
        gap, vel = rng.uniform(8.0, 20.0, (B, V)), rng.uniform(2, 20, (B, V))
    vel = vel.astype(np.float32)
    if kind == "tiny":
        vel[:, :len(TINY)] = np.array(TINY, np.float32)[:V]
    return (torch.as_tensor(np.cumsum(gap, axis=1), dtype=torch.float32),
            torch.as_tensor(vel))


def consts_for(V, T, kind):
    return k3.micro_consts(default_params(U_MAX, (V,)), *HEAD[kind], DT, T,
                           "cpu")


def floor_hits_and_collisions(consts, ins):
    p = consts.vehicle_params()
    pos, vel = ins
    hits = int(k3.floor_hits(consts, *ins).sum())
    coll = 0
    for _ in range(consts.num_steps):
        res = idm.micro_lane_step(
            pos, vel, p.accel_max, p.accel_pref, p.target_speed, p.min_space,
            p.time_pref, p.length, consts.head_position_delta,
            consts.head_speed_delta, torch.ones(pos.shape[-1:], dtype=bool),
            consts.delta_time)
        coll += int(res.collided.sum())
        pos, vel = res.position, res.speed
    return hits, coll


@pytest.mark.parametrize("T", [0, 1, 60])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("V", [1, 10, 31, 32, 33, 40])
def test_forward_is_bit_equal_to_plain_version(lib, V, kind, T):
    consts = consts_for(V, T, kind)
    ins = case(V + T, V, kind)
    if T == 60:
        hits, coll = floor_hits_and_collisions(consts, ins)
        assert (hits > 0 and coll > 0) == (kind == "dense"), (hits, coll)
    if kind == "tiny":  # the first step's sp / tgt fails the check
        tgt = consts.params[2].expand(B, V).contiguous()
        assert not bool(k3.div_check(lib, ins[1], tgt, True)[1].all())
    ref = k3.plain_micro_rollout(consts, *ins)
    launchers = {"launch_micro_rollout_fwd": ()}
    if V <= k3.WARP_VEHICLES:
        launchers["launch_micro_rollout_fwd_save"] = (torch.full(
            (B, T, 2, V), float("nan")),)
    for name, extra in launchers.items():
        out = (torch.full((B, V), float("nan")),
               torch.full((B, V), float("nan")))
        k3.launch_checked(lib, name, consts, (*ins, *out, *extra), B, V, 0)
        for a, b in zip(out, ref):
            assert torch.equal(a, b), name
        if extra:
            assert torch.equal(extra[0],
                               k3.plain_micro_trajectory(consts, *ins))


def test_shared_memory_forward_below_one_warp(lib):
    """PR 6's kernel, which the launchers take above 32 vehicles, through
    its own launcher at the benchmark's V = 10."""
    for kind in KINDS:
        consts = consts_for(10, 60, kind)
        ins = case(5, 10, kind)
        out = (torch.empty(B, 10), torch.empty(B, 10))
        k3.launch_checked(lib, "launch_micro_rollout_fwd_smem", consts,
                          (*ins, *out), B, 10, 0)
        for a, b in zip(out, k3.plain_micro_rollout(consts, *ins)):
            assert torch.equal(a, b)


def cotangents(V, seed=9):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=(B, V)), dtype=torch.float32)
            for _ in range(2)]


def reverse(lib, consts, ins, cot, saved: bool):
    """The reverse sweep's gradient ``[B, 2V]`` over the saved trajectory
    or replaying its own."""
    V, T = ins[0].shape[1], consts.num_steps
    traj = torch.full((B, T, 2, V), float("nan"))
    if saved:
        out = (torch.empty(B, V), torch.empty(B, V))
        k3.launch_checked(lib, "launch_micro_rollout_fwd_save", consts,
                          (*ins, *out, traj), B, V, 0)
    g = torch.full((B, 2 * V), float("nan"))
    name = "saved" if saved else "replay"
    k3.launch_checked(lib, f"launch_micro_rollout_bwd_{name}", consts,
                      (*ins, *cot, g, traj), B, V, 0)
    return g


def assert_close(g, ref):
    a, b = g.double().flatten(), ref.double().flatten()
    assert torch.isfinite(a).all() and float(a.norm()) > 0
    assert float(a @ b / (a.norm() * b.norm())) > 0.9999
    assert torch.allclose(a, b, rtol=5e-3, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("T", [0, 1, 7, 60])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("V", [1, 10, 31, 32])
@pytest.mark.parametrize("saved", [True, False], ids=["saved", "replay"])
def test_reverse_sweep_matches_autograd(lib, saved, V, kind, T):
    consts = consts_for(V, T, kind)
    ins = case(2 * V + T, V, kind)
    cot = cotangents(V)
    g = reverse(lib, consts, ins, cot, saved)
    if T == 0:
        assert torch.equal(g, torch.cat(cot, 1))
        return
    assert_close(g, torch.cat(k3.plain_micro_rollout_bwd(consts, *ins, *cot),
                              1))


def test_reverse_sweep_matches_jax_kernel_off_the_floor(lib):
    """JAX's K3 (interpret mode) on a draw where no vehicle reaches the
    acceleration floor (JAX keeps a rounding residue there, the port a zero
    gradient); the loss of ``tests/test_torch_micro_rollout.py``."""
    V, T = 10, 50
    consts = consts_for(V, T, "spaced")
    ins = case(5, V, "spaced")
    assert int(k3.floor_hits(consts, *ins).sum()) == 0
    pT, vT = k3.plain_micro_rollout(consts, *ins)
    cot = [2e-4 * pT, 2e-2 * vT]  # d(sum pT^2 1e-4 + sum vT^2 1e-2)
    fused = jk3.make_fused_micro_rollout(DT, T, V, B,
                                         jdefault_params(U_MAX, (V,)),
                                         *HEAD["spaced"], interpret=True)

    def loss(p, v):
        p, v = fused(p, v)
        return jnp.sum(p ** 2) * 1e-4 + jnp.sum(v ** 2) * 1e-2

    want = jax.grad(loss, argnums=(0, 1))(*(jnp.asarray(x.numpy())
                                            for x in ins))
    for saved in (True, False):
        g = reverse(lib, consts, ins, cot, saved).numpy()
        for got, w in zip((g[:, :V], g[:, V:]), want):
            w = np.asarray(w)
            np.testing.assert_allclose(got, w, rtol=5e-3,
                                       atol=1e-5 * np.abs(w).max())


def test_checked_division_accepts_only_the_ieee_quotient(lib):
    rng = np.random.default_rng(0)
    n = 1 << 16

    def draw():
        m = rng.uniform(1, 2, n) * rng.choice([-1, 1], n)
        return (m * np.exp2(rng.integers(-149, 128, n))).astype(np.float32)

    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.0, 2.0, 0.5, 3.0,
                        30.0, 0.01, 1e-5, 1e-30, 1e30, np.inf, -np.inf,
                        np.nan], np.float32)
    sa, sb = (x.ravel() for x in np.meshgrid(special, special))
    bench = rng.uniform(0, 40, n).astype(np.float32)
    a = np.concatenate([draw(), sa, bench])
    b = np.concatenate([draw(), sb, rng.uniform(1e-5, 1000, n).astype(
        np.float32)])
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    want = (ta / tb).view(torch.int32)
    for rounded in (False, True):
        q, ok = k3.div_check(lib, ta, tb, rounded)
        assert not bool((ok & (q.view(torch.int32) != want)).any())
        assert bool(ok[: n].any()) and bool((~ok[: n]).any())
        assert float(ok[-n:].float().mean()) > 0.99


def test_trajectory_only_where_the_backward_reads_one():
    """On CPU tensors the wrapper's backward is autograd of the plain
    version, which reads no trajectory: ``trajectory=True`` returns None
    beside the plain version's outputs, and the autograd Function asks for
    one only when a gradient is needed."""
    consts = consts_for(4, 20, "spaced")
    ins = case(3, 4, "spaced")
    posT, velT, traj = k3.micro_rollout_fwd(consts, *ins, trajectory=True)
    assert traj is None
    for a, b in zip((posT, velT), k3.plain_micro_rollout(consts, *ins)):
        assert torch.equal(a, b)
    fn = k3.make_fused_micro_rollout(DT, 20, 4, B, default_params(U_MAX, (4,)),
                                     *HEAD["spaced"], device="cpu")
    with torch.no_grad():
        out = fn(*ins)
    for a, b in zip(out, (posT, velT)):
        assert torch.equal(a, b)
