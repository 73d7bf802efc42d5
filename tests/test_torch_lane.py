"""The port's single-lane rollouts (:mod:`dhts_torch.models.lane`) against
:mod:`dhts.models.lane` on identical inputs, values and gradients.

Inputs are drawn with numpy from a seed and handed to both sides as
float32; the port's rollouts take a leading batch axis where JAX vmaps.
Tolerances: states rtol 1e-4 with an absolute floor of 1e-4 * the value's
scale (the same float32 ops in the same order, an ulp apart in a root or a
power now and then, over tens of steps); gradients rtol 5e-3, atol 5e-4 *
max|g| for the macro lane and 1e-5 * max|g| for the micro lane (the JAX
package's fused-vs-scan standard, ``tests/test_pallas.py``).

Probes: vacuum (r = 0) and jammed (r = 1, u = 0) cells and ghost cells, and
touching or overlapping vehicles (a negative gap, ``collided``); values and
gradients stay finite on both sides.

The acceleration floor. The port gives a speed stopped by the floor
``-speed / dt`` a zero gradient (``dhts_torch/ops/idm.py``); JAX's
``euler_step`` leaves a rounding residue there. The micro gradients are
therefore held against ``jax.grad`` traced with ``dhts.ops.idm.euler_step``
wrapped to stop that gradient, and each micro test prints and asserts how
many vehicle-steps hit the floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.models import lane as jlane
from dhts.models.vehicle import default_params as jdefault_params
from dhts.ops import idm as jidm
from dhts_torch.models import lane
from dhts_torch.models.vehicle import default_params
from dhts_torch.ops.cuda import micro_rollout as k3

torch.set_num_threads(1)

U_MAX, DT, DX = 30.0, 0.01, 5.0


def euler_step_exact_floor(position, speed, acceleration, delta_time):
    """``dhts.ops.idm.euler_step`` whose new speed has a zero gradient
    where the acceleration floor ``-speed / dt`` binds."""
    new_speed = speed + delta_time * acceleration
    stopped = acceleration == (-speed) / delta_time
    return (position + delta_time * speed,
            jnp.where(stopped, jax.lax.stop_gradient(new_speed), new_speed))


def close(got, ref, rtol, scale):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=rtol * scale)


def macro_case(seed, B, probe):
    rng = np.random.default_rng(seed)
    r0 = rng.uniform(0.0, 1.0, (B, 8)).astype(np.float32)
    u0 = rng.uniform(0.0, U_MAX, (B, 8)).astype(np.float32)
    g = [rng.uniform(0, 1, B), rng.uniform(0, U_MAX, B),
         rng.uniform(0, 1, B), rng.uniform(0, U_MAX, B)]
    if probe:
        r0[:, 1:3], u0[:, 1:3] = 0.0, 0.0  # vacuum
        r0[:, 5:7], u0[:, 5:7] = 1.0, 0.0  # jam
        g[0][:], g[1][:] = 0.0, 0.0        # vacuum left ghost
        g[2][:], g[3][:] = 1.0, 0.0        # jammed right ghost
    return (r0, u0, *(x.astype(np.float32) for x in g))


def jax_macro(args, T):
    def one(r0, u0, blr, blu, brr, bru):
        res = jlane.macro_rollout(r0, u0, blr, blu, brr, bru, U_MAX, DT, DX,
                                  T)
        return res.r, res.y, res.u, res.max_wave_speed

    return jax.vmap(one)(*map(jnp.asarray, args))


@pytest.mark.parametrize("probe", [False, True], ids=["random", "vac_jam"])
def test_macro_rollout_matches_dhts(probe):
    args = macro_case(1, 3, probe)
    T = 60
    res = lane.macro_rollout(*map(torch.as_tensor, args), U_MAX, DT, DX, T)
    ref = jax_macro(args, T)
    for got, want in zip(res, ref):
        got = got.numpy()
        assert np.isfinite(got).all()
        close(got, want, 1e-4, np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("probe", [False, True], ids=["random", "vac_jam"])
def test_macro_rollout_gradients_match_dhts(probe):
    args = macro_case(2, 2, probe)
    T = 40

    def jloss(*a):
        r, y, _, _ = jax_macro(a, T)
        return jnp.sum(r ** 2) + 1e-3 * jnp.sum(y ** 2)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    ins = [torch.as_tensor(a).requires_grad_(True) for a in args]
    res = lane.macro_rollout(*ins, U_MAX, DT, DX, T)
    (torch.sum(res.r ** 2) + 1e-3 * torch.sum(res.y ** 2)).backward()
    # the right ghost density enters only the right-vacuum test: no
    # gradient (None in PyTorch, zeros in JAX)
    assert ins[4].grad is None and not np.asarray(want[4]).any()
    for x, w in zip(ins[:4] + ins[5:], want[:4] + want[5:]):
        g, w = x.grad.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=5e-3,
                                   atol=5e-4 * max(np.abs(w).max(), 1e-30))


def micro_case(seed, B, touching):
    rng = np.random.default_rng(seed)
    gap = rng.uniform(1.2, 4.0, (B, 6)) * 5.0
    vel = rng.uniform(2.0, 25.0, (B, 6))
    if touching:  # dense and slow: overlaps, collisions, the floor binds
        gap = rng.uniform(4.0, 5.6, (B, 6))
        vel = rng.uniform(0.0, 3.0, (B, 6))
    return (np.cumsum(gap, axis=1).astype(np.float32),
            vel.astype(np.float32))


def jax_micro(pos0, vel0, T):
    n = pos0.shape[-1]
    params = jdefault_params(U_MAX, (n,))

    def one(p, v):
        res = jlane.micro_rollout(p, v, params, jnp.ones(n, bool), 1000.0,
                                  0.0, DT, T)
        return res.position, res.speed, res.any_collision

    return jax.vmap(one)(pos0, vel0)


def port_micro(pos0, vel0, T):
    n = pos0.shape[-1]
    return lane.micro_rollout(pos0, vel0, default_params(U_MAX, (n,)),
                              torch.ones(n, dtype=torch.bool), 1000.0, 0.0,
                              DT, T)


def floor_hit_count(pos0, vel0, T):
    consts = k3.micro_consts(default_params(U_MAX, (pos0.shape[-1],)),
                             1000.0, 0.0, DT, T, "cpu")
    return int(k3.floor_hits(consts, torch.as_tensor(pos0),
                             torch.as_tensor(vel0)).sum())


@pytest.mark.parametrize("touching", [False, True], ids=["spaced", "touch"])
def test_micro_rollout_matches_dhts(touching):
    pos0, vel0 = micro_case(3, 3, touching)
    T = 60
    res = port_micro(torch.as_tensor(pos0), torch.as_tensor(vel0), T)
    jp, jv, jc = jax_micro(jnp.asarray(pos0), jnp.asarray(vel0), T)
    hits = floor_hit_count(pos0, vel0, T)
    print(f"floor hits: {hits}")
    assert (hits > 0) == touching
    close(res.position.numpy(), jp, 1e-4, np.abs(np.asarray(jp)).max())
    close(res.speed.numpy(), jv, 1e-4, np.abs(np.asarray(jv)).max())
    np.testing.assert_array_equal(res.any_collision.numpy(), np.asarray(jc))
    assert bool(res.any_collision.any()) == touching


@pytest.mark.parametrize("touching", [False, True], ids=["spaced", "touch"])
def test_micro_rollout_gradients_match_dhts(touching):
    """Against ``jax.grad`` with the floor's derivative exact (module
    docstring)."""
    pos0, vel0 = micro_case(4, 2, touching)
    T = 40
    hits = floor_hit_count(pos0, vel0, T)
    print(f"floor hits: {hits}")
    assert (hits > 0) == touching

    def jloss(p, v):
        pT, vT, _ = jax_micro(p, v, T)
        return jnp.sum(pT ** 2) * 1e-4 + jnp.sum(vT ** 2) * 1e-2

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jidm, "euler_step", euler_step_exact_floor)
        want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pos0),
                                               jnp.asarray(vel0))
    ins = [torch.as_tensor(a).requires_grad_(True) for a in (pos0, vel0)]
    res = port_micro(*ins, T)
    (torch.sum(res.position ** 2) * 1e-4 +
     torch.sum(res.speed ** 2) * 1e-2).backward()
    for x, w in zip(ins, want):
        g, w = x.grad.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=5e-3,
                                   atol=1e-5 * np.abs(w).max())
