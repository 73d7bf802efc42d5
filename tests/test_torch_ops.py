"""The port's physics ops against :mod:`dhts.ops` on identical inputs.

Inputs are made with numpy from a seed and handed to both sides as float32.
Tolerance: rtol 1e-5 (float32 elementwise ops in the same order; the two
frameworks may differ by an ulp in sqrt/pow, never by a branch), with an
absolute floor of 1e-5 * the value's scale for results that cancel to ~0.
Case indices of the Riemann solver must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.ops import arz as jarz
from dhts.ops import dmath as jdmath
from dhts.ops import idm as jidm
from dhts_torch.ops import arz, dmath, idm

# small tensors: one intra-op thread is fastest and leaves the cores to
# the other test workers
torch.set_num_threads(1)

RTOL = 1e-5


def close(got, ref, scale=1.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=RTOL,
                               atol=RTOL * scale)


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def j(x):
    return jnp.asarray(np.asarray(x, np.float32))


def riemann_inputs(case: str, n=512, u_max=30.0, seed=0):
    """Left/right states that fall into one named case of the solver."""
    rng = np.random.default_rng(seed)
    r_l = rng.uniform(0.05, 0.95, n)
    r_r = rng.uniform(0.05, 0.95, n)
    u_l = rng.uniform(0.0, u_max, n)
    u_r = rng.uniform(0.0, u_max, n)
    if case == "vac_l":
        r_l[:] = rng.choice([0.0, 5e-6], n)
    elif case == "vac_r":
        r_r[:] = rng.choice([0.0, 5e-6], n)
    elif case == "equal":
        u_r = u_l.copy()
    elif case == "shock":
        u_l, u_r = np.maximum(u_l, u_r) + 1.0, np.minimum(u_l, u_r)
    elif case == "rare":
        u_l, u_r = np.minimum(u_l, u_r), np.maximum(u_l, u_r) + 0.5
        r_l = rng.uniform(0.6, 0.95, n)  # u_max + u_l - u_eq_l > u_r
    elif case == "vac_m":
        r_l = rng.uniform(0.001, 0.01, n)
        u_l = rng.uniform(0.0, 1.0, n)
        u_r = np.full(n, u_max + 5.0)
    y_l = r_l * (u_l - u_max * (1.0 - np.sqrt(np.maximum(r_l, 0) + 1e-5)))
    return [np.asarray(x, np.float32) for x in (r_l, y_l, u_l, r_r, u_r)]


@pytest.mark.parametrize("case", ["vac_l", "vac_r", "equal", "shock", "rare",
                                  "vac_m"])
def test_riemann_solve_matches_dhts(case):
    u_max = 30.0
    ins = riemann_inputs(case, u_max=u_max)
    ref = jarz.riemann_solve(*map(j, ins), u_max)
    got = arz.riemann_solve(*map(t, ins), u_max)
    np.testing.assert_array_equal(got.case_ind.numpy(),
                                  np.asarray(ref.case_ind))
    for name in ("r0", "y0", "u0", "speed0", "speed1"):
        close(getattr(got, name).numpy(), getattr(ref, name), scale=u_max)
    close(got.flux_r().numpy(), ref.flux_r(), scale=u_max)
    close(got.flux_y().numpy(), ref.flux_y(), scale=u_max * u_max)


def test_riemann_cases_cover_every_branch():
    """The named inputs above really reach the six predicates."""
    u_max = 30.0
    seen = set()
    for case in ("vac_l", "vac_r", "equal", "shock", "rare", "vac_m"):
        r_l, y_l, u_l, r_r, u_r = riemann_inputs(case, u_max=u_max)
        u_eq_l = u_max * (1 - np.sqrt(np.maximum(r_l, 0) + 1e-5))
        vac_l = r_l < 1e-5
        vac_r = ~vac_l & (r_r < 1e-5)
        taken = vac_l | vac_r
        equal = ~taken & (np.abs(u_l - u_r) < 1e-5)
        taken |= equal
        shock = ~taken & (u_l > u_r)
        taken |= shock
        rare = ~taken & (u_max + u_l - u_eq_l > u_r)
        vac_m = ~(taken | rare)
        name = dict(vac_l=vac_l, vac_r=vac_r, equal=equal, shock=shock,
                    rare=rare, vac_m=vac_m)[case]
        assert name.mean() > 0.9, case
        seen.add(case)
    assert len(seen) == 6


@pytest.mark.parametrize("fn", ["compute_u_eq", "compute_u_eq_prime",
                                "compute_u", "compute_y", "lambda0"])
def test_state_algebra_matches_dhts(fn):
    rng = np.random.default_rng(1)
    u_max = 60.0
    r = np.concatenate([[0.0, 1e-6, 1e-5, 1.0], rng.uniform(0, 1, 252)])
    v = rng.uniform(-20.0, 60.0, r.size)
    args = (r,) if fn in ("compute_u_eq", "compute_u_eq_prime") else (r, v)
    ref = getattr(jarz, fn)(*map(j, args), u_max)
    got = getattr(arz, fn)(*map(t, args), u_max)
    close(got.numpy(), ref, scale=u_max / np.sqrt(1e-5))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_godunov_step_matches_dhts(seed):
    rng = np.random.default_rng(seed)
    u_max, dt = 30.0, 1.0 / 30.0
    L, C = 16, 6
    r = rng.uniform(0.0, 1.0, (L, C))
    r[::5, 2] = 0.0  # vacuum cells inside lanes
    u = rng.uniform(0.0, u_max, (L, C))
    y = r * (u - u_max * (1.0 - np.sqrt(r + 1e-5)))
    lr, lu = rng.uniform(0, 1, L), rng.uniform(0, u_max, L)
    rr, ru = rng.uniform(0, 1, L), rng.uniform(0, u_max, L)
    lr[::4] = 0.0
    cl = rng.uniform(4.0, 6.0, L)
    ins = (r, y, lr, lu, rr, ru)
    ref = jarz.godunov_step(*map(j, ins), u_max, dt, j(cl))
    got = arz.godunov_step(*map(t, ins), u_max, dt, t(cl))
    close(got.r.numpy(), ref.r)
    close(got.y.numpy(), ref.y, scale=u_max)
    close(got.max_wave_speed.numpy(), ref.max_wave_speed, scale=u_max)


def test_idm_acceleration_matches_dhts_with_both_clamps():
    rng = np.random.default_rng(3)
    n = 512
    a_max = rng.uniform(10.0, 60.0, n)
    a_pref = rng.uniform(10.0, 50.0, n)
    v = rng.uniform(0.0, 30.0, n)
    v0 = rng.uniform(10.0, 40.0, n)
    dp = rng.uniform(1e-5, 50.0, n)
    dv = rng.uniform(-60.0, 20.0, n)  # large negative dv: spacing clamp
    s0 = rng.uniform(0.5, 2.0, n)
    tp = rng.uniform(0.1, 0.6, n)
    dp[::9] = 1e-5  # tiny gaps: the -v/dt clamp
    args = (a_max, a_pref, v, v0, dp, dv, s0, tp)
    ref = jidm.idm_acceleration(*map(j, args), 0.01)
    got = idm.idm_acceleration(*map(t, args), 0.01)
    np.testing.assert_array_equal(got.clipped_acceleration.numpy(),
                                  np.asarray(ref.clipped_acceleration))
    np.testing.assert_array_equal(got.clipped_optimal_spacing.numpy(),
                                  np.asarray(ref.clipped_optimal_spacing))
    assert got.clipped_acceleration.any() and \
        got.clipped_optimal_spacing.any()
    close(got.optimal_spacing.numpy(), ref.optimal_spacing)
    close(got.acceleration.numpy(), ref.acceleration, scale=1e3)


def test_euler_step_matches_dhts():
    rng = np.random.default_rng(4)
    p, v, a = (rng.uniform(-5, 50, 64) for _ in range(3))
    ref = jidm.euler_step(j(p), j(v), j(a), 1.0 / 30.0)
    got = idm.euler_step(t(p), t(v), t(a), 1.0 / 30.0)
    for g, r in zip(got, ref):
        close(g.numpy(), r, scale=50.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_micro_lane_step_matches_dhts(seed):
    rng = np.random.default_rng(seed)
    L, V, sl = 12, 8, 30.0
    count = rng.integers(0, V + 1, L)
    gaps = rng.uniform(3.0, 15.0, (L, V))
    gaps[::4, 1] = 2.0  # overlapping vehicles: collision recovery
    pos = np.cumsum(gaps, axis=1)
    vel = rng.uniform(0.0, 25.0, (L, V))
    active = np.arange(V)[None, :] < count[:, None]
    hpd = rng.uniform(-1.0, 40.0, L)
    hsd = rng.uniform(-5.0, 5.0, L)
    ones = np.ones((L, V))
    par = (ones * sl, ones * sl * 0.8, ones * sl * 0.9, ones * 0.5,
           ones * 0.1, ones * 5.0)
    ref = jidm.micro_lane_step(j(pos), j(vel), *map(j, par), j(hpd), j(hsd),
                               jnp.asarray(active), 0.02)
    got = idm.micro_lane_step(t(pos), t(vel), *map(t, par), t(hpd), t(hsd),
                              torch.as_tensor(active), 0.02)
    np.testing.assert_array_equal(got.collided.numpy(),
                                  np.asarray(ref.collided))
    assert got.collided.any()
    close(got.position.numpy(), ref.position, scale=100.0)
    close(got.speed.numpy(), ref.speed, scale=30.0)
    close(got.acceleration.numpy(), ref.acceleration, scale=1e3)


def test_speed_stopped_by_acceleration_floor_has_zero_gradient():
    """A vehicle stopped by the acceleration floor gets ``sp + dt * (-sp /
    dt)``, which does not depend on ``sp``: its gradient is exactly 0 for
    any incoming gradient (autograd of the sum left rounding residues of
    it), and the forward values are unchanged."""
    rng = np.random.default_rng(3)
    L, V = 16, 64
    pos = np.cumsum(np.full((L, V), 4.0), axis=1)  # 4 m gaps, 5 m vehicles
    vel = t(rng.uniform(0.0, 10.0, (L, V))).requires_grad_(True)
    ones = torch.ones((L, V))
    res = idm.micro_lane_step(
        t(pos), vel, 2.0 * ones, 3.0 * ones, 20.0 * ones, 2.0 * ones,
        ones, 5.0 * ones, torch.full((L,), 100.0), torch.zeros(L),
        torch.ones((L, V), dtype=torch.bool), 1.0 / 30)
    stopped = res.collided
    assert int(stopped.sum()) == L * (V - 1)  # every vehicle but the head
    w = t(rng.uniform(0.0, 1000.0, (L, V)))
    (g,) = torch.autograd.grad(torch.sum(res.speed * w), vel)
    assert torch.count_nonzero(g[stopped]) == 0
    _, euler = idm.euler_step(t(pos), vel.detach(),
                              res.acceleration.detach(), 1.0 / 30)
    assert torch.equal(res.speed.detach(), euler)


@pytest.mark.parametrize("name", ["soft_sigmoid", "hard_indicator",
                                  "indicator_soft", "indicator_hard",
                                  "straight_through", "grad_carrier",
                                  "st_clip", "detached"])
def test_dmath_matches_dhts(name):
    rng = np.random.default_rng(5)
    x = rng.uniform(-3.0, 3.0, 256).astype(np.float32)
    y = rng.uniform(-3.0, 3.0, 256).astype(np.float32)
    calls = {
        "soft_sigmoid": lambda m, a, b: m.soft_sigmoid(a, 8.0),
        "hard_indicator": lambda m, a, b: m.hard_indicator(a),
        "indicator_soft": lambda m, a, b: m.indicator(a, 4.0, True),
        "indicator_hard": lambda m, a, b: m.indicator(a, 4.0, False),
        "straight_through": lambda m, a, b: m.straight_through(a, b),
        "grad_carrier": lambda m, a, b: m.grad_carrier(a, b),
        "st_clip": lambda m, a, b: m.st_clip(a, -1.0, 1.5),
        "detached": lambda m, a, b: m.detached(a),
    }
    ref = calls[name](jdmath, j(x), j(y))
    got = calls[name](dmath, t(x), t(y))
    close(got.numpy(), ref)


def test_dmath_gradients_match_dhts():
    """Straight-through combinators route gradients like the JAX ones."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-2.0, 2.0, 64).astype(np.float32)
    y = rng.uniform(-2.0, 2.0, 64).astype(np.float32)

    def jf(a, b):
        return jnp.sum(jdmath.st_clip(a, -1.0, 1.0) * 2.0 +
                       jdmath.grad_carrier(a, b) +
                       jdmath.straight_through(a * 0.0, jdmath.soft_sigmoid(
                           b, 4.0)))

    ga, gb = jax.grad(jf, argnums=(0, 1))(j(x), j(y))
    a, b = t(x).requires_grad_(), t(y).requires_grad_()
    out = torch.sum(dmath.st_clip(a, -1.0, 1.0) * 2.0 +
                    dmath.grad_carrier(a, b) +
                    dmath.straight_through(a * 0.0,
                                           dmath.soft_sigmoid(b, 4.0)))
    out.backward()
    close(a.grad.numpy(), ga)
    close(b.grad.numpy(), gb)


@pytest.mark.parametrize("x,expect", [(16.0, 0.5), (-16.0, 0.5), (3.0, 1.0),
                                      (17.0, 0.0), (-20.0, 0.0)])
def test_clip_gradient_at_bound_matches_jax(x, expect):
    """At a bound (x == +-16, where a straight-through gate of exactly 0 or
    1 puts soft_sigmoid(gate - 0.5, 32)) jnp.clip passes half the gradient;
    torch.clamp would pass all of it. Exact."""
    ref = float(jax.grad(lambda v: jnp.clip(v, -16.0, 16.0))(
        jnp.float32(x)))
    xt = torch.tensor(x, requires_grad=True)
    (got,) = torch.autograd.grad(dmath.clip(xt, -16.0, 16.0), xt)
    assert ref == expect and float(got) == expect
    xt = torch.tensor(x, requires_grad=True)
    (g_max,) = torch.autograd.grad(dmath.maximum(xt, 16.0), xt)
    (g_min,) = torch.autograd.grad(dmath.minimum(xt, -16.0), xt)
    assert float(g_max) == float(jax.grad(
        lambda v: jnp.maximum(v, 16.0))(jnp.float32(x)))
    assert float(g_min) == float(jax.grad(
        lambda v: jnp.minimum(v, -16.0))(jnp.float32(x)))


def test_soft_sigmoid_gradient_at_clip_bound_matches_jax():
    """soft_sigmoid(+-0.5, 32) sits exactly on the clip bound: its gradient
    is JAX's (half of sigmoid'(16) * 32), rel 1e-6."""
    for v in (0.5, -0.5):
        ref = float(jax.grad(lambda a: jdmath.soft_sigmoid(a, 32.0))(
            jnp.float32(v)))
        xt = torch.tensor(v, requires_grad=True)
        (got,) = torch.autograd.grad(dmath.soft_sigmoid(xt, 32.0), xt)
        assert float(got) == pytest.approx(ref, rel=1e-6)
