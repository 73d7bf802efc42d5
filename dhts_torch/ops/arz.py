"""ARZ macroscopic traffic model on tensors (port of :mod:`dhts.ops.arz`).

State per cell is ``(r, y)``: density ``r`` (jam density 1) and relative flow
``y = r * (u - u_eq(r))`` with the Greenshields-style closure
``u_eq = u_max * (1 - sqrt(r + eps))``. :func:`riemann_solve` is the
branch-free six-case exact Riemann solver and :func:`godunov_step` the
finite-volume update over a whole lane or a batch of lanes, with the cell
axis last.

Every operation is an IEEE-rounded elementwise op in a fixed order, and no
tensor is ever divided by a Python number (PyTorch's CUDA backend turns
``x / c`` into ``x * (1 / c)``, and ``c / x`` into ``reciprocal(x) * c``):
the hand-written CUDA kernel of the ITSCP episode repeats this arithmetic
operation for operation, so that the two agree bit for bit on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dhts_torch.ops.dmath import maximum

GAMMA = 0.5
EPSILON = 1e-5


def sqrt(x):
    """Correctly rounded float32 square root on every device. PyTorch's
    vectorised CPU ``sqrt`` may differ from it by an ulp; on the CPU the root
    is taken in float64 and rounded once (exact for float32 inputs)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def div(x, d):
    """``x / d`` as a true elementwise division, also for a Python ``d``."""
    if isinstance(d, torch.Tensor):
        return x / d
    return x / torch.full_like(x, d)


def rdiv(n, x):
    """``n / x`` for a Python ``n`` as a true elementwise division."""
    return torch.full_like(x, n) / x


def compute_u_eq(r, u_max):
    """Equilibrium speed ``u_max * (1 - sqrt(max(r, 0) + eps))``."""
    r = maximum(r, 0.0)
    return u_max * (1.0 - sqrt(r + EPSILON))


def compute_u_eq_prime(r, u_max):
    """d(u_eq)/dr with the ``max(r, eps)`` clamp: ``-u_max/2 / sqrt(r)``."""
    r = maximum(r, EPSILON)
    return (-u_max * GAMMA) * sqrt(r).reciprocal()


def compute_y(r, u, u_max):
    """Relative flow ``y = r * (u - u_eq(r))``."""
    return r * (u - compute_u_eq(r, u_max))


def compute_u(r, y, u_max):
    """Speed ``u = y / max(r, eps) + u_eq(max(r, eps))``."""
    r = maximum(r, EPSILON)
    return y / r + compute_u_eq(r, u_max)


def lambda0(r, u, u_max):
    """First characteristic speed ``u + r * u_eq'(r)``."""
    return u + r * compute_u_eq_prime(r, u_max)


class RiemannSolution(NamedTuple):
    """Interface state and wave speeds; ``case_ind`` 0 = Q_L, 1 = Q_M,
    2 = centred rarefaction Q_C."""

    r0: torch.Tensor
    y0: torch.Tensor
    u0: torch.Tensor
    speed0: torch.Tensor
    speed1: torch.Tensor
    case_ind: torch.Tensor

    def flux_r(self):
        return self.r0 * self.u0

    def flux_y(self):
        return self.y0 * self.u0


def riemann_solve(r_l, y_l, u_l, r_r, u_r, u_max) -> RiemannSolution:
    """Exact ARZ Riemann solver, elementwise and branch-free.

    The six mutually exclusive cases, in priority order: left vacuum
    (``r_l < eps``), right vacuum, equal speeds, shock (``u_l > u_r``),
    rarefaction with a middle state, and vacuum middle — each value is
    computed for every element and selected with ``torch.where``, exactly
    as ``dhts.ops.arz.riemann_solve`` does.
    """
    u_eq_l = compute_u_eq(r_l, u_max)
    lam0_l = lambda0(r_l, u_l, u_max)
    r_l_pow = sqrt(maximum(r_l, EPSILON))

    # middle state (Rankine-Hugoniot / rarefaction invariant)
    r_m = torch.square(r_l_pow + div(u_l - u_r, u_max))
    u_m = u_r
    lam0_m = lambda0(r_m, u_m, u_max)
    flux_r_m = r_m * u_m

    # vacuum middle state
    u_vac = u_max + u_l - u_eq_l

    # centred rarefaction state
    r_c = torch.square(div(u_l + u_max * r_l_pow, (GAMMA + 1.0) * u_max))
    u_c = (GAMMA / (GAMMA + 1.0)) * (u_l + u_max * r_l_pow)

    vac_l = r_l < EPSILON
    vac_r = (~vac_l) & (r_r < EPSILON)
    taken = vac_l | vac_r
    equal = (~taken) & (torch.abs(u_l - u_r) < EPSILON)
    taken = taken | equal
    shock = (~taken) & (u_l > u_r)
    taken = taken | shock
    rare = (~taken) & (u_max + u_l - u_eq_l > u_r)

    shock_speed = (flux_r_m - r_l * u_l) / maximum(r_m - r_l, EPSILON)
    half_lam_m = (lam0_l + lam0_m) * 0.5
    half_lam_vac = (lam0_l + u_vac) * 0.5

    zero = torch.zeros_like(u_l)
    speed0 = torch.where(
        vac_l, zero,
        torch.where(vac_r, half_lam_vac,
                    torch.where(equal, zero,
                                torch.where(shock, shock_speed,
                                            torch.where(rare, half_lam_m,
                                                        half_lam_vac)))))
    speed1 = torch.where(vac_l, u_l, torch.where(vac_r, half_lam_vac, u_r))

    i0 = torch.zeros(u_l.shape, dtype=torch.int32, device=u_l.device)
    i1 = torch.ones_like(i0)
    i2 = torch.full_like(i0, 2)
    l_or_c = torch.where(lam0_l >= 0.0, i0, i2)
    case = torch.where(
        vac_l, i0,
        torch.where(
            vac_r, l_or_c,
            torch.where(
                equal, i0,
                torch.where(
                    shock, torch.where(shock_speed >= 0.0, i0, i1),
                    torch.where(
                        rare,
                        torch.where(lam0_l >= 0.0, i0,
                                    torch.where(lam0_m <= 0.0, i1, i2)),
                        l_or_c)))))

    is_m = case == 1
    is_c = case == 2
    r0 = torch.where(is_m, r_m, torch.where(is_c, r_c, r_l))
    u0 = torch.where(is_m, u_m, torch.where(is_c, u_c, u_l))
    y0 = torch.where(is_m | is_c, compute_y(r0, u0, u_max), y_l)
    return RiemannSolution(r0=r0, y0=y0, u0=u0, speed0=speed0, speed1=speed1,
                           case_ind=case)


class MacroStepResult(NamedTuple):
    r: torch.Tensor
    y: torch.Tensor
    max_wave_speed: torch.Tensor  # CFL diagnostic: must stay < dx / dt


def godunov_step(r, y, left_r, left_u, right_r, right_u, u_max, dt,
                 cell_length) -> MacroStepResult:
    """One Godunov step of ``[..., C]`` cells with ghost cells ``[...]``.

    Solves all ``C + 1`` interfaces at once and applies
    ``q += dt/dx * (F_left - F_right)``; returns the largest absolute wave
    speed per lane instead of asserting the CFL condition.
    """
    left_r = torch.as_tensor(left_r, dtype=r.dtype, device=r.device)[..., None]
    left_u = torch.as_tensor(left_u, dtype=r.dtype, device=r.device)[..., None]
    right_r = torch.as_tensor(right_r, dtype=r.dtype,
                              device=r.device)[..., None]
    right_u = torch.as_tensor(right_u, dtype=r.dtype,
                              device=r.device)[..., None]
    left_y = compute_y(left_r, left_u, u_max)

    u = compute_u(r, y, u_max)
    # interface i: left [ghost_L, cells][i], right [cells, ghost_R][i]
    rl = torch.cat([left_r, r], dim=-1)
    yl = torch.cat([left_y, y], dim=-1)
    ul = torch.cat([left_u, u], dim=-1)
    rr = torch.cat([r, right_r], dim=-1)
    ur = torch.cat([u, right_u], dim=-1)

    sol = riemann_solve(rl, yl, ul, rr, ur, u_max)
    fr = sol.flux_r()
    fy = sol.flux_y()
    if isinstance(cell_length, torch.Tensor) and cell_length.dim() > 0:
        coeff = rdiv(dt, cell_length)[..., None]
    else:
        coeff = rdiv(dt, torch.as_tensor(cell_length, dtype=r.dtype,
                                         device=r.device))
    new_r = r + (fr[..., :-1] - fr[..., 1:]) * coeff
    new_y = y + (fy[..., :-1] - fy[..., 1:]) * coeff
    max_speed = torch.maximum(torch.abs(sol.speed0), torch.abs(sol.speed1))
    return MacroStepResult(r=new_r, y=new_y,
                           max_wave_speed=torch.amax(max_speed, dim=-1))
