"""Single-lane rollouts with fixed boundaries (port of
:mod:`dhts.models.lane`).

The setting of the inverse benchmarks: one isolated ARZ lane between
constant ghost cells, or one IDM platoon behind a constant virtual leader,
stepped ``num_steps`` times. Where JAX runs a ``lax.scan``, these are Python
loops over the step ops of :mod:`dhts_torch.ops.arz` and
:mod:`dhts_torch.ops.idm`; every op works on ``[..., C]`` / ``[..., V]`` rows,
so a leading batch axis (CMA-ES populations, GD restarts) needs no ``vmap``.
Gradients are PyTorch autograd through the loop. The fused kernels K2 and K3
(:mod:`dhts_torch.ops.cuda.macro_rollout`, ``micro_rollout``) compute the
same rollouts in one launch each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dhts_torch.models.vehicle import VehicleParams
from dhts_torch.ops import arz, idm


class MacroRollout(NamedTuple):
    r: torch.Tensor  # [..., C] final density
    y: torch.Tensor  # [..., C] final relative flow
    u: torch.Tensor  # [..., C] final speed
    max_wave_speed: torch.Tensor  # [...] CFL diagnostic over the rollout


def godunov_rollout(r0, y0, left_r, left_u, right_r, right_u, speed_limit,
                    delta_time, cell_length, num_steps):
    """``num_steps`` Godunov steps of ``[..., C]`` cells ``(r, y)`` between
    constant ghost cells (``[...]`` or scalars): ``(rT, yT, max_wave[...])``,
    the largest absolute wave speed over every interface and step."""
    ghost = lambda v: torch.as_tensor(v, dtype=r0.dtype,
                                      device=r0.device).expand(r0.shape[:-1])
    left_r, left_u, right_r, right_u = map(ghost, (left_r, left_u, right_r,
                                                   right_u))
    r, y, max_wave = r0, y0, None
    for _ in range(int(num_steps)):
        res = arz.godunov_step(r, y, left_r, left_u, right_r, right_u,
                               speed_limit, delta_time, cell_length)
        r, y = res.r, res.y
        max_wave = res.max_wave_speed if max_wave is None else \
            torch.maximum(max_wave, res.max_wave_speed)
    if max_wave is None:
        max_wave = torch.zeros(r.shape[:-1], dtype=r.dtype, device=r.device)
    return r, y, max_wave


def macro_rollout(r0, u0, left_r, left_u, right_r, right_u, speed_limit,
                  delta_time, cell_length, num_steps) -> MacroRollout:
    """Roll an ARZ lane ``num_steps`` from density ``r0`` and speed ``u0``
    with fixed leftmost/rightmost ghost cells."""
    y0 = arz.compute_y(r0, u0, speed_limit)
    rT, yT, max_wave = godunov_rollout(r0, y0, left_r, left_u, right_r,
                                       right_u, speed_limit, delta_time,
                                       cell_length, num_steps)
    return MacroRollout(r=rT, y=yT, u=arz.compute_u(rT, yT, speed_limit),
                        max_wave_speed=max_wave)


class MicroRollout(NamedTuple):
    position: torch.Tensor  # [..., V]
    speed: torch.Tensor  # [..., V]
    any_collision: torch.Tensor  # bool [...] diagnostic


def micro_rollout(position0, speed0, params: VehicleParams, active,
                  head_position_delta, head_speed_delta, delta_time,
                  num_steps) -> MicroRollout:
    """Roll an IDM lane ``num_steps``; the head vehicle sees the constant
    virtual leader ``(head_position_delta, head_speed_delta)``."""
    p, v = position0, speed0
    coll = torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
    for _ in range(int(num_steps)):
        res = idm.micro_lane_step(
            p, v, accel_max=params.accel_max, accel_pref=params.accel_pref,
            target_speed=params.target_speed, min_space=params.min_space,
            time_pref=params.time_pref, length=params.length,
            head_position_delta=head_position_delta,
            head_speed_delta=head_speed_delta, active=active,
            delta_time=delta_time)
        p, v = res.position, res.speed
        coll = coll | res.collided.any(-1)
    return MicroRollout(position=p, speed=v, any_collision=coll)
