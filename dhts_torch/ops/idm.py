"""IDM car-following on tensors (port of :mod:`dhts.ops.idm`).

One elementwise acceleration function with the two safety clamps, the
explicit-Euler integrator, and the step of every vehicle of a lane (or a
batch of lanes) at once. Vehicles are stored tail to head along the last
axis: slot ``i`` is directly behind slot ``i + 1``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dhts_torch.ops.arz import div, sqrt
from dhts_torch.ops.dmath import maximum

IDM_DELTA = 4.0
POSITION_DELTA_EPS = 1e-5


class IdmResult(NamedTuple):
    acceleration: torch.Tensor
    optimal_spacing: torch.Tensor
    clipped_acceleration: torch.Tensor  # bool: negative-speed clamp fired
    clipped_optimal_spacing: torch.Tensor  # bool: spacing clamp fired


def idm_acceleration(accel_max, accel_pref, speed, target_speed,
                     position_delta, speed_delta, min_space, time_pref,
                     delta_time) -> IdmResult:
    """IDM acceleration; the optimal spacing is clipped at 0 and the
    acceleration at ``-speed / dt`` (no negative speed after Euler)."""
    optimal_spacing_raw = (min_space + speed * time_pref +
                           (speed * speed_delta) /
                           (2.0 * sqrt(accel_max * accel_pref)))
    clipped_spacing = optimal_spacing_raw < 0.0
    optimal_spacing = maximum(optimal_spacing_raw, 0.0)

    speed_ratio_4 = torch.square(torch.square(speed / target_speed))
    acc_raw = accel_max * (1.0 - speed_ratio_4 -
                           torch.square(optimal_spacing / position_delta))

    acc_floor = div(-speed, delta_time)
    clipped_acc = acc_raw < acc_floor
    acc = torch.maximum(acc_raw, acc_floor)
    return IdmResult(acceleration=acc, optimal_spacing=optimal_spacing,
                     clipped_acceleration=clipped_acc,
                     clipped_optimal_spacing=clipped_spacing)


class MicroStepResult(NamedTuple):
    position: torch.Tensor
    speed: torch.Tensor
    acceleration: torch.Tensor
    collided: torch.Tensor  # bool per vehicle: raw gap to leader was negative


def euler_step(position, speed, acceleration, delta_time):
    """New position from the *old* speed, new speed from the acceleration."""
    return position + delta_time * speed, speed + delta_time * acceleration


def _shift_lead(x):
    """Leader of slot i is slot i + 1; the last slot's leader is zero."""
    return torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)


def micro_lane_step(position, speed, accel_max, accel_pref, target_speed,
                    min_space, time_pref, length, head_position_delta,
                    head_speed_delta, active, delta_time) -> MicroStepResult:
    """Step every vehicle of ``[..., V]`` rows once.

    The head (last active slot) uses the lane's boundary deltas
    ``head_position_delta`` / ``head_speed_delta`` (shape ``[...]``); a
    negative raw gap zeroes both deltas and is reported in ``collided``;
    inactive slots stay where they are.
    """
    lead_pos = _shift_lead(position)
    lead_speed = _shift_lead(speed)
    lead_len = _shift_lead(length)
    lead_active = _shift_lead(active)

    in_lane_gap = torch.abs(lead_pos - position) - (lead_len + length) * 0.5
    in_lane_dv = speed - lead_speed

    is_head = active & ~lead_active
    hpd = torch.as_tensor(head_position_delta, dtype=position.dtype,
                          device=position.device)[..., None]
    hsd = torch.as_tensor(head_speed_delta, dtype=position.dtype,
                          device=position.device)[..., None]
    pos_delta = torch.where(is_head, hpd, in_lane_gap)
    spd_delta = torch.where(is_head, hsd, in_lane_dv)

    collided = active & (pos_delta < 0.0)
    zero = torch.zeros_like(pos_delta)
    pos_delta = torch.where(collided, zero, pos_delta)
    spd_delta = torch.where(collided, zero, spd_delta)
    pos_delta = maximum(pos_delta, POSITION_DELTA_EPS)

    res = idm_acceleration(accel_max, accel_pref, speed, target_speed,
                           pos_delta, spd_delta, min_space, time_pref,
                           delta_time)
    acc = torch.where(active, res.acceleration, zero)

    new_pos, new_speed = euler_step(position, speed, acc, delta_time)
    # stopped by the acceleration floor: speed + dt * (-speed / dt) does not
    # depend on speed, so its derivative is 0; autograd of the sum would
    # leave a rounding residue of the incoming gradient instead
    new_speed = torch.where(active & res.clipped_acceleration,
                            new_speed.detach(), new_speed)
    new_pos = torch.where(active, new_pos, position)
    new_speed = torch.where(active, new_speed, speed)
    return MicroStepResult(position=new_pos, speed=new_speed,
                           acceleration=acc, collided=collided)
