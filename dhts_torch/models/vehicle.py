"""Vehicle parameter sets (port of :mod:`dhts.models.vehicle`).

A NamedTuple of tensors with any leading batch shape. ``a`` is the ancillary
mass that carries the flux capacitor's gradient for an emitted vehicle; it
normally equals the vehicle length.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DEFAULT_VEHICLE_LENGTH = 5.0


class VehicleParams(NamedTuple):
    """IDM parameters + length + ancillary mass ``a``; tensors broadcast."""

    accel_max: torch.Tensor
    accel_pref: torch.Tensor
    target_speed: torch.Tensor
    min_space: torch.Tensor
    time_pref: torch.Tensor
    length: torch.Tensor
    a: torch.Tensor

    def zip_map(self, fn, other) -> "VehicleParams":
        return VehicleParams(*(fn(x, o) for x, o in zip(self, other)))


def default_params(speed_limit, shape=(),
                   vehicle_length=DEFAULT_VEHICLE_LENGTH,
                   device="cpu") -> VehicleParams:
    """Speed-limit-scaled defaults: a_max = v_lim, a_pref = 0.8 v_lim,
    v_target = 0.9 v_lim, min_space = 0.1 length, time_pref = 0.1."""
    full = lambda v: torch.full(shape, v, dtype=torch.float32, device=device)
    length = full(vehicle_length)
    return VehicleParams(
        accel_max=full(speed_limit * 1.0),
        accel_pref=full(speed_limit * 0.8),
        target_speed=full(speed_limit * 0.9),
        min_space=length * 0.1,
        time_pref=full(0.1),
        length=length,
        a=length,
    )
