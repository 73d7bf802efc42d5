"""Running means that tune soft-sigmoid sharpness (port of
:mod:`dhts.utils.rms`): a detached ``(sum, count)`` state updated once per
step with that step's observations."""

from __future__ import annotations

from typing import NamedTuple

import torch


class MeanState(NamedTuple):
    total: torch.Tensor  # f32 scalar
    count: torch.Tensor  # f32 scalar


def init_mean_state(device="cpu") -> MeanState:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return MeanState(total=z, count=z.clone())


def update_mean_masked(state: MeanState, data, mask) -> MeanState:
    """Accumulate only ``mask``-selected entries of ``data``, detached."""
    data = data.detach().to(torch.float32)
    m = mask.to(torch.float32)
    return MeanState(total=state.total + torch.sum(data * m),
                     count=state.count + torch.sum(m))


def mean_of(state: MeanState, default=1.0):
    return torch.where(state.count > 0,
                       state.total / torch.clamp(state.count, min=1.0),
                       torch.full_like(state.total, default))
