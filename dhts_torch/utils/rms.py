"""Running means that tune soft-sigmoid sharpness (port of
:mod:`dhts.utils.rms`): a detached ``(sum, count)`` state updated once per
step with that step's observations.

Each step's masked sum is accumulated in float64 and rounded once to
float32, so its value does not depend on the order of the additions: the
CUDA kernel of the ITSCP episode sums per lane and then over lanes, and
gets the same float32 partial sum."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dhts_torch.ops.dmath import maximum


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
    part = torch.sum((data * m).to(torch.float64)).to(torch.float32)
    return MeanState(total=state.total + part,
                     count=state.count + torch.sum(m))


def mean_of(state: MeanState, default=1.0):
    return torch.where(state.count > 0,
                       state.total / maximum(state.count, 1.0),
                       torch.full_like(state.total, default))
