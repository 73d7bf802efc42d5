"""MLP signal controller (port of :mod:`dhts.apps.control.controller`).

A plain MLP (Linear + tanh per hidden layer, 256 x 256 by default) mapping
the schedule observation to one raw value per signal phase per
intersection; :func:`squash_action` maps it into the action box.
:func:`params_from_flax` carries a trained flax parameter tree across.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from dhts_torch.device import resolve_device


class Controller(nn.Module):
    def __init__(self, obs_size: int, output_size: int,
                 network_size: Sequence[int] = (256, 256)):
        super().__init__()
        widths = [int(obs_size), *map(int, network_size)]
        self.hidden = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.head = nn.Linear(widths[-1], int(output_size))

    def forward(self, obs):
        x = obs
        for layer in self.hidden:
            x = torch.tanh(layer(x))
        return self.head(x)


def squash_action(raw, low, high):
    """Map raw controller output into the action box [low, high]."""
    return low + (high - low) * torch.sigmoid(raw)


def init_controller(generator: torch.Generator, obs_size: int,
                    output_size: int, network_size=(256, 256),
                    device=None) -> Controller:
    """A controller with flax's default initialisation (truncated-normal
    LeCun kernels, zero biases), drawn from ``generator``."""
    dev = resolve_device(device)
    model = Controller(obs_size, output_size, network_size)
    with torch.no_grad():
        for layer in [*model.hidden, model.head]:
            fan_in = layer.weight.shape[1]
            # flax lecun_normal: variance 1/fan_in of a normal truncated
            # at two standard deviations (std corrected for the cut)
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            w = torch.empty(layer.weight.shape[::-1])
            torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
            layer.weight.copy_(w.T)
            layer.bias.zero_()
    return model.to(dev)


def params_from_flax(params) -> dict:
    """State dict of :class:`Controller` from a flax parameter tree
    ``{'params': {'Dense_i': {'kernel': [in, out], 'bias': [out]}}}``
    (numpy or array-likes); kernels are transposed to ``[out, in]``."""
    tree = params["params"] if "params" in params else params
    names = sorted((k for k in tree if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    state = {}
    for i, name in enumerate(names):
        kernel = np.asarray(tree[name]["kernel"], np.float32)
        bias = np.asarray(tree[name]["bias"], np.float32)
        prefix = "head" if i == len(names) - 1 else f"hidden.{i}"
        state[f"{prefix}.weight"] = torch.from_numpy(kernel.T.copy())
        state[f"{prefix}.bias"] = torch.from_numpy(bias.copy())
    return state
