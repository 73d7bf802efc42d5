"""Differentiable soft-logic primitives (port of :mod:`dhts.ops.dmath`).

A scaled, clamped sigmoid used as a soft IF statement plus the named
straight-through combinators the event logic is written with. All functions
broadcast elementwise over tensors.
"""

from __future__ import annotations

import torch


def soft_sigmoid(value, constant, lo=-16.0, hi=16.0):
    """``sigmoid(clip(value * constant, lo, hi))`` — a differentiable IF."""
    return torch.sigmoid(torch.clamp(value * constant, lo, hi))


def hard_indicator(value):
    """Non-differentiable IF: 1.0 where ``value > 0`` else 0.0 (float32)."""
    return (value > 0.0).to(torch.float32)


def indicator(value, constant, differentiable: bool):
    """Soft sigmoid when ``differentiable`` else the exact comparison."""
    if differentiable:
        return soft_sigmoid(value, constant)
    return hard_indicator(value)


def straight_through(hard, soft):
    """Forward value ``hard``, backward gradient of ``soft``."""
    return soft + (hard - soft).detach()


def grad_carrier(value, grad_src):
    """Evaluates to ``value`` (up to rounding) but carries ``grad_src``'s
    gradient: ``value + grad_src - detach(grad_src)``, in that order."""
    return value + grad_src - grad_src.detach()


def st_clip(x, lo, hi):
    """Straight-through clamp: forward ``x - detach(x - clip(x))``."""
    return x - (x - torch.clamp(x, lo, hi)).detach()


def detached(x):
    """Alias for ``Tensor.detach`` to keep event code self-describing."""
    return x.detach()
