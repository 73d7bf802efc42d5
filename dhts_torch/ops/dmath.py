"""Differentiable soft-logic primitives (port of :mod:`dhts.ops.dmath`).

A scaled, clamped sigmoid used as a soft IF statement, the named
straight-through combinators the event logic is written with, and the
float clamps of the differentiable path. All functions broadcast
elementwise over tensors.

Clamps follow JAX's gradient rule: at a tie (``x == bound``) ``jnp.maximum``,
``jnp.minimum`` and ``jnp.clip`` pass half the gradient to each side, while
``torch.clamp`` passes all of it to ``x``. In straight-through mode the gates
are exactly 0 or 1, so ``soft_sigmoid(gate - 0.5, 32)`` sits exactly on the
clip bound of +-16 and ``torch.clamp`` would double the gradient. Every float
clamp of the differentiable path goes through :func:`maximum`,
:func:`minimum` or :func:`clip` (``torch.maximum``/``torch.minimum`` between
tensors split ties 0.5/0.5, like JAX).
"""

from __future__ import annotations

import torch


def _like(bound, x):
    if isinstance(bound, torch.Tensor):
        return bound
    return torch.full((), bound, dtype=x.dtype, device=x.device)


def maximum(x, bound):
    """``max(x, bound)``; at a tie each side gets half the gradient."""
    return torch.maximum(x, _like(bound, x))


def minimum(x, bound):
    """``min(x, bound)``; at a tie each side gets half the gradient."""
    return torch.minimum(x, _like(bound, x))


def clip(x, lo, hi):
    """``min(max(x, lo), hi)`` with JAX's tie rule (gradient 0.5 at a
    bound, 1 inside, 0 outside)."""
    return minimum(maximum(x, lo), hi)


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sigmoid(x.to(torch.float64)).to(x.dtype)
        ctx.save_for_backward(y)
        ctx.save_for_forward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return grad * (y * (1.0 - y))

    @staticmethod
    def jvp(ctx, x_t):
        (y,) = ctx.saved_tensors
        return x_t * (y * (1.0 - y))


def sigmoid(x):
    """float32 sigmoid taken in float64 and rounded once; its gradient is
    ``y * (1 - y)`` of the rounded ``y``, as JAX's ``logistic`` computes it.

    The CUDA kernel of the ITSCP episode evaluates ``1 / (1 + exp(-x))`` in
    double and rounds the same way: two float64 results that differ by an
    ulp of float64 round to the same float32, so the gates agree bit for bit
    across devices and math libraries (float32 ``exp`` implementations
    differ by ulps). Near saturation ``1 - y`` is a few float32 ulps, so the
    gradient is taken from the rounded value, as in JAX, and not from the
    float64 one."""
    return _Sigmoid.apply(x)


def soft_sigmoid(value, constant, lo=-16.0, hi=16.0):
    """``sigmoid(clip(value * constant, lo, hi))`` — a differentiable IF."""
    return sigmoid(clip(value * constant, lo, hi))


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
    return x - (x - clip(x, lo, hi)).detach()


def detached(x):
    """Alias for ``Tensor.detach`` to keep event code self-describing."""
    return x.detach()
