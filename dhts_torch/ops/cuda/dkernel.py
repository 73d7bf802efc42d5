"""Differentiable kernel ops: the port's counterpart of kernel K5,
:func:`dhts.ops.pallas.dkernel.make_dkernel`.

The JAX package wraps a plain jnp ``body`` as one single-block Pallas call
with a ``jax.custom_vjp`` whose backward is a second Pallas call that
recomputes the body and transposes it (``pallas_call`` at ``dkernel.py:63``
and ``:91``). Here the same three parts are held by one
``torch.autograd.Function`` template:

* ``forward(*args)``: the CUDA forward launcher;
* ``derivative(args, cotangents)``: the CUDA derivative launcher, which
  returns the gradients of the listed float inputs;
* ``body(*args)``: the plain PyTorch version, which the tests call directly
  (``op.body``, as the JAX package exposes ``op.body``) and which the op
  runs on CPU tensors, differentiated by autograd.

Integer inputs and outputs carry no gradient; only the inputs at
``diff_argnums`` receive one, and every float output contributes a
cotangent (``diff_argnums`` and the ``float0`` handling of the JAX
version), except the float outputs at ``nondiff_outputs``: these are
diagnostics the derivative does not differentiate, returned without a
gradient (``requires_grad`` false), so that a loss built on them fails
instead of receiving a silent zero. The derivative launcher chooses its
own method: the fused spatial step's is forward mode over a whole episode
(:mod:`dhts_torch.ops.cuda.itscp_spatial_step`, and over the lane-sharded
bodies in :mod:`dhts_torch.ops.cuda.itscp_spatial_shard`). An op whose
plain version crosses ``torch.distributed`` calls cannot be differentiated
by autograd; ``body_autograd=False`` makes it the ``autograd.Function`` on
every device, its derivative launcher choosing the plain forward-mode
version on CPU tensors.

:func:`make_kernel_sg` is the stop-gradient op (``dkernel.py:127-161``,
``pallas_call`` at ``:154``) that JAX puts around the sharded step's wholly
discrete phases D1 and D2: float inputs and outputs are detached, CUDA
tensors launch the kernel, CPU tensors run the plain body; there is no
backward. The port's sharded step needs it no more: D3's launch does D1's
and D2's work (:mod:`dhts_torch.ops.cuda.itscp_spatial_shard`).
"""

from __future__ import annotations

import torch


def _device_type(args) -> str:
    for x in args:
        if isinstance(x, torch.Tensor):
            return x.device.type
    raise TypeError("a kernel op needs at least one tensor argument")


def make_dkernel(body, forward, derivative, diff_argnums, name="dkernel",
                 nondiff_outputs=(), body_autograd=True):
    """Wrap ``body`` as a differentiable op: ``op(*args) -> tuple``.

    On CPU tensors the op is ``body`` (autograd differentiates it; the body
    detaches its outputs at ``nondiff_outputs`` itself), unless
    ``body_autograd`` is false. On CUDA tensors, and on every device when
    ``body_autograd`` is false, it is a ``torch.autograd.Function``
    (``op.function``) whose forward calls ``forward(*args)`` and whose
    backward calls ``derivative(args, float_cotangents)`` with one
    cotangent per differentiable float output (zeros where autograd has
    none) and places its results at ``diff_argnums``; ``forward`` and
    ``derivative`` then serve CPU tensors themselves.
    """
    diff_argnums = tuple(diff_argnums)
    nondiff_outputs = frozenset(nondiff_outputs)

    class Op(torch.autograd.Function):

        @staticmethod
        def forward(ctx, *args):
            outs = tuple(forward(*args))
            for i in diff_argnums:
                if not args[i].is_floating_point():
                    raise TypeError(f"{name}: input {i} is listed for a "
                                    f"gradient but is {args[i].dtype}")
            ctx.save_for_backward(*args)
            ctx.diff_out = [o.is_floating_point() and i not in nondiff_outputs
                            for i, o in enumerate(outs)]
            ctx.mark_non_differentiable(
                *[o for o, f in zip(outs, ctx.diff_out) if not f])
            return outs

        @staticmethod
        def backward(ctx, *cots):
            args = ctx.saved_tensors
            f_cots = tuple(c for c, f in zip(cots, ctx.diff_out) if f)
            grads = derivative(args, f_cots)
            out = [None] * len(args)
            for i, g in zip(diff_argnums, grads):
                out[i] = g
            return tuple(out)

    Op.__name__ = Op.__qualname__ = name

    def op(*args):
        if body_autograd and _device_type(args) == "cpu":
            return tuple(body(*args))
        return Op.apply(*args)

    op.body = body
    op.function = Op
    return op


def make_kernel_sg(body, forward, name="kernel_sg"):
    """Wrap a wholly discrete ``body`` as a stop-gradient op: ``op(*args)
    -> tuple``. Float inputs are detached; CPU tensors run ``body(*args)``,
    CUDA tensors ``forward(*args)`` (the kernel's launcher); float outputs
    are returned detached. There is no backward: nothing upstream of the
    op receives a gradient through it."""

    def op(*args):
        args = tuple(x.detach() if isinstance(x, torch.Tensor) else x
                     for x in args)
        with torch.no_grad():
            outs = tuple(body(*args) if _device_type(args) == "cpu"
                         else forward(*args))
        return tuple(o.detach() for o in outs)

    op.__name__ = op.__qualname__ = name
    op.body = body
    op.forward = forward
    return op
