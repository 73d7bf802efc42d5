"""Fused ARZ macro-lane rollout: kernel K2's forward and backward.

Port of :mod:`dhts.ops.pallas.macro_rollout`: ``T`` Godunov steps of a
batch of lanes ``[B, C]`` between constant ghost cells, returning ``(rT,
yT, max_wave)``, and its vector-Jacobian product with respect to all six
inputs.

* :func:`macro_rollout_fwd` and :func:`macro_rollout_bwd` are the
  wrappers. On CUDA tensors each launches the hand-written kernel of
  ``csrc/macro_rollout.cu`` (built with ``nvcc`` by
  :mod:`dhts_torch.ops.cuda._build`, bound with ``ctypes``) and counts the
  launch in its ``launches``; on CPU tensors each calls its plain version.
  There is no fallback from the card to the plain version.
* :func:`plain_macro_rollout` is the plain PyTorch version of the forward,
  :func:`dhts_torch.models.lane.godunov_rollout` (the loop of
  ``lane.macro_rollout`` from ``(r0, y0)``), and the kernel's specification,
  op for op. :func:`plain_macro_rollout_bwd` is autograd through it.
* :class:`MacroRolloutFunction` is the ``torch.autograd.Function`` around
  the two wrappers. The backward kernel takes forward-mode tangents from
  the forward's inputs, so the inputs are all the Function saves.
* :func:`make_fused_macro_rollout` and :func:`make_segmented_macro_rollout`
  are the JAX package's factories, with the same signatures (plus the
  device): ``fn(r0, y0, bl_r, bl_u, br_r, br_u) -> (rT, yT, max_wave)``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dhts_torch.device import resolve_device
from dhts_torch.models import lane
from dhts_torch.ops.cuda import _launch

SOURCE = "dhts_torch/ops/cuda/csrc/macro_rollout.cu"
REPLACES_FWD = "dhts/ops/pallas/macro_rollout.py:120"
REPLACES_BWD = "dhts/ops/pallas/macro_rollout.py:162"
GAMMA = 0.5


class MacroConsts(NamedTuple):
    """The rollout's constants: speed limit, clock, cell length, steps."""

    u_max: float
    delta_time: float
    cell_length: float
    num_steps: int

    def kernel_floats(self) -> tuple:
        """``(u_max, (GAMMA + 1) u_max, GAMMA / (GAMMA + 1), dt, dx)``, each
        rounded once to float32, as the plain version's Python constants
        are."""
        f32 = lambda x: float(np.float32(x))
        return (f32(self.u_max), f32((GAMMA + 1.0) * self.u_max),
                f32(GAMMA / (GAMMA + 1.0)), f32(self.delta_time),
                f32(self.cell_length))


def plain_macro_rollout(consts: MacroConsts, r0, y0, bl_r, bl_u, br_r,
                        br_u):
    """Plain PyTorch version of the forward: ``(rT[B, C], yT[B, C],
    max_wave[B])`` on the inputs' device."""
    return lane.godunov_rollout(r0, y0, bl_r, bl_u, br_r, br_u, consts.u_max,
                                consts.delta_time, consts.cell_length,
                                consts.num_steps)


def plain_macro_rollout_bwd(consts: MacroConsts, r0, y0, bl_r, bl_u, br_r,
                            br_u, g_rT, g_yT):
    """Plain PyTorch version of the backward: autograd of
    :func:`plain_macro_rollout`, the cotangents ``(g_rT, g_yT)`` pulled
    back to the six inputs."""
    with torch.enable_grad():
        ins = [x.detach().requires_grad_(True) for x in
               (r0, y0, bl_r, bl_u, br_r, br_u)]
        rT, yT, _ = plain_macro_rollout(consts, *ins)
        # br_r enters only the right-vacuum test: its gradient is 0
        return torch.autograd.grad((rT, yT), ins, (g_rT, g_yT),
                                   allow_unused=True, materialize_grads=True)


# both launchers: nine pointers (six inputs, then three outputs, or two
# cotangents and the gradient), B, T, C, five constants, the stream
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + \
    [ctypes.c_float] * 5 + [ctypes.c_void_p]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' C signatures on a loaded library (the card's
    build or the host build of the same source)."""
    for fn in (lib.launch_macro_rollout_fwd, lib.launch_macro_rollout_bwd):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    from dhts_torch.ops.cuda import _build

    lib = _build.load("macro_rollout")
    if lib.launch_macro_rollout_fwd.argtypes is None:
        bind(lib)
    return lib


def kernel_args(consts: MacroConsts, tensors, B: int, C: int,
                stream) -> tuple:
    """A launcher's arguments: ``tensors`` (the six inputs, then the
    forward's three outputs or the backward's two cotangents and its
    gradient) as pointers, the sizes and the constants."""
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in tensors]
    return (*ptrs, B, int(consts.num_steps), C, *consts.kernel_floats(),
            ctypes.c_void_p(stream))


def _check_inputs(inputs):
    r0 = inputs[0]
    dev = r0.device
    if r0.dim() != 2:
        raise ValueError(f"r0 must be [B, C], got shape {tuple(r0.shape)}")
    B, C = r0.shape
    names = ("r0", "y0", "bl_r", "bl_u", "br_r", "br_u")
    shapes = ((B, C), (B, C), (B,), (B,), (B,), (B,))
    for name, x, shape in zip(names, inputs, shapes):
        _launch.check(name, x, shape, torch.float32, dev)
    return dev, B, C


def macro_rollout_fwd(consts: MacroConsts, r0, y0, bl_r, bl_u, br_r, br_u):
    """``(rT[B, C], yT[B, C], max_wave[B])`` of ``consts.num_steps`` steps,
    without a graph for autograd (that is :class:`MacroRolloutFunction`).

    CPU tensors go to :func:`plain_macro_rollout`; CUDA tensors launch the
    kernel (one launch, one block per scenario, counted in ``launches``) or
    raise.
    """
    inputs = (r0, y0, bl_r, bl_u, br_r, br_u)
    if _launch.device_of(r0).type == "cpu":
        return plain_macro_rollout(consts, *inputs)
    dev, B, C = _check_inputs(inputs)
    rT = torch.empty((B, C), dtype=torch.float32, device=dev)
    yT = torch.empty((B, C), dtype=torch.float32, device=dev)
    max_wave = torch.empty((B,), dtype=torch.float32, device=dev)
    err = _library().launch_macro_rollout_fwd(*kernel_args(
        consts, (*inputs, rT, yT, max_wave), B, C, _launch.stream(dev)))
    _launch.raise_on(err, "macro_rollout forward")
    macro_rollout_fwd.launches += 1
    return rT, yT, max_wave


macro_rollout_fwd.launches = 0


def macro_rollout_bwd(consts: MacroConsts, r0, y0, bl_r, bl_u, br_r, br_u,
                      g_rT, g_yT):
    """The cotangents ``(g_rT, g_yT)`` of ``(rT, yT)`` pulled back to
    ``(g_r0[B, C], g_y0[B, C], g_bl_r[B], g_bl_u[B], g_br_r[B],
    g_br_u[B])``.

    CPU tensors go to :func:`plain_macro_rollout_bwd`; CUDA tensors launch
    the backward kernel (one launch, one block per scenario and input
    entry, ``B (2C + 4)``) or raise.
    """
    inputs = (r0, y0, bl_r, bl_u, br_r, br_u)
    if _launch.device_of(r0).type == "cpu":
        return plain_macro_rollout_bwd(consts, *inputs, g_rT, g_yT)
    dev, B, C = _check_inputs(inputs)
    _launch.check("g_rT", g_rT, (B, C), torch.float32, dev)
    _launch.check("g_yT", g_yT, (B, C), torch.float32, dev)
    g_in = torch.empty((B, 2 * C + 4), dtype=torch.float32, device=dev)
    err = _library().launch_macro_rollout_bwd(*kernel_args(
        consts, (*inputs, g_rT, g_yT, g_in), B, C, _launch.stream(dev)))
    _launch.raise_on(err, "macro_rollout backward")
    macro_rollout_bwd.launches += 1
    return (g_in[:, :C], g_in[:, C:2 * C], g_in[:, 2 * C],
            g_in[:, 2 * C + 1], g_in[:, 2 * C + 2], g_in[:, 2 * C + 3])


macro_rollout_bwd.launches = 0


class MacroRolloutFunction(torch.autograd.Function):
    """``apply(r0, y0, bl_r, bl_u, br_r, br_u, consts) -> (rT, yT,
    max_wave)`` with the backward of :func:`macro_rollout_bwd`; all six
    inputs get gradients, ``max_wave`` (a CFL diagnostic) carries none, as in
    the JAX kernel's custom VJP."""

    @staticmethod
    def forward(ctx, r0, y0, bl_r, bl_u, br_r, br_u, consts):
        rT, yT, max_wave = macro_rollout_fwd(consts, r0, y0, bl_r, bl_u,
                                             br_r, br_u)
        ctx.consts = consts
        ctx.save_for_backward(r0, y0, bl_r, bl_u, br_r, br_u)
        ctx.mark_non_differentiable(max_wave)
        return rT, yT, max_wave

    @staticmethod
    def backward(ctx, g_rT, g_yT, g_wave):
        inputs = ctx.saved_tensors
        zero = lambda g: torch.zeros_like(inputs[0]) if g is None else \
            g.contiguous()
        grads = macro_rollout_bwd(ctx.consts, *inputs, zero(g_rT),
                                  zero(g_yT))
        return (*grads, None)


def make_fused_macro_rollout(u_max: float, delta_time: float,
                             cell_length: float, num_steps: int,
                             num_cell: int, batch: int, device=None):
    """Build ``fn(r0, y0, bl_r, bl_u, br_r, br_u) -> (rT, yT, max_wave)``.

    ``r0, y0``: ``[B, C]`` per-scenario cell states; the ghost values are
    scalars or ``[B]``. Returns the final ``[B, C]`` states and each
    scenario's largest wave speed (the CFL diagnostic, ``[B]``).
    Differentiable with respect to all six inputs: on the card through
    :class:`MacroRolloutFunction` (K2's forward and backward), on the CPU
    through the same Function around the plain versions. ``device``
    defaults to ``cuda`` (:func:`dhts_torch.device.resolve_device`).
    """
    dev = resolve_device(device)
    consts = MacroConsts(float(u_max), float(delta_time), float(cell_length),
                         int(num_steps))

    def state(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(
            batch, num_cell).contiguous()

    def row(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(
            -1).expand(batch).contiguous()

    def fn(r0, y0, bl_r, bl_u, br_r, br_u):
        return MacroRolloutFunction.apply(
            state(r0), state(y0), row(bl_r), row(bl_u), row(br_r), row(br_u),
            consts)

    fn.consts = consts
    return fn


def make_segmented_macro_rollout(u_max: float, delta_time: float,
                                 cell_length: float, num_steps: int,
                                 num_cell: int, batch: int, chunk: int = 128,
                                 device=None):
    """The rollout as a loop of fused ``chunk``-step launches plus one
    launch for the remainder; the values equal one fused call's bit for
    bit. The JAX package segments to fit the trajectory into VMEM; the
    port's backward keeps no trajectory, so its memory is O(C B) at any
    horizon either way, and each chunk's Function keeps only its inputs."""
    n_full, rem = divmod(int(num_steps), int(chunk))
    make = lambda steps: make_fused_macro_rollout(
        u_max, delta_time, cell_length, steps, num_cell, batch, device)
    full_fn = make(chunk) if n_full else None
    rem_fn = make(rem) if rem else None
    dev = resolve_device(device)

    def fn(r0, y0, bl_r, bl_u, br_r, br_u):
        r, y = r0, y0
        max_wave = torch.zeros((batch,), dtype=torch.float32, device=dev)
        for step_fn in [full_fn] * n_full + ([rem_fn] if rem_fn else []):
            r, y, chunk_wave = step_fn(r, y, bl_r, bl_u, br_r, br_u)
            max_wave = torch.maximum(max_wave, chunk_wave)
        return r, y, max_wave

    return fn
