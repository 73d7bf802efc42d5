"""Fused IDM micro-lane rollout: kernel K3's forward and backward.

Port of :mod:`dhts.ops.pallas.micro_rollout`: ``T`` explicit-Euler IDM
steps of a batch of platoons ``[B, V]`` (slot ``v`` follows slot ``v + 1``;
the head sees fixed virtual-leader deltas), returning ``(posT, velT)``, and
its vector-Jacobian product with respect to ``pos0`` and ``vel0``. The six
per-vehicle parameters ``[V]`` are shared by the batch.

* :func:`micro_rollout_fwd` and :func:`micro_rollout_bwd` are the
  wrappers: on CUDA tensors each launches the hand-written kernel of
  ``csrc/micro_rollout.cu`` and counts the launch in its ``launches``, on
  CPU tensors each calls its plain version; there is no fallback from the
  card to the plain version.
* :func:`plain_micro_rollout` is the plain PyTorch version of the forward,
  :func:`dhts_torch.models.lane.micro_rollout` with every slot active, and
  the kernel's specification, op for op; :func:`plain_micro_rollout_bwd` is
  autograd through it. A speed stopped by the acceleration floor has a zero
  gradient on both sides (:mod:`dhts_torch.ops.idm`), where JAX keeps a
  rounding residue.
* :class:`MicroRolloutFunction` and :func:`make_fused_micro_rollout` (the
  JAX factory's signature, plus the device): ``fn(pos0, vel0) -> (posT,
  velT)``, differentiable in both.
* :func:`floor_hits` counts the vehicle-steps where the acceleration floor
  binds, a diagnostic of the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dhts_torch.device import resolve_device
from dhts_torch.models import lane
from dhts_torch.models.vehicle import VehicleParams
from dhts_torch.ops import arz, idm
from dhts_torch.ops.cuda import _launch

SOURCE = "dhts_torch/ops/cuda/csrc/micro_rollout.cu"
REPLACES_FWD = "dhts/ops/pallas/micro_rollout.py:123"
REPLACES_BWD = "dhts/ops/pallas/micro_rollout.py:152"
# rows of MicroConsts.params, the order the kernel reads them in
PARAM_ROWS = ("accel_max", "accel_pref", "target_speed", "min_space",
              "time_pref", "length")


class MicroConsts(NamedTuple):
    """The rollout's constants: per-vehicle parameters ``f32[6, V]`` (rows
    :data:`PARAM_ROWS`) on the rollout's device, the head's virtual-leader
    deltas, the clock and the number of steps."""

    params: torch.Tensor
    head_position_delta: float
    head_speed_delta: float
    delta_time: float
    num_steps: int

    def vehicle_params(self) -> VehicleParams:
        rows = dict(zip(PARAM_ROWS, self.params))
        return VehicleParams(**rows, a=rows["length"])

    def kernel_floats(self) -> tuple:
        f32 = lambda x: float(np.float32(x))
        return (f32(self.head_position_delta), f32(self.head_speed_delta),
                f32(self.delta_time))


def micro_consts(params: VehicleParams, head_position_delta,
                 head_speed_delta, delta_time, num_steps,
                 device) -> MicroConsts:
    """:class:`MicroConsts` from a :class:`VehicleParams` of ``[V]``
    vectors."""
    rows = torch.stack([torch.as_tensor(getattr(params, k),
                                        dtype=torch.float32).reshape(-1)
                        for k in PARAM_ROWS]).to(device).contiguous()
    return MicroConsts(rows, float(head_position_delta),
                       float(head_speed_delta), float(delta_time),
                       int(num_steps))


def plain_micro_rollout(consts: MicroConsts, pos0, vel0):
    """Plain PyTorch version of the forward: ``(posT[B, V], velT[B, V])``
    on the inputs' device."""
    V = pos0.shape[-1]
    active = torch.ones((V,), dtype=torch.bool, device=pos0.device)
    res = lane.micro_rollout(pos0, vel0, consts.vehicle_params(), active,
                             consts.head_position_delta,
                             consts.head_speed_delta, consts.delta_time,
                             consts.num_steps)
    return res.position, res.speed


def plain_micro_rollout_bwd(consts: MicroConsts, pos0, vel0, g_pT, g_vT):
    """Plain PyTorch version of the backward: autograd of
    :func:`plain_micro_rollout`, ``(g_pos0, g_vel0)``."""
    with torch.enable_grad():
        ins = [x.detach().requires_grad_(True) for x in (pos0, vel0)]
        pT, vT = plain_micro_rollout(consts, *ins)
        return torch.autograd.grad((pT, vT), ins, (g_pT, g_vT))


def floor_hits(consts: MicroConsts, pos0, vel0) -> torch.Tensor:
    """Vehicle-steps ``[B]`` of the plain rollout in which the acceleration
    floor ``-speed / dt`` binds (the vehicle stops)."""
    p = consts.vehicle_params()
    active = torch.ones(pos0.shape[-1:], dtype=torch.bool,
                        device=pos0.device)
    pos, vel = pos0, vel0
    hits = torch.zeros(pos0.shape[:-1], dtype=torch.int64,
                       device=pos0.device)
    with torch.no_grad():
        for _ in range(consts.num_steps):
            res = idm.micro_lane_step(
                pos, vel, p.accel_max, p.accel_pref, p.target_speed,
                p.min_space, p.time_pref, p.length,
                consts.head_position_delta, consts.head_speed_delta, active,
                consts.delta_time)
            floor = arz.div(-vel, consts.delta_time)
            hits += (res.acceleration == floor).sum(-1)
            pos, vel = res.position, res.speed
    return hits


# forward: pos0, vel0, params, posT, velT; backward: pos0, vel0, params,
# g_pT, g_vT, g_in; then B, T, V, three constants, the stream
_TAIL = [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
_FWD_ARGS = [ctypes.c_void_p] * 5 + _TAIL
_BWD_ARGS = [ctypes.c_void_p] * 6 + _TAIL


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' C signatures on a loaded library (the card's
    build or the host build of the same source)."""
    for fn, types in ((lib.launch_micro_rollout_fwd, _FWD_ARGS),
                      (lib.launch_micro_rollout_bwd, _BWD_ARGS)):
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    from dhts_torch.ops.cuda import _build

    lib = _build.load("micro_rollout")
    if lib.launch_micro_rollout_fwd.argtypes is None:
        bind(lib)
    return lib


def kernel_args(consts: MicroConsts, tensors, B: int, V: int,
                stream) -> tuple:
    """A launcher's arguments: ``tensors`` (``pos0, vel0``, then the
    forward's two outputs or the backward's two cotangents and its
    gradient) as pointers, with the parameters after the inputs, then the
    sizes and the constants."""
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in
            (*tensors[:2], consts.params, *tensors[2:])]
    return (*ptrs, B, int(consts.num_steps), V, *consts.kernel_floats(),
            ctypes.c_void_p(stream))


def _check_inputs(consts: MicroConsts, pos0, vel0):
    dev = pos0.device
    if pos0.dim() != 2:
        raise ValueError(f"pos0 must be [B, V], got {tuple(pos0.shape)}")
    B, V = pos0.shape
    _launch.check("pos0", pos0, (B, V), torch.float32, dev)
    _launch.check("vel0", vel0, (B, V), torch.float32, dev)
    _launch.check("params", consts.params, (len(PARAM_ROWS), V),
                  torch.float32, dev)
    return dev, B, V


def micro_rollout_fwd(consts: MicroConsts, pos0, vel0):
    """``(posT[B, V], velT[B, V])`` of ``consts.num_steps`` steps, without a
    graph for autograd (that is :class:`MicroRolloutFunction`).

    CPU tensors go to :func:`plain_micro_rollout`; CUDA tensors launch the
    kernel (one launch, one block per scenario, counted in ``launches``) or
    raise.
    """
    if _launch.device_of(pos0).type == "cpu":
        return plain_micro_rollout(consts, pos0, vel0)
    dev, B, V = _check_inputs(consts, pos0, vel0)
    posT = torch.empty((B, V), dtype=torch.float32, device=dev)
    velT = torch.empty((B, V), dtype=torch.float32, device=dev)
    err = _library().launch_micro_rollout_fwd(*kernel_args(
        consts, (pos0, vel0, posT, velT), B, V, _launch.stream(dev)))
    _launch.raise_on(err, "micro_rollout forward")
    micro_rollout_fwd.launches += 1
    return posT, velT


micro_rollout_fwd.launches = 0


def micro_rollout_bwd(consts: MicroConsts, pos0, vel0, g_pT, g_vT):
    """The cotangents ``(g_pT, g_vT)`` of ``(posT, velT)`` pulled back to
    ``(g_pos0[B, V], g_vel0[B, V])``.

    CPU tensors go to :func:`plain_micro_rollout_bwd`; CUDA tensors launch
    the backward kernel (one launch, ``2 B V`` blocks) or raise.
    """
    if _launch.device_of(pos0).type == "cpu":
        return plain_micro_rollout_bwd(consts, pos0, vel0, g_pT, g_vT)
    dev, B, V = _check_inputs(consts, pos0, vel0)
    _launch.check("g_pT", g_pT, (B, V), torch.float32, dev)
    _launch.check("g_vT", g_vT, (B, V), torch.float32, dev)
    g_in = torch.empty((B, 2 * V), dtype=torch.float32, device=dev)
    err = _library().launch_micro_rollout_bwd(*kernel_args(
        consts, (pos0, vel0, g_pT, g_vT, g_in), B, V, _launch.stream(dev)))
    _launch.raise_on(err, "micro_rollout backward")
    micro_rollout_bwd.launches += 1
    return g_in[:, :V], g_in[:, V:]


micro_rollout_bwd.launches = 0


class MicroRolloutFunction(torch.autograd.Function):
    """``apply(pos0, vel0, consts) -> (posT, velT)`` with the backward of
    :func:`micro_rollout_bwd`."""

    @staticmethod
    def forward(ctx, pos0, vel0, consts):
        posT, velT = micro_rollout_fwd(consts, pos0, vel0)
        ctx.consts = consts
        ctx.save_for_backward(pos0, vel0)
        return posT, velT

    @staticmethod
    def backward(ctx, g_pT, g_vT):
        pos0, vel0 = ctx.saved_tensors
        zero = lambda g: torch.zeros_like(pos0) if g is None else \
            g.contiguous()
        g_p, g_v = micro_rollout_bwd(ctx.consts, pos0, vel0, zero(g_pT),
                                     zero(g_vT))
        return g_p, g_v, None


def make_fused_micro_rollout(delta_time: float, num_steps: int,
                             num_vehicle: int, batch: int,
                             params: VehicleParams,
                             head_position_delta: float,
                             head_speed_delta: float, device=None):
    """Build ``fn(pos0, vel0) -> (posT, velT)`` over ``[B, V]`` tensors.

    ``params``: a :class:`VehicleParams` of per-vehicle vectors ``[V]``,
    shared by the batch. Differentiable with respect to ``pos0`` and
    ``vel0``: on the card through :class:`MicroRolloutFunction` (K3's
    forward and backward), on the CPU through the same Function around the
    plain versions. ``device`` defaults to ``cuda``.
    """
    dev = resolve_device(device)
    consts = micro_consts(params, head_position_delta, head_speed_delta,
                          delta_time, num_steps, dev)

    def state(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(
            batch, num_vehicle).contiguous()

    def fn(pos0, vel0):
        return MicroRolloutFunction.apply(state(pos0), state(vel0), consts)

    fn.consts = consts
    return fn
