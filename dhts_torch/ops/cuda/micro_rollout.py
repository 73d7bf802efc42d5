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
  card to the plain version. Up to :data:`WARP_VEHICLES` vehicles the
  kernels run a platoon in one warp: the forward can save the trajectory
  ``[B, T, 2, V]`` (``trajectory=True``) and the backward is a reverse
  sweep over it, or over one the same launch replays first; wider platoons
  take PR 6's shared-memory forward and forward-mode backward.
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
  binds, a diagnostic of the plain version; :func:`plain_micro_trajectory`
  is the plain version of the saved trajectory.
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
WARP_VEHICLES = 32  # the most vehicles of the warp kernels
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


def _plain_steps(consts: MicroConsts, pos0, vel0):
    """The plain version's steps: ``(position, speed, result)`` of each,
    the state before the step and its :func:`idm.micro_lane_step`."""
    p = consts.vehicle_params()
    active = torch.ones(pos0.shape[-1:], dtype=torch.bool,
                        device=pos0.device)
    pos, vel = pos0, vel0
    for _ in range(consts.num_steps):
        res = idm.micro_lane_step(
            pos, vel, p.accel_max, p.accel_pref, p.target_speed,
            p.min_space, p.time_pref, p.length, consts.head_position_delta,
            consts.head_speed_delta, active, consts.delta_time)
        yield pos, vel, res
        pos, vel = res.position, res.speed


def floor_hits(consts: MicroConsts, pos0, vel0) -> torch.Tensor:
    """Vehicle-steps ``[B]`` of the plain rollout in which the acceleration
    floor ``-speed / dt`` binds (the vehicle stops)."""
    hits = torch.zeros(pos0.shape[:-1], dtype=torch.int64,
                       device=pos0.device)
    with torch.no_grad():
        for _, vel, res in _plain_steps(consts, pos0, vel0):
            floor = arz.div(-vel, consts.delta_time)
            hits += (res.acceleration == floor).sum(-1)
    return hits


def plain_micro_trajectory(consts: MicroConsts, pos0, vel0) -> torch.Tensor:
    """Plain version of the saved trajectory: ``[B, T, 2, V]``, the
    positions and speeds before each step."""
    B, V = pos0.shape
    with torch.no_grad():
        rows = [torch.stack((pos, vel), 1)
                for pos, vel, _ in _plain_steps(consts, pos0, vel0)]
    if not rows:
        return pos0.new_empty((B, 0, 2, V))
    return torch.stack(rows, 1)


# each launcher's pointers (pos0, vel0, params, then the forward's posT,
# velT or the backward's g_pT, g_vT, g_in, then a trajectory), then B, T,
# V, three constants, the stream
_TAIL = [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
LAUNCHERS = {"launch_micro_rollout_fwd": 5,
             "launch_micro_rollout_fwd_save": 6,
             "launch_micro_rollout_fwd_smem": 5,
             "launch_micro_rollout_bwd": 6,
             "launch_micro_rollout_bwd_saved": 7,
             "launch_micro_rollout_bwd_replay": 7}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' C signatures on a loaded library (the card's
    build or the host build of the same source); a launcher the library
    lacks (an older tree's) is left out."""
    for name, n_ptr in LAUNCHERS.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + _TAIL
            fn.restype = ctypes.c_int
    return lib


def div_check(lib, a, b, rounded: bool, stream=0):
    """The warp kernels' checked division on float32 tensors ``a``, ``b``
    (one device, contiguous) through ``lib``'s test launcher: ``(q, ok)``,
    ``ok`` where the check accepted ``q`` (elsewhere the kernels divide);
    its reciprocal of ``b`` rounded once (``rounded``, a constant
    divisor's) or approximate (the gap's)."""
    fn = lib.launch_micro_rollout_div_check
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    q = torch.empty_like(a)
    ok = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    _launch.raise_on(fn(ptr(a), ptr(b), ptr(q), ptr(ok), a.numel(),
                        int(rounded), ctypes.c_void_p(stream)), "div_check")
    return q, ok.bool()


def launch_checked(lib, name: str, consts, tensors, B: int, V: int,
                   stream) -> None:
    """Call launcher ``name`` of ``lib`` on ``tensors`` (see
    :func:`kernel_args`) and raise on its error."""
    _launch.raise_on(getattr(lib, name)(*kernel_args(consts, tensors, B, V,
                                                     stream)), name)


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
    gradient, then the trajectory where the launcher takes one; None for a
    null pointer) as pointers, with the parameters after the inputs, then
    the sizes and the constants."""
    ptrs = [ctypes.c_void_p(None if x is None else x.data_ptr()) for x in
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


def micro_rollout_fwd(consts: MicroConsts, pos0, vel0,
                      trajectory: bool = False):
    """``(posT[B, V], velT[B, V])`` of ``consts.num_steps`` steps, without a
    graph for autograd (that is :class:`MicroRolloutFunction`);
    ``trajectory``: also the trajectory ``[B, T, 2, V]`` that
    :func:`micro_rollout_bwd` sweeps, saved on CUDA tensors up to
    :data:`WARP_VEHICLES` vehicles and None elsewhere, whose backwards read
    none.

    CPU tensors go to :func:`plain_micro_rollout`; CUDA tensors launch the
    kernel (one launch, one warp per scenario up to 32 vehicles, else one
    block, counted in ``launches``) or raise.
    """
    if _launch.device_of(pos0).type == "cpu":
        out = plain_micro_rollout(consts, pos0, vel0)
        return (*out, None) if trajectory else out
    dev, B, V = _check_inputs(consts, pos0, vel0)
    posT = torch.empty((B, V), dtype=torch.float32, device=dev)
    velT = torch.empty((B, V), dtype=torch.float32, device=dev)
    lib, stream = _library(), _launch.stream(dev)
    traj = None
    if trajectory and V <= WARP_VEHICLES:
        traj = torch.empty((B, consts.num_steps, 2, V), dtype=torch.float32,
                           device=dev)
        err = lib.launch_micro_rollout_fwd_save(*kernel_args(
            consts, (pos0, vel0, posT, velT, traj), B, V, stream))
    else:
        err = lib.launch_micro_rollout_fwd(*kernel_args(
            consts, (pos0, vel0, posT, velT), B, V, stream))
    _launch.raise_on(err, "micro_rollout forward")
    micro_rollout_fwd.launches += 1
    return (posT, velT, traj) if trajectory else (posT, velT)


micro_rollout_fwd.launches = 0


def micro_rollout_bwd(consts: MicroConsts, pos0, vel0, g_pT, g_vT,
                      traj=None):
    """The cotangents ``(g_pT, g_vT)`` of ``(posT, velT)`` pulled back to
    ``(g_pos0[B, V], g_vel0[B, V])``; ``traj``: the trajectory
    ``micro_rollout_fwd(..., trajectory=True)`` returned for these inputs.

    CPU tensors go to :func:`plain_micro_rollout_bwd`. CUDA tensors launch
    one kernel (counted in ``launches``) or raise: up to
    :data:`WARP_VEHICLES` vehicles the reverse sweep, one warp per scenario,
    over ``traj`` or, without it, over a trajectory the launch replays
    first into scratch; above, the forward-mode backward (``2 B V``
    blocks), which reads no trajectory.
    """
    if _launch.device_of(pos0).type == "cpu":
        return plain_micro_rollout_bwd(consts, pos0, vel0, g_pT, g_vT)
    dev, B, V = _check_inputs(consts, pos0, vel0)
    _launch.check("g_pT", g_pT, (B, V), torch.float32, dev)
    _launch.check("g_vT", g_vT, (B, V), torch.float32, dev)
    g_in = torch.empty((B, 2 * V), dtype=torch.float32, device=dev)
    lib, stream, T = _library(), _launch.stream(dev), consts.num_steps
    tensors = (pos0, vel0, g_pT, g_vT, g_in)
    if V > WARP_VEHICLES:
        if traj is not None:
            raise ValueError(f"no trajectory is read above {WARP_VEHICLES} "
                             f"vehicles (V = {V})")
        err = lib.launch_micro_rollout_bwd(*kernel_args(
            consts, tensors, B, V, stream))
    elif traj is not None:
        _launch.check("traj", traj, (B, T, 2, V), torch.float32, dev)
        err = lib.launch_micro_rollout_bwd_saved(*kernel_args(
            consts, (*tensors, traj), B, V, stream))
    else:
        scratch = torch.empty((B, T, 2, V), dtype=torch.float32, device=dev)
        err = lib.launch_micro_rollout_bwd_replay(*kernel_args(
            consts, (*tensors, scratch), B, V, stream))
    _launch.raise_on(err, "micro_rollout backward")
    micro_rollout_bwd.launches += 1
    return g_in[:, :V], g_in[:, V:]


micro_rollout_bwd.launches = 0


class MicroRolloutFunction(torch.autograd.Function):
    """``apply(pos0, vel0, consts) -> (posT, velT)`` with the backward of
    :func:`micro_rollout_bwd`; when autograd will ask for a gradient, the
    forward saves the trajectory the backward sweeps."""

    @staticmethod
    def forward(ctx, pos0, vel0, consts):
        save = any(ctx.needs_input_grad[:2])
        out = micro_rollout_fwd(consts, pos0, vel0, trajectory=save)
        ctx.consts = consts
        ctx.save_for_backward(pos0, vel0, out[2] if save else None)
        return out[:2]

    @staticmethod
    def backward(ctx, g_pT, g_vT):
        pos0, vel0, traj = ctx.saved_tensors
        zero = lambda g: torch.zeros_like(pos0) if g is None else \
            g.contiguous()
        g_p, g_v = micro_rollout_bwd(ctx.consts, pos0, vel0, zero(g_pT),
                                     zero(g_vT), traj=traj)
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
