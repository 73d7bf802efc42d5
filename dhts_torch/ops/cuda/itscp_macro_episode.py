"""Fused all-macro ITSCP episode: kernel K4's forward and backward.

Port of :mod:`dhts.ops.pallas.itscp_episode`: the whole episode of an
all-macro ITSCP scene (every lane ARZ, the reference's primary preset,
``run_itscp_macro.sh``) in one launch: per-step soft signal gates from the
phase action, signal-blended ghost cells, the Godunov update of every lane
and the RMS-sharpened soft queue reward, from an initial state ``(r0,
y0)``; and its vector-Jacobian product with respect to the action, ``r0``
and ``y0``.

* :func:`macro_episode_fwd` and :func:`macro_episode_bwd` are the wrappers.
  On CUDA tensors each launches the hand-written kernel of
  ``csrc/itscp_macro_episode.cu`` (built with ``nvcc`` by
  :mod:`dhts_torch.ops.cuda._build`, bound with ``ctypes``) and counts the
  launch in its ``launches``; on CPU tensors each calls its plain version.
  There is no fallback from the card to the plain version. The forward can
  save the trajectory (``trajectory=True``: the state before each step and
  each step's detached sharpness, the JAX kernel's residuals), and the
  backward is one block's reverse sweep over it, or over one it replays
  first. :func:`macro_episode_tangents` launches the forward-mode
  derivative (one block per input entry), which the tests hold the sweep
  against.
* :func:`plain_macro_episode` is the plain PyTorch version of the forward:
  K4's ``step`` (``itscp_episode.py:148-224``) and loop (``:239-249``) on
  the true sizes ``[L, C]``, and the kernel's specification, op for op.
  Sums over a lane's cells are taken in cell order in float32, sums over
  lanes in float64 rounded once, the queue sum in step order, so that the
  kernel, which sums the same way, agrees with it bit for bit.
  :func:`plain_macro_episode_bwd` is autograd through it.
* :class:`MacroEpisodeFunction` is the ``torch.autograd.Function`` around
  the two wrappers: its forward saves the trajectory when an input needs a
  gradient, and its backward is the reverse sweep over it, which gives
  the action's, ``r0``'s and ``y0``'s gradients in one launch; it returns
  the requested ones.
* :func:`make_fused_itscp_macro_episode` is the JAX package's factory, with
  the same signature (plus the device) and return value:
  ``fn(action2d, schedule, mnext, mprev, r0, y0) -> (reward, queues[T])``.

Like JAX's K4, the kernel takes soft gates of sharpness 32 whatever the
config's ``gate_mode`` and ``soft_gate_scale``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dhts_torch.device import resolve_device
from dhts_torch.ops import arz
from dhts_torch.ops.cuda import _launch
from dhts_torch.ops.dmath import maximum, soft_sigmoid
from dhts_torch.utils import rms

SOURCE = "dhts_torch/ops/cuda/csrc/itscp_macro_episode.cu"
REPLACES_FWD = "dhts/ops/pallas/itscp_episode.py:256"
REPLACES_BWD = "dhts/ops/pallas/itscp_episode.py:307"
GAMMA = 0.5
GATE = 32.0  # K4's signal-gate sharpness


class MacroEpisodePlan(NamedTuple):
    """The scene's static tables on the episode's device, and its sizes.

    ``lane_i`` rows: is_macro, num_cell, approaching, is_we, inter,
    has_prev, num_prev, num_next, prev_lanes[K], next_lanes[K]; ``lane_f``
    rows: length, cell_length; ``prog`` the host-rounded phase progress;
    ``cells`` the valid cells ``l * C + c`` in lane order."""

    lane_i: torch.Tensor
    lane_f: torch.Tensor
    prog: torch.Tensor
    cells: torch.Tensor
    cell_mask: torch.Tensor  # bool[L, C]
    T: int
    L: int
    C: int
    K: int
    nsf: int
    n_phases: int
    n_inter: int
    # u_max, dt, vehicle length, static speed, (GAMMA + 1) u_max,
    # GAMMA / (GAMMA + 1), gate sharpness: each rounded once to float32
    floats: tuple

    @property
    def n_action(self) -> int:
        return self.n_phases * self.n_inter


def make_plan(spec, meta, config, device=None) -> MacroEpisodePlan:
    """The plan of an all-macro scene (``spec``/``meta``: the port env's
    :class:`SceneSpec` and :class:`LaneMeta`; ``config``: its config)."""
    from dhts_torch.apps.control.itscp.env import signal_progress_table

    dev = torch.device(device) if device is not None else spec.device
    if not bool(spec.is_macro.all()):
        raise ValueError("the fused macro episode needs an all-macro scene "
                         "(mode='macro')")
    L, C = spec.num_lanes, spec.max_cells
    K = int(spec.next_lanes.shape[1])
    T = int(config["policy_length"] * config["duration"] *
            config["simulation_frequency"])
    nsf = int(config["simulation_frequency"] * config["signal_length"])
    n_phases = max(1, (config["policy_length"] * config["duration"]) //
                   config["signal_length"])
    n_inter = int(config["num_intersection"]) ** 2
    rows = [spec.is_macro, spec.num_cell, meta.approaching, meta.is_we,
            meta.inter, meta.has_prev, spec.num_prev, spec.num_next]
    lane_i = torch.cat([torch.stack([x.to(torch.int32) for x in rows]),
                        spec.prev_lanes.T.to(torch.int32),
                        spec.next_lanes.T.to(torch.int32)])
    lane_f = torch.stack([spec.length, spec.cell_length]).to(torch.float32)
    cell_mask = spec.cell_mask.to(torch.bool)
    cells = torch.nonzero(cell_mask.flatten())[:, 0].to(torch.int32)
    u_max = float(spec.speed_limit)
    f32 = lambda x: float(np.float32(x))
    floats = (f32(u_max), f32(1.0 / config["simulation_frequency"]),
              f32(config["vehicle_length"]), f32(config["static_speed"]),
              f32((GAMMA + 1.0) * u_max), f32(GAMMA / (GAMMA + 1.0)),
              f32(GATE))
    on = lambda x: x.to(dev).contiguous()
    return MacroEpisodePlan(
        lane_i=on(lane_i), lane_f=on(lane_f),
        prog=on(torch.as_tensor(signal_progress_table(nsf))),
        cells=on(cells), cell_mask=on(cell_mask), T=T, L=L, C=C, K=K,
        nsf=nsf, n_phases=n_phases, n_inter=n_inter, floats=floats)


class Geometry(NamedTuple):
    """The plan's per-lane tables as the plain version uses them."""

    cmask: torch.Tensor  # bool[L, C]
    last: torch.Tensor  # long[L] the lane's last cell
    approaching: torch.Tensor  # bool[L]
    is_we: torch.Tensor  # bool[L]
    inter: torch.Tensor  # long[L]
    has_prev: torch.Tensor  # bool[L]
    num_prev: torch.Tensor  # i32[L]
    num_next: torch.Tensor  # i32[L]
    prev0: torch.Tensor  # i32[L]
    next0: torch.Tensor  # i32[L]
    cell_len: torch.Tensor  # f32[L]
    prog: torch.Tensor  # f32[nsf]


def geometry(plan: MacroEpisodePlan, device) -> Geometry:
    li, lf = plan.lane_i.to(device), plan.lane_f.to(device)
    return Geometry(
        cmask=plan.cell_mask.to(device),
        last=torch.clamp(li[1] - 1, 0, plan.C - 1).long(),
        approaching=li[2] > 0, is_we=li[3] > 0, inter=li[4].long(),
        has_prev=li[5] > 0, num_prev=li[6], num_next=li[7], prev0=li[8],
        next0=li[8 + plan.K], cell_len=lf[1], prog=plan.prog.to(device))


class StepOut(NamedTuple):
    r: torch.Tensor  # f32[L, C] after the step
    y: torch.Tensor
    ms: rms.MeanState  # the static running mean after the step
    queue: torch.Tensor  # f32 scalar
    sig: torch.Tensor  # f32[L] the lanes' signals
    ghosts: tuple  # (bl_r, bl_u, br_r, br_u), f32[L] each


def plain_macro_step(plan: MacroEpisodePlan, g: Geometry, r, y, ms, t: int,
                     action2d, sched_t, mnext_t, mprev_t) -> StepOut:
    """One step of K4 (``itscp_episode.py:148-224``) on ``[L, C]``."""
    u_max, dt, veh_len, static_speed = plan.floats[:4]
    L = plan.L
    ar = torch.arange(L, device=r.device)
    clip_l = lambda x: torch.clamp(x, 0, L - 1).long()

    # signals (env.lane_signals in soft mode); the progress comes from the
    # host-rounded table
    a_lane = action2d[min(t // plan.nsf, plan.n_phases - 1)][g.inter]
    progress = g.prog[t % plan.nsf]
    gate = torch.where(g.is_we, soft_sigmoid(a_lane - progress, GATE),
                       soft_sigmoid(progress - a_lane, GATE))
    sig = torch.where(g.approaching, gate, torch.ones_like(gate))

    # edge cells of every lane
    u = arz.compute_u(r, y, u_max)
    r_last, u_last = r[ar, g.last], u[ar, g.last]
    r_first, u_first = r[:, 0], u[:, 0]

    # left ghost: schedule inflow at equilibrium speed on a source lane,
    # else the graph (one predecessor) or routed predecessor's last cell;
    # blended by the signal of the routed predecessor (0 where there is
    # none)
    adjp = torch.where(g.num_prev == 1, g.prev0, mprev_t)
    use_l = (g.num_prev > 0) & (adjp >= 0)
    hp = g.has_prev
    gl_r = torch.where(hp, torch.where(use_l, r_last[clip_l(adjp)], 0.0),
                       sched_t)
    gl_u = torch.where(hp, torch.where(use_l, u_last[clip_l(adjp)], u_max),
                       arz.compute_u_eq(sched_t, u_max))
    prev_sig = torch.where(~hp, 1.0, torch.where(mprev_t < 0, 0.0,
                                                 sig[clip_l(mprev_t)]))
    bl_r = gl_r * prev_sig
    bl_u = gl_u * prev_sig + u_max * (1.0 - prev_sig)

    # right ghost: the successor's first cell when green, a jam wall when
    # red, blended by the lane's own soft gate (sigmoid(16), not 1, on a
    # lane without a signal)
    adjn = torch.where(g.num_next == 1, g.next0, mnext_t)
    use_r = (g.num_next > 0) & (adjn >= 0)
    gr_r = torch.where(use_r, r_first[clip_l(adjn)], 0.0)
    gr_u = torch.where(use_r, u_first[clip_l(adjn)], u_max)
    s = soft_sigmoid(sig - 0.5, GATE)
    br_r = gr_r * s + 1.0 * (1.0 - s)
    br_u = gr_u * s

    # Godunov update; cells beyond num_cell pinned to the right ghost
    br_y = arz.compute_y(br_r, br_u, u_max)
    r = torch.where(g.cmask, r, br_r[:, None])
    y = torch.where(g.cmask, y, br_y[:, None])
    res = arz.godunov_step(r, y, bl_r, bl_u, br_r, br_u, u_max, dt,
                           g.cell_len)

    # RMS-sharpened soft queue reward: the running mean is detached; a
    # lane's cells are summed in cell order, the lanes in float64
    u_new = arz.compute_u(res.r, res.y, u_max)
    ms = rms.update_mean_masked(ms, static_speed - u_new, g.cmask)
    const = arz.rdiv(16.0, maximum(torch.abs(ms.total / ms.count), 1e-6))
    stat = soft_sigmoid(static_speed - u_new, const)
    q_cell = torch.where(
        g.cmask, stat * arz.div(res.r * g.cell_len[:, None], veh_len), 0.0)
    q_lane = q_cell[:, 0]
    for c in range(1, plan.C):
        q_lane = q_lane + q_cell[:, c]
    queue = torch.sum((q_lane * q_lane).to(torch.float64)).to(
        torch.float32) * dt
    return StepOut(r=res.r, y=res.y, ms=ms, queue=queue, sig=sig,
                   ghosts=(bl_r, bl_u, br_r, br_u))


def plain_macro_episode(plan: MacroEpisodePlan, action2d, schedule, mnext,
                        mprev, r0, y0):
    """Plain PyTorch version of the forward: ``(-qsum, queues[T])`` on the
    inputs' device, differentiable by autograd in ``action2d``, ``r0`` and
    ``y0``; ``qsum`` is summed in step order."""
    dev = action2d.device
    g = geometry(plan, dev)
    r, y, ms = r0, y0, rms.init_mean_state(dev)
    qsum = torch.zeros((), dtype=torch.float32, device=dev)
    queues = []
    for t in range(plan.T):
        out = plain_macro_step(plan, g, r, y, ms, t, action2d, schedule[t],
                               mnext[t], mprev[t])
        r, y, ms = out.r, out.y, out.ms
        qsum = qsum + out.queue
        queues.append(out.queue)
    return -qsum, torch.stack(queues)


class Trajectory(NamedTuple):
    """What the saving forward stores for the reverse sweep: the state
    before each step (``[T, 2, L, C]``, r then y; cells beyond a lane's
    ``num_cell`` keep ``r0``'s and ``y0``'s values, which nothing reads) and
    each step's detached sharpness ``16 / max(|mean|, 1e-6)`` (``[T]``)."""

    states: torch.Tensor
    sharpness: torch.Tensor


def new_trajectory(plan: MacroEpisodePlan, dev) -> Trajectory:
    """Uninitialised buffers of a trajectory on ``dev``."""
    return Trajectory(
        torch.empty((plan.T, 2, plan.L, plan.C), dtype=torch.float32,
                    device=dev),
        torch.empty((plan.T,), dtype=torch.float32, device=dev))


def plain_macro_trajectory(plan: MacroEpisodePlan, action2d, schedule, mnext,
                           mprev, r0, y0) -> Trajectory:
    """Plain version of the saved trajectory (the kernel stores the same
    bits)."""
    dev = action2d.device
    g = geometry(plan, dev)
    r, y, ms = r0, y0, rms.init_mean_state(dev)
    traj = new_trajectory(plan, dev)
    with torch.no_grad():
        for t in range(plan.T):
            traj.states[t, 0] = torch.where(g.cmask, r, r0)
            traj.states[t, 1] = torch.where(g.cmask, y, y0)
            out = plain_macro_step(plan, g, r, y, ms, t, action2d,
                                   schedule[t], mnext[t], mprev[t])
            r, y, ms = out.r, out.y, out.ms
            traj.sharpness[t] = arz.rdiv(16.0, maximum(torch.abs(
                ms.total / ms.count), 1e-6))
    return traj


def plain_macro_episode_bwd(plan: MacroEpisodePlan, q_weight, action2d,
                            schedule, mnext, mprev, r0, y0,
                            needs=(True, True, True)):
    """Plain PyTorch version of the backward: autograd of
    :func:`plain_macro_episode`, ``sum_t q_weight[t] d(queues[t])`` pulled
    back to ``(action2d, r0, y0)``; an input not in ``needs`` gets None."""
    with torch.enable_grad():
        ins = [x.detach().requires_grad_(bool(n))
               for x, n in zip((action2d, r0, y0), needs)]
        _, queues = plain_macro_episode(plan, ins[0], schedule, mnext, mprev,
                                        ins[1], ins[2])
        wanted = [x for x in ins if x.requires_grad]
        grads = iter(torch.autograd.grad(torch.sum(queues * q_weight),
                                         wanted, allow_unused=True,
                                         materialize_grads=True))
        return tuple(next(grads) if n else None for n in needs)


# the launchers: nine input pointers (the six inputs, prog, lane_i, lane_f),
# then the forward's outputs (reward, queues; and the trajectory's states and
# sharpness), the derivative's cells, q_weight and gradient, or the sweep's
# q_weight, trajectory and gradient; the sizes (T, L, C, K, nsf, n_phases,
# n_inter; the derivative's three seed counts, the sweep's replay flag);
# seven floats; the stream
_FLOATS = [ctypes.c_float] * 7 + [ctypes.c_void_p]
_ARGTYPES = {
    "launch_itscp_macro_episode_fwd":
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + _FLOATS,
    "launch_itscp_macro_episode_fwd_traj":
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + _FLOATS,
    "launch_itscp_macro_episode_bwd":
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + _FLOATS,
    "launch_itscp_macro_episode_reverse":
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + _FLOATS}
# the kernels of the queries: the forward, the forward-mode derivative, the
# reverse sweep
KERNEL_FWD, KERNEL_TANGENTS, KERNEL_REVERSE = 0, 1, 2


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' and the queries' C signatures on a loaded
    library (the card's build or the host build of the same source)."""
    for name, types in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    lib.itscp_macro_episode_smem.argtypes = [ctypes.c_int] * 3
    lib.itscp_macro_episode_smem.restype = ctypes.c_size_t
    lib.itscp_macro_episode_lane_threads.argtypes = [ctypes.c_int] * 5
    lib.itscp_macro_episode_lane_threads.restype = ctypes.c_int
    return lib


def lane_threads(lib: ctypes.CDLL, plan: MacroEpisodePlan,
                 kernel: int) -> int:
    """The threads a lane that ``kernel`` (``KERNEL_*``) of ``lib`` takes
    for the plan's scene; 0 where its launcher refuses the scene (the
    forward kernels: their block's threads or shared memory cannot hold
    it; the sweep: its threads)."""
    return lib.itscp_macro_episode_lane_threads(
        plan.L, plan.C, plan.n_phases, plan.n_inter, kernel)


def _library() -> ctypes.CDLL:
    from dhts_torch.ops.cuda import _build

    lib = _build.load("itscp_macro_episode")
    if lib.launch_itscp_macro_episode_fwd.argtypes is None:
        bind(lib)
    return lib


def seed_counts(plan: MacroEpisodePlan, needs) -> tuple:
    """The backward's blocks per group ``(n_a, n_r, n_y)``: every action
    entry, and every valid cell of ``r0`` and of ``y0``, where ``needs``
    asks for that input's gradient."""
    n_cells = int(plan.cells.numel())
    return tuple(n if want else 0 for n, want in
                 zip((plan.n_action, n_cells, n_cells), needs))


def kernel_args(plan: MacroEpisodePlan, inputs, outputs, stream,
                seeds=None, replay=None) -> tuple:
    """A C launcher's arguments: the six inputs, the plan's tables and the
    outputs as pointers (the forward's ``(reward, queues)`` and, saving,
    ``(states, sharpness)``; the derivative's ``(q_weight, grad)`` after
    the plan's cells; the sweep's ``(q_weight, states, sharpness, grad)``),
    the sizes, the derivative's ``seeds`` counts ``(n_a, n_r, n_y)`` or the
    sweep's ``replay`` flag, the constants."""
    tensors = (*inputs, plan.prog, plan.lane_i, plan.lane_f)
    if seeds is not None:
        tensors += (plan.cells,)
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (*tensors, *outputs)]
    ints = (plan.T, plan.L, plan.C, plan.K, plan.nsf, plan.n_phases,
            plan.n_inter, *(seeds or ()),
            *(() if replay is None else (int(replay),)))
    return (*ptrs, *ints, *plan.floats, ctypes.c_void_p(stream))


def _check_inputs(plan: MacroEpisodePlan, inputs):
    dev = _launch.device_of(inputs[0])
    T, L, C = plan.T, plan.L, plan.C
    shapes = (("action2d", (plan.n_phases, plan.n_inter), torch.float32),
              ("schedule", (T, L), torch.float32),
              ("mnext", (T, L), torch.int32), ("mprev", (T, L), torch.int32),
              ("r0", (L, C), torch.float32), ("y0", (L, C), torch.float32))
    for x, (name, shape, dtype) in zip(inputs, shapes):
        _launch.check(name, x, shape, dtype, dev)
    for name in ("lane_i", "lane_f", "prog", "cells"):
        if getattr(plan, name).device != dev:
            raise ValueError(f"plan.{name} is on "
                             f"{getattr(plan, name).device}, expected {dev}")
    return dev


def macro_episode_fwd(plan: MacroEpisodePlan, action2d, schedule, mnext,
                      mprev, r0, y0, trajectory: bool = False):
    """``(-qsum, queues[T])`` of one episode, without a graph for autograd
    (that is :class:`MacroEpisodeFunction`); ``trajectory``: also the
    :class:`Trajectory` that :func:`macro_episode_bwd` sweeps over.

    CPU tensors go to :func:`plain_macro_episode` (and
    :func:`plain_macro_trajectory`); CUDA tensors launch the kernel (one
    launch, one block, counted in ``launches``) or raise.
    """
    inputs = (action2d, schedule, mnext, mprev, r0, y0)
    if _launch.device_of(action2d).type == "cpu":
        out = plain_macro_episode(plan, *inputs)
        return (*out, plain_macro_trajectory(plan, *inputs)) if trajectory \
            else out
    dev = _check_inputs(plan, inputs)
    reward = torch.empty((), dtype=torch.float32, device=dev)
    queues = torch.empty((plan.T,), dtype=torch.float32, device=dev)
    stream = _launch.stream(dev)
    lib = _library()
    if trajectory:
        traj = new_trajectory(plan, dev)
        err = lib.launch_itscp_macro_episode_fwd_traj(*kernel_args(
            plan, inputs, (reward, queues, *traj), stream))
    else:
        err = lib.launch_itscp_macro_episode_fwd(*kernel_args(
            plan, inputs, (reward, queues), stream))
    _launch.raise_on(err, "itscp_macro_episode forward")
    macro_episode_fwd.launches += 1
    return (reward, queues, traj) if trajectory else (reward, queues)


macro_episode_fwd.launches = 0


def _grad_parts(plan: MacroEpisodePlan, grad, needs) -> tuple:
    NA, LC = plan.n_action, plan.L * plan.C
    parts = (grad[:NA].view(plan.n_phases, plan.n_inter),
             grad[NA:NA + LC].view(plan.L, plan.C),
             grad[NA + LC:].view(plan.L, plan.C))
    return tuple(p if n else None for p, n in zip(parts, needs))


def macro_episode_bwd(plan: MacroEpisodePlan, q_weight, action2d, schedule,
                      mnext, mprev, r0, y0, needs=(True, True, True),
                      traj: Trajectory | None = None):
    """``sum_t q_weight[t] d(queues[t])`` pulled back to ``(g_action2d,
    g_r0[L, C], g_y0[L, C])``; an input not in ``needs`` gets None, and
    cells beyond a lane's ``num_cell`` get exactly 0. ``traj``: the
    :class:`Trajectory` of ``macro_episode_fwd(..., trajectory=True)`` on
    these inputs.

    CPU tensors go to :func:`plain_macro_episode_bwd`; CUDA tensors launch
    the reverse sweep (one launch of one block, whatever ``needs`` asks
    for, counted in ``launches``) over ``traj`` or, without it, over a
    trajectory the same launch first replays into scratch; or raise. Its
    state lives in shared memory, or in global memory allocated for the
    launch where the scene is too large for that.
    """
    inputs = (action2d, schedule, mnext, mprev, r0, y0)
    needs = tuple(bool(n) for n in needs)
    if _launch.device_of(action2d).type == "cpu":
        return plain_macro_episode_bwd(plan, q_weight, *inputs, needs=needs)
    if not any(needs):
        return (None, None, None)
    dev = _check_inputs(plan, inputs)
    _launch.check("q_weight", q_weight, (plan.T,), torch.float32, dev)
    replay = traj is None
    if replay:
        traj = new_trajectory(plan, dev)
    else:
        _launch.check("traj.states", traj.states,
                      (plan.T, 2, plan.L, plan.C), torch.float32, dev)
        _launch.check("traj.sharpness", traj.sharpness, (plan.T,),
                      torch.float32, dev)
    grad = torch.empty((plan.n_action + 2 * plan.L * plan.C,),
                       dtype=torch.float32, device=dev)
    err = _library().launch_itscp_macro_episode_reverse(*kernel_args(
        plan, inputs, (q_weight, *traj, grad), _launch.stream(dev),
        replay=replay))
    _launch.raise_on(err, "itscp_macro_episode reverse sweep")
    macro_episode_bwd.launches += 1
    return _grad_parts(plan, grad, needs)


macro_episode_bwd.launches = 0


def macro_episode_tangents(plan: MacroEpisodePlan, q_weight, action2d,
                           schedule, mnext, mprev, r0, y0,
                           needs=(True, True, True)):
    """:func:`macro_episode_bwd`'s gradients by forward-mode tangents: one
    block of the forward body in dual numbers per action entry and per
    valid cell of each requested input (the blocks are added to
    ``blocks``), an independent derivative to hold the sweep against.

    CPU tensors go to :func:`plain_macro_episode_bwd`; CUDA tensors launch
    the kernel or raise.
    """
    inputs = (action2d, schedule, mnext, mprev, r0, y0)
    needs = tuple(bool(n) for n in needs)
    if _launch.device_of(action2d).type == "cpu":
        return plain_macro_episode_bwd(plan, q_weight, *inputs, needs=needs)
    if not any(needs):
        return (None, None, None)
    dev = _check_inputs(plan, inputs)
    _launch.check("q_weight", q_weight, (plan.T,), torch.float32, dev)
    grad = torch.zeros((plan.n_action + 2 * plan.L * plan.C,),
                       dtype=torch.float32, device=dev)
    seeds = seed_counts(plan, needs)
    err = _library().launch_itscp_macro_episode_bwd(*kernel_args(
        plan, inputs, (q_weight, grad), _launch.stream(dev), seeds))
    _launch.raise_on(err, "itscp_macro_episode forward-mode derivative")
    macro_episode_tangents.launches += 1
    macro_episode_tangents.blocks += sum(seeds)
    return _grad_parts(plan, grad, needs)


macro_episode_tangents.launches = 0
macro_episode_tangents.blocks = 0


class MacroEpisodeFunction(torch.autograd.Function):
    """``apply(action2d, r0, y0, plan, schedule, mnext, mprev) -> (reward,
    queues[T])`` with the backward of :func:`macro_episode_bwd` for the
    inputs among ``(action2d, r0, y0)`` that need a gradient: on the card
    the forward saves the trajectory and the backward sweeps over it (the
    sweep takes every scene the forward takes)."""

    @staticmethod
    def forward(ctx, action2d, r0, y0, plan, schedule, mnext, mprev):
        save = any(ctx.needs_input_grad[:3]) and \
            _launch.device_of(action2d).type != "cpu"
        out = macro_episode_fwd(plan, action2d, schedule, mnext, mprev, r0,
                                y0, trajectory=save)
        ctx.plan = plan
        ctx.saved_trajectory = save
        ctx.save_for_backward(action2d, r0, y0, schedule, mnext, mprev,
                              *(out[2] if save else ()))
        return out[0], out[1]

    @staticmethod
    def backward(ctx, g_reward, g_queues):
        action2d, r0, y0, schedule, mnext, mprev, *traj = ctx.saved_tensors
        plan = ctx.plan
        # loss cotangent per queue: reward = -sum(queues)
        w = torch.zeros((plan.T,), dtype=torch.float32,
                        device=action2d.device)
        if g_queues is not None:
            w = w + g_queues
        if g_reward is not None:
            w = w - g_reward
        grads = macro_episode_bwd(
            plan, w.contiguous(), action2d, schedule, mnext, mprev, r0, y0,
            needs=ctx.needs_input_grad[:3],
            traj=Trajectory(*traj) if ctx.saved_trajectory else None)
        return (*grads, None, None, None, None)


def make_fused_itscp_macro_episode(spec, meta, config, *, device=None):
    """Build ``fn(action2d, schedule, mnext, mprev, r0, y0) -> (reward,
    queues[T])`` for an all-macro ITSCP scene; ``reward = -sum(queues)``.

    ``spec``/``meta``: the env's SceneSpec / LaneMeta; ``config``: the env
    config dict. ``action2d``: ``[n_phases, n_inter]``;
    ``schedule``/``mnext``/``mprev``: ``[T, L]``; ``r0, y0``: ``[L, C]``.
    Differentiable with respect to ``action2d``, ``r0`` and ``y0``: on the
    card through :class:`MacroEpisodeFunction` (K4's forward and backward
    kernels), on the CPU through the same Function around the plain
    versions. ``device`` defaults to ``cuda``
    (:func:`dhts_torch.device.resolve_device`).
    """
    dev = resolve_device(device)
    plan = make_plan(spec, meta, config, dev)

    def on(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).contiguous()

    def fn(action2d, schedule, mnext, mprev, r0, y0):
        f32 = torch.float32
        return MacroEpisodeFunction.apply(
            on(action2d, f32), on(r0, f32), on(y0, f32), plan,
            on(schedule, f32), on(mnext, torch.int32),
            on(mprev, torch.int32))

    fn.plan = plan
    return fn
