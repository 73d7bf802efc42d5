"""Fused ITSCP hybrid episode: kernel K1's forward and backward.

Port of :mod:`dhts.ops.pallas.itscp_hybrid_episode`: a whole ITSCP episode
of a hybrid, micro or macro scene from the empty network state, returning
``(-sum(queues), queues[T], events[T, 8])``, in hard, soft or
straight-through (``st``) gate mode, and its gradient with respect to the
action.

* :func:`itscp_hybrid_episode_fwd` is the forward's wrapper (any gate
  mode) and :func:`itscp_hybrid_episode_bwd` the backward's. On CUDA
  tensors each launches the hand-written kernel of
  ``csrc/itscp_hybrid_episode.cu`` (built with ``nvcc`` by
  :mod:`dhts_torch.ops.cuda._build`, bound with ``ctypes``) and counts the
  launch in its ``launches`` (the forward's per gate mode); on CPU tensors
  each calls its plain version. There is no fallback from the card to the
  plain version.
* :func:`plain_episode` is the plain PyTorch version of the forward: the
  eager ``boundary_and_step`` of :mod:`dhts_torch.apps.control.itscp.env`
  in a Python loop over T, each step vectorised over lanes, cells and
  vehicles. It is the kernel's specification, op for op.
  :func:`plain_episode_bwd` is the backward's: PyTorch autograd through it.
* :class:`FusedEpisodeFunction` is the ``torch.autograd.Function`` of the
  differentiable episode on the card: its forward launches the soft/``st``
  forward, its backward the backward kernel. The backward takes forward-mode
  tangents (one block per action entry) and needs only the forward's
  inputs, so they are what the Function saves.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dhts_torch.models.vehicle import default_params
from dhts_torch.ops.cuda._launch import check as _check
from dhts_torch.ops.cuda._launch import device_of as _device_of
from dhts_torch.ops.cuda._launch import stream as _stream

SOURCE = "dhts_torch/ops/cuda/csrc/itscp_hybrid_episode.cu"
REPLACES_FWD = "dhts/ops/pallas/itscp_hybrid_episode.py:2130"
REPLACES_BWD = "dhts/ops/pallas/itscp_hybrid_episode.py:2244"
GAMMA = 0.5
HARD, SOFT, ST = 0, 1, 2  # gate modes of the kernel


def leader_window(is_macro, routes) -> int:
    """Tight leader-search window: the route walk ends at a macro lane, the
    route end or an occupied micro lane, so it looks at most ``max
    consecutive micro-lane run + 1`` entries ahead. ``routes``: any int
    array whose last axis is route entries (lane ids, -1 padded)."""
    is_macro = np.asarray(is_macro).astype(bool)
    entries = np.asarray(routes).reshape(-1, np.asarray(routes).shape[-1])
    micro = np.zeros(entries.shape, bool)
    valid = entries >= 0
    micro[valid] = ~is_macro[entries[valid]]
    if micro.size == 0:
        return 1
    c = np.cumsum(micro, axis=1)
    latched = np.maximum.accumulate(np.where(micro, 0, c), axis=1)
    return int((c - latched).max()) + 1


class EpisodePlan(NamedTuple):
    """Static inputs of one scene: the geometry tables the kernel reads,
    the sizes and constants, and the scene itself for the plain version."""

    spec: object  # dhts_torch.models.scene.SceneSpec
    meta: object  # dhts_torch.apps.control.itscp.env.LaneMeta
    config: dict
    lane_i: torch.Tensor  # i32[8 + 2K, L]
    lane_f: torch.Tensor  # f32[2, L]
    prog: torch.Tensor  # f32[nsf] phase progress table
    T: int
    L: int
    C: int
    V: int
    R: int
    P: int
    P2: int
    K: int
    W: int
    nsf: int
    n_phases: int
    n_inter: int
    mode: int  # HARD, SOFT or ST
    floats: tuple  # the kernel's float arguments, in order


def make_plan(spec, meta, config, V: int, R: int, P: int, P_emit: int,
              window: int | None = None,
              differentiable: bool = False) -> EpisodePlan:
    from dhts_torch.apps.control.itscp.env import signal_progress_table

    dev = spec.device
    L, C = spec.num_lanes, spec.max_cells
    K = int(spec.next_lanes.shape[1])
    T = int(config["policy_length"] * config["duration"] *
            config["simulation_frequency"])
    nsf = int(config["simulation_frequency"] * config["signal_length"])
    n_phases = max(1, (config["policy_length"] * config["duration"]) //
                   config["signal_length"])
    n_inter = int(config["num_intersection"]) ** 2
    W = R - 1 if window is None else max(1, min(int(window), R - 1))
    rows = [spec.is_macro, spec.num_cell, meta.approaching, meta.is_we,
            meta.inter, meta.has_prev, spec.num_prev, spec.num_next]
    lane_i = torch.cat([torch.stack([x.to(torch.int32) for x in rows]),
                        spec.prev_lanes.T.to(torch.int32),
                        spec.next_lanes.T.to(torch.int32)]).contiguous()
    lane_f = torch.stack([spec.length, spec.cell_length]).to(
        torch.float32).contiguous()
    u_max = float(spec.speed_limit)
    veh_len = float(config["vehicle_length"])
    f32 = lambda x: float(np.float32(x))
    dflt = default_params(u_max, (), veh_len)
    floats = (f32(u_max), f32(1.0 / config["simulation_frequency"]),
              f32(veh_len), f32(config["static_speed"]),
              f32((GAMMA + 1.0) * u_max), f32(GAMMA / (GAMMA + 1.0)),
              float(dflt.accel_max), float(dflt.accel_pref),
              float(dflt.target_speed), float(dflt.min_space),
              float(dflt.time_pref), f32(1.0 - 1e-5),
              f32(32.0 * float(config.get("soft_gate_scale", 1.0))))
    mode = HARD
    if differentiable:
        mode = ST if str(config.get("gate_mode", "soft")) == "st" else SOFT
    return EpisodePlan(
        spec=spec, meta=meta, config=dict(config), lane_i=lane_i,
        lane_f=lane_f,
        prog=torch.as_tensor(signal_progress_table(nsf), device=dev),
        T=T, L=L, C=C, V=int(V), R=int(R), P=int(P), P2=int(P_emit), K=K,
        W=W, nsf=nsf, n_phases=n_phases, n_inter=n_inter, mode=mode,
        floats=floats)


def plain_episode(plan: EpisodePlan, action2d, schedule, mnext, mprev, rand,
                  inj_routes, emit_routes):
    """Plain PyTorch version of the forward in ``plan.mode``: ``(-qsum,
    queues[T], events[T, 8])`` on the inputs' device, differentiable by
    autograd in the soft modes."""
    from dhts_torch.apps.control.itscp import env as env_mod
    from dhts_torch.models import network

    run = env_mod._make_episode_fn(plan.spec, plan.meta, plan.config,
                                   plan.mode != HARD).run
    state0 = network.empty_state(plan.spec, plan.V, plan.R, emit_routes)
    data = env_mod.EpisodeData(schedule=schedule, mroute_next=mnext,
                               mroute_prev=mprev, inj_routes=inj_routes)
    queues, events = run(action2d, data, state0, rand)
    return -torch.sum(queues), queues, events


def plain_episode_bwd(plan: EpisodePlan, q_weight, action2d, *inputs):
    """Plain PyTorch version of the backward: ``sum_t q_weight[t] *
    d(queues[t])/d(action2d)`` by autograd through :func:`plain_episode`."""
    with torch.enable_grad():
        a = action2d.detach().requires_grad_(True)
        _, queues, _ = plain_episode(plan, a, *inputs)
        (grad,) = torch.autograd.grad(torch.sum(queues * q_weight), a)
    return grad


_PTRS_FWD, _PTRS_BWD = 13, 12  # pointer arguments of the two launchers
_TAIL = [ctypes.c_int] * 13 + [ctypes.c_float] * 13 + [ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * _PTRS_FWD + _TAIL
_ARGTYPES_BWD = [ctypes.c_void_p] * _PTRS_BWD + _TAIL


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' C signatures on a loaded library (the card's
    build or the host build of the same source)."""
    for fn, types in ((lib.launch_itscp_hybrid_episode_fwd, _ARGTYPES),
                      (lib.launch_itscp_hybrid_episode_bwd, _ARGTYPES_BWD)):
        fn.argtypes = types
        fn.restype = ctypes.c_int
    lib.itscp_hybrid_episode_smem.argtypes = [ctypes.c_int] * 5
    lib.itscp_hybrid_episode_smem.restype = ctypes.c_size_t
    return lib


def _library() -> ctypes.CDLL:
    from dhts_torch.ops.cuda import _build

    lib = _build.load("itscp_hybrid_episode")
    if lib.launch_itscp_hybrid_episode_fwd.argtypes is None:
        bind(lib)
    return lib


def kernel_args(plan: EpisodePlan, inputs, outputs, stream) -> tuple:
    """A C launcher's arguments: the seven inputs of the episode, the plan's
    tables and the outputs as pointers, then the plan's sizes, gate mode and
    constants. The forward's outputs are ``(reward, queues, events)``, the
    backward's ``(q_weight, grad)``."""
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in
            (*inputs, plan.prog, plan.lane_i, plan.lane_f, *outputs)]
    ints = (plan.T, plan.L, plan.C, plan.V, plan.R, plan.P, plan.P2, plan.K,
            plan.W, plan.nsf, plan.n_phases, plan.n_inter, plan.mode)
    return (*ptrs, *ints, *plan.floats, ctypes.c_void_p(stream))


def _check_inputs(plan: EpisodePlan, inputs):
    action2d = inputs[0]
    dev = action2d.device
    T, L, R = plan.T, plan.L, plan.R
    shapes = (("action2d", (plan.n_phases, plan.n_inter), torch.float32),
              ("schedule", (T, L), torch.float32),
              ("mnext", (T, L), torch.int32), ("mprev", (T, L), torch.int32),
              ("rand", (T, L), torch.float32),
              ("inj_routes", (L, plan.P, R), torch.int32),
              ("emit_routes", (L, plan.P2, R), torch.int32))
    for x, (name, shape, dtype) in zip(inputs, shapes):
        _check(name, x, shape, dtype, dev)
    for name in ("lane_i", "lane_f", "prog"):
        if getattr(plan, name).device != dev:
            raise ValueError(f"plan.{name} is on "
                             f"{getattr(plan, name).device}, expected {dev}")
    return dev


def _launch_fwd(plan: EpisodePlan, inputs):
    dev = _check_inputs(plan, inputs)
    lib = _library()
    T = plan.T
    reward = torch.empty((), dtype=torch.float32, device=dev)
    queues = torch.empty((T,), dtype=torch.float32, device=dev)
    events = torch.empty((T, 8), dtype=torch.float32, device=dev)
    err = lib.launch_itscp_hybrid_episode_fwd(
        *kernel_args(plan, inputs, (reward, queues, events), _stream(dev)))
    if err != 0:
        raise RuntimeError(f"itscp_hybrid_episode forward launch failed: "
                           f"CUDA error {err}")
    return reward, queues, events


def itscp_hybrid_episode_fwd(plan: EpisodePlan, action2d, schedule, mnext,
                             mprev, rand, inj_routes, emit_routes):
    """``(-qsum, queues[T], events[T, 8])`` of one episode in ``plan.mode``
    (hard, soft or straight-through), without a graph for autograd (that is
    :class:`FusedEpisodeFunction`).

    CPU tensors go to :func:`plain_episode`; CUDA tensors launch the kernel
    (one launch per episode, counted in ``launches[plan.mode]``) or raise.
    """
    inputs = (action2d, schedule, mnext, mprev, rand, inj_routes,
              emit_routes)
    if _device_of(action2d).type == "cpu":
        return plain_episode(plan, *inputs)
    out = _launch_fwd(plan, inputs)
    itscp_hybrid_episode_fwd.launches[plan.mode] += 1
    return out


itscp_hybrid_episode_fwd.launches = {HARD: 0, SOFT: 0, ST: 0}


def itscp_hybrid_episode_bwd(plan: EpisodePlan, q_weight, action2d,
                             schedule, mnext, mprev, rand, inj_routes,
                             emit_routes):
    """``grad[n_phases, n_inter] = sum_t q_weight[t] * d(queues[t]) /
    d(action2d)`` of the soft or straight-through episode.

    CPU tensors go to :func:`plain_episode_bwd`; CUDA tensors launch the
    backward kernel (one launch, one block per action entry) or raise.
    """
    if plan.mode == HARD:
        raise ValueError("the hard episode has no gradient; use a soft or "
                         "st plan")
    inputs = (action2d, schedule, mnext, mprev, rand, inj_routes,
              emit_routes)
    if _device_of(action2d).type == "cpu":
        return plain_episode_bwd(plan, q_weight, *inputs)
    dev = _check_inputs(plan, inputs)
    _check("q_weight", q_weight, (plan.T,), torch.float32, dev)
    lib = _library()
    grad = torch.empty((plan.n_phases, plan.n_inter), dtype=torch.float32,
                       device=dev)
    err = lib.launch_itscp_hybrid_episode_bwd(
        *kernel_args(plan, inputs, (q_weight, grad), _stream(dev)))
    if err != 0:
        raise RuntimeError(f"itscp_hybrid_episode backward launch failed: "
                           f"CUDA error {err}")
    itscp_hybrid_episode_bwd.launches += 1
    return grad


itscp_hybrid_episode_bwd.launches = 0


class FusedEpisodeFunction(torch.autograd.Function):
    """The soft/``st`` episode on the card with its hand-written backward.

    ``apply(action2d, plan, schedule, mnext, mprev, rand, inj_routes,
    emit_routes) -> (reward, queues[T], events[T, 8])``. Only ``action2d``
    gets a gradient; events carry none (as in the JAX kernel's ``ep_bwd``).
    """

    @staticmethod
    def forward(ctx, action2d, plan, *inputs):
        reward, queues, events = itscp_hybrid_episode_fwd(plan, action2d,
                                                          *inputs)
        ctx.plan = plan
        ctx.save_for_backward(action2d, *inputs)
        ctx.mark_non_differentiable(events)
        return reward, queues, events

    @staticmethod
    def backward(ctx, g_reward, g_queues, g_events):
        action2d, *inputs = ctx.saved_tensors
        plan = ctx.plan
        # loss cotangent per queue: reward = -sum(queues)
        w = torch.zeros((plan.T,), dtype=torch.float32,
                        device=action2d.device)
        if g_queues is not None:
            w = w + g_queues
        if g_reward is not None:
            w = w - g_reward
        grad = itscp_hybrid_episode_bwd(plan, w.contiguous(), action2d,
                                        *inputs)
        return (grad, None) + (None,) * len(inputs)


def make_fused_itscp_episode(spec, meta, config, V: int, R: int, P: int,
                             P_emit: int, differentiable: bool = False, *,
                             window: int | None = None):
    """Build the fused episode for a (possibly) hybrid scene.

    Returns ``fn(action2d, schedule[T, L], mnext[T, L], mprev[T, L],
    rand[T, L], inj_routes[L, P, R], emit_routes[L, P_emit, R],
    with_events=False) -> (reward, queues[T])`` (plus ``events[T, 8]`` with
    ``with_events``), starting from the empty network state. Event rows:
    injected, emitted, absorbed, transferred, transfer wins, deposit wins,
    removals, max wave speed. ``window`` bounds the leader walk (at least
    :func:`leader_window` of every route pool; default ``R - 1``).

    ``differentiable`` runs the gates of ``config["gate_mode"]`` (``soft``
    or ``st``, sharpened by ``soft_gate_scale``) and makes ``reward`` and
    ``queues`` differentiable in ``action2d``: on the card through
    :class:`FusedEpisodeFunction` (the kernel's forward and backward), on
    the CPU through autograd of the plain version.
    """
    plan = make_plan(spec, meta, config, V, R, P, P_emit, window,
                     differentiable)

    def fn(action2d, schedule, mnext, mprev, rand, inj_routes, emit_routes,
           with_events: bool = False):
        inputs = (schedule, mnext, mprev, rand, inj_routes, emit_routes)
        action2d = action2d.contiguous()
        if not differentiable:
            out = itscp_hybrid_episode_fwd(plan, action2d, *inputs)
        elif _device_of(action2d).type == "cpu":
            out = plain_episode(plan, action2d, *inputs)
        else:
            out = FusedEpisodeFunction.apply(action2d, plan, *inputs)
        return out if with_events else out[:2]

    fn.plan = plan
    return fn
