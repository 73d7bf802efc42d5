"""Fused ITSCP hybrid episode (kernel K1's forward), hard mode.

Port of :mod:`dhts.ops.pallas.itscp_hybrid_episode`: a whole ITSCP episode
of a hybrid, micro or macro scene from the empty network state, returning
``(-sum(queues), queues[T], events[T, 8])``.

* :func:`itscp_hybrid_episode_fwd` is the wrapper. On CUDA tensors it
  launches the hand-written kernel ``csrc/itscp_hybrid_episode.cu`` (built
  with ``nvcc`` by :mod:`dhts_torch.ops.cuda._build`, bound with
  ``ctypes``) and counts the launch in ``itscp_hybrid_episode_fwd.launches``;
  on CPU tensors it calls :func:`plain_episode`. There is no fallback from
  the card to the plain version.
* :func:`plain_episode` is the plain PyTorch version: the eager
  ``boundary_and_step`` of :mod:`dhts_torch.apps.control.itscp.env` in a
  Python loop over T, each step vectorised over lanes, cells and vehicles.
  It is the kernel's specification, op for op.

The kernel is hard mode only; the soft and straight-through gate forward
and the backward of K1 are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dhts_torch.models.vehicle import default_params

KERNEL_NAME = "itscp_hybrid_episode_fwd"
SOURCE = "dhts_torch/ops/cuda/csrc/itscp_hybrid_episode.cu"
REPLACES = "dhts/ops/pallas/itscp_hybrid_episode.py:2130"
GAMMA = 0.5


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
    floats: tuple  # the kernel's float arguments, in order


def make_plan(spec, meta, config, V: int, R: int, P: int, P_emit: int,
              window: int | None = None) -> EpisodePlan:
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
              float(dflt.time_pref), f32(1.0 - 1e-5))
    return EpisodePlan(
        spec=spec, meta=meta, config=dict(config), lane_i=lane_i,
        lane_f=lane_f,
        prog=torch.as_tensor(signal_progress_table(nsf), device=dev),
        T=T, L=L, C=C, V=int(V), R=int(R), P=int(P), P2=int(P_emit), K=K,
        W=W, nsf=nsf, n_phases=n_phases, n_inter=n_inter, floats=floats)


def plain_episode(plan: EpisodePlan, action2d, schedule, mnext, mprev, rand,
                  inj_routes, emit_routes):
    """Plain PyTorch version of the kernel: ``(-qsum, queues[T],
    events[T, 8])`` on the inputs' device."""
    from dhts_torch.apps.control.itscp import env as env_mod
    from dhts_torch.models import network

    run = env_mod._make_episode_fn(plan.spec, plan.meta, plan.config,
                                   False).run
    state0 = network.empty_state(plan.spec, plan.V, plan.R, emit_routes)
    data = env_mod.EpisodeData(schedule=schedule, mroute_next=mnext,
                               mroute_prev=mprev, inj_routes=inj_routes)
    queues, events = run(action2d, data, state0, rand)
    return -torch.sum(queues), queues, events


_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 12 +
             [ctypes.c_float] * 12 + [ctypes.c_void_p])


def _library():
    from dhts_torch.ops.cuda import _build

    lib = _build.load("itscp_hybrid_episode")
    fn = lib.launch_itscp_hybrid_episode_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, shape, dtype, dev):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x)}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def kernel_args(plan: EpisodePlan, inputs, outputs, stream) -> tuple:
    """The C launcher's arguments: the seven inputs and three outputs of
    the episode as pointers, then the plan's sizes and constants."""
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in
            (*inputs, plan.prog, plan.lane_i, plan.lane_f, *outputs)]
    ints = (plan.T, plan.L, plan.C, plan.V, plan.R, plan.P, plan.P2, plan.K,
            plan.W, plan.nsf, plan.n_phases, plan.n_inter)
    return (*ptrs, *ints, *plan.floats, ctypes.c_void_p(stream))


def itscp_hybrid_episode_fwd(plan: EpisodePlan, action2d, schedule, mnext,
                             mprev, rand, inj_routes, emit_routes):
    """``(-qsum, queues[T], events[T, 8])`` of one hard-mode episode.

    CPU tensors go to :func:`plain_episode`; CUDA tensors launch the kernel
    (one launch per episode) or raise.
    """
    dev = action2d.device
    if dev.type == "cpu":
        return plain_episode(plan, action2d, schedule, mnext, mprev, rand,
                             inj_routes, emit_routes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    T, L, R = plan.T, plan.L, plan.R
    _check("action2d", action2d, (plan.n_phases, plan.n_inter),
           torch.float32, dev)
    _check("schedule", schedule, (T, L), torch.float32, dev)
    _check("mnext", mnext, (T, L), torch.int32, dev)
    _check("mprev", mprev, (T, L), torch.int32, dev)
    _check("rand", rand, (T, L), torch.float32, dev)
    _check("inj_routes", inj_routes, (L, plan.P, R), torch.int32, dev)
    _check("emit_routes", emit_routes, (L, plan.P2, R), torch.int32, dev)
    for name in ("lane_i", "lane_f", "prog"):
        if getattr(plan, name).device != dev:
            raise ValueError(f"plan.{name} is on "
                             f"{getattr(plan, name).device}, expected {dev}")
    launch = _library()
    reward = torch.empty((), dtype=torch.float32, device=dev)
    queues = torch.empty((T,), dtype=torch.float32, device=dev)
    events = torch.empty((T, 8), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(*kernel_args(plan, (action2d, schedule, mnext, mprev, rand,
                                     inj_routes, emit_routes),
                              (reward, queues, events), stream))
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: CUDA error {err}")
    itscp_hybrid_episode_fwd.launches += 1
    return reward, queues, events


itscp_hybrid_episode_fwd.launches = 0


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
    """
    if differentiable:
        raise NotImplementedError(
            "the differentiable fused episode needs K1's soft-gate forward "
            "and backward, which come with the training part of the port "
            "and are not ported yet; use use_fused_episode=False for the "
            "eager differentiable episode")
    plan = make_plan(spec, meta, config, V, R, P, P_emit, window)

    def fn(action2d, schedule, mnext, mprev, rand, inj_routes, emit_routes,
           with_events: bool = False):
        reward, queues, events = itscp_hybrid_episode_fwd(
            plan, action2d.contiguous(), schedule, mnext, mprev, rand,
            inj_routes, emit_routes)
        return (reward, queues, events) if with_events else (reward, queues)

    fn.plan = plan
    return fn
