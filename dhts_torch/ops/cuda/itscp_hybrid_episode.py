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
* :func:`make_plan` picks how a scene runs (:func:`choose_layout`): one
  lane a thread with the state in shared memory where one block holds it
  (the 3x3 grid, the 5x5 grid's forward), else the state's per-lane arrays
  in a workspace in global memory (the 5x5 grid's backward, the 7x7 and
  9x9 grids) and, past 1,024 threads, two lanes a thread (9x9). On the
  card the library decides what fits from its kernels' attributes; the
  plan records the choice (``lanes_per_thread``, ``placement``); a scene
  that no layout takes raises, naming its sizes.
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

Every entry point takes B episodes per call (the JAX kernel's
``episodes=B`` and its vmapped configurations): an input with a leading
episode axis gives each episode its row, an input without it is shared
(:func:`episode_count`). On the card one launch runs them all, one block
per episode forward and one per episode and action entry backward; the
plain versions loop over the episodes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dhts_torch.models.vehicle import default_params
from dhts_torch.ops.cuda._launch import check as _check
from dhts_torch.ops.cuda._launch import device_of as _device_of
from dhts_torch.ops.cuda._launch import raise_on as _raise_on
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


def lane_layout(is_macro, lanes_per_thread: int = 1) -> np.ndarray:
    """K1's lane threads: the lane each thread runs, the macro lanes first
    and then the micro lanes, each group padded with -1 (an idle thread)
    to whole warps of 32, so that no warp runs both kinds of lane. With
    ``lanes_per_thread`` k, thread i of ``n = ceil(warps / k) * 32`` runs
    the lanes at i, n + i, ... (rows of ``[k, n]``, flattened, -1 past the
    end): each row of a thread warp is one warp of the list above."""
    is_macro = np.asarray(is_macro).astype(bool)
    out = []
    for group in (np.flatnonzero(is_macro), np.flatnonzero(~is_macro)):
        out += [*group.tolist(), *[-1] * (-len(group) % 32)]
    k = int(lanes_per_thread)
    n = -(-len(out) // 32 // k) * 32 if out else 0
    out += [-1] * (k * n - len(out))
    return np.asarray(out, dtype=np.int32)


# Where a block keeps its state: "shared" (every array in shared memory, one
# lane a thread) or "global" (the arrays of C, V or K entries a lane in a
# workspace in global memory, the per-lane summaries in shared memory)
PLACEMENTS = ("shared", "global")
MAX_THREADS = 1024  # threads a block
MAX_LANES_PER_THREAD = 2
# A CPU plan's record of the layout a card would take (on the card the
# library chooses it from its kernels' attributes): an H100 block's opt-in
# shared memory
H100_SMEM_PER_BLOCK = 232448
# smem_bytes' arrays in csrc/itscp_hybrid_episode.cu, as (entries, element
# bytes, arrays): entries "C", "V" or "K" a lane, 1 or 2 a lane, or "parts"
# (the warps' partial sums, 3 x 32); element bytes 0 for the scalar (float
# forward, Dual backward). The state's arrays go to the workspace in the
# global placement, the summaries' stay in shared memory.
_STATE = (("C", 0, 2), ("V", 0, 3), ("K", 0, 1), ("V", 4, 2))
_SUMMARIES = ((1, 0, 10), (2, 0, 1), (2, 4, 2), (2, 8, 1), (2, 4, 1),
              ("parts", 8, 1), ("parts", 4, 1), (1, 4, 10))


def block_bytes(L: int, C: int, V: int, K: int, tangent: bool,
                placement: str) -> tuple[int, int]:
    """``(shared memory, workspace)`` bytes of one block of the forward
    (``tangent`` False) or the backward at these sizes, each array rounded
    up to 16 bytes; the workspace is 0 in shared memory. The library's
    ``itscp_hybrid_episode_smem_at`` reckons the same; this copy serves a
    CPU plan, which has no library."""
    entries = {"C": L * C, "V": L * V, "K": L * K, 1: L, 2: 2 * L,
               "parts": 3 * 32}
    scalar = 8 if tangent else 4

    def total(arrays):
        return sum(n * -(-entries[e] * (size or scalar) // 16) * 16
                   for e, size, n in arrays)

    state, summaries = total(_STATE), total(_SUMMARIES)
    if placement == "shared":
        return state + summaries, 0
    return summaries, state


class Layout(NamedTuple):
    """How K1 runs a scene: lanes a thread (0: more than the kernel takes)
    and the placement of the forward's and the backward's state (None: no
    placement fits)."""

    lanes_per_thread: int
    placement: tuple  # (forward, backward): "shared", "global" or None


def choose_layout(is_macro, C: int, V: int, K: int, device=None,
                  lanes_per_thread: int | None = None) -> Layout:
    """The fewest lanes a thread whose lane threads and reduction warp make
    at most 1,024 threads (or ``lanes_per_thread``), and for each direction
    the state in shared memory where one lane a thread allows it and the
    block fits, else in global memory where that block fits. On a CUDA
    ``device`` the library decides what fits from its kernels' attributes
    (their registers' threads a block) and the device's opt-in shared
    memory (``itscp_hybrid_episode_placement``); elsewhere the plan records
    what an H100 block's shared memory holds."""
    L = len(np.asarray(is_macro))
    lpt = lanes_per_thread or next(
        (k for k in range(1, MAX_LANES_PER_THREAD + 1)
         if len(lane_layout(is_macro, k)) // k + 32 <= MAX_THREADS), 0)
    if not lpt:
        return Layout(0, (None, None))
    lane_threads = len(lane_layout(is_macro, lpt)) // lpt
    if device is not None and torch.device(device).type == "cuda":
        lib = _library()
        return Layout(lpt, tuple(
            PLACEMENTS[c] if c >= 0 else None for c in (
                lib.itscp_hybrid_episode_placement(L, C, V, K, tangent,
                                                   lane_threads, lpt)
                for tangent in (0, 1))))
    placement = []
    for tangent in (False, True):
        fit = [p for p in PLACEMENTS if (lpt == 1 or p == "global") and
               block_bytes(L, C, V, K, tangent, p)[0] <= H100_SMEM_PER_BLOCK]
        placement.append(fit[0] if fit else None)
    return Layout(lpt, tuple(placement))


class EpisodePlan(NamedTuple):
    """Static inputs of one scene: the geometry tables the kernel reads,
    the sizes and constants, and the scene itself for the plain version."""

    spec: object  # dhts_torch.models.scene.SceneSpec
    meta: object  # dhts_torch.apps.control.itscp.env.LaneMeta
    config: dict
    lane_i: torch.Tensor  # i32[8 + 2K, L]
    lane_f: torch.Tensor  # f32[2, L]
    lane_perm: torch.Tensor  # i32[lane threads], lane_layout
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
    # choose_layout's, unless make_plan was told otherwise; lane_perm is
    # lane_layout at lanes_per_thread
    lanes_per_thread: int = 1
    placement: tuple = ("shared", "shared")  # (forward, backward)


def make_plan(spec, meta, config, V: int, R: int, P: int, P_emit: int,
              window: int | None = None, differentiable: bool = False,
              lanes_per_thread: int | None = None,
              placement: tuple | None = None) -> EpisodePlan:
    """The plan of a scene. ``lanes_per_thread`` and ``placement`` (the
    forward's and the backward's, each "shared" or "global") replace
    :func:`choose_layout`'s choice where given (tests force a layout
    through them)."""
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
    is_macro = spec.is_macro.cpu().numpy()
    if not 0 <= (lanes_per_thread or 0) <= MAX_LANES_PER_THREAD:
        raise ValueError(f"no such layout: {lanes_per_thread} lanes a "
                         "thread")
    layout = choose_layout(is_macro, C, int(V), K, dev, lanes_per_thread)
    lpt = layout.lanes_per_thread
    placement = tuple(placement or layout.placement)
    if any(p not in (*PLACEMENTS, None) or (p == "shared" and lpt != 1)
           for p in placement):
        raise ValueError(f"no such layout: {lpt} lanes a thread, "
                         f"placement {placement} (shared memory takes one "
                         "lane a thread)")
    lane_perm = torch.as_tensor(lane_layout(is_macro, max(lpt, 1)),
                                device=dev)
    return EpisodePlan(
        spec=spec, meta=meta, config=dict(config), lane_i=lane_i,
        lane_f=lane_f, lane_perm=lane_perm,
        prog=torch.as_tensor(signal_progress_table(nsf), device=dev),
        T=T, L=L, C=C, V=int(V), R=int(R), P=int(P), P2=int(P_emit), K=K,
        W=W, nsf=nsf, n_phases=n_phases, n_inter=n_inter, mode=mode,
        floats=floats, lanes_per_thread=lpt, placement=placement)


def check_layout(plan: EpisodePlan, tangent: bool) -> str:
    """The placement of the forward's (``tangent`` False) or the
    backward's state; raises, naming the scene's sizes, where the kernel
    cannot take the scene."""
    where = plan.placement[int(tangent)]
    if plan.lanes_per_thread and where is not None:
        return where
    slots = len(lane_layout(plan.spec.is_macro.cpu().numpy()))
    need = {p: block_bytes(plan.L, plan.C, plan.V, plan.K, tangent, p)[0]
            for p in PLACEMENTS}
    raise ValueError(
        f"K1's {'backward' if tangent else 'forward'} cannot take this "
        f"scene: L = {plan.L} lanes ({slots} lane slots in warps of one "
        f"kind), C = {plan.C}, V = {plan.V}, K = {plan.K}; it takes at most "
        f"{MAX_LANES_PER_THREAD} lanes a thread and {MAX_THREADS} threads, "
        f"and a block's shared memory ({H100_SMEM_PER_BLOCK} bytes on an "
        f"H100), where this scene needs {need['shared']} bytes (state in "
        f"shared memory) or {need['global']} (state in global memory)")


EPISODE_INPUTS = ("action2d", "schedule", "mnext", "mprev", "rand",
                  "inj_routes", "emit_routes")


def _rows(plan: EpisodePlan) -> tuple:
    """Each episode input's shape and dtype for one episode, in the order
    of :data:`EPISODE_INPUTS`."""
    T, L, R = plan.T, plan.L, plan.R
    f32, i32 = torch.float32, torch.int32
    return (((plan.n_phases, plan.n_inter), f32), ((T, L), f32),
            ((T, L), i32), ((T, L), i32), ((T, L), f32),
            ((L, plan.P, R), i32), ((L, plan.P2, R), i32))


# one episode's dimensions of each input, in the order of EPISODE_INPUTS
_NDIMS = (2, 2, 2, 2, 2, 3, 3)


def episode_count(inputs, q_weight=None) -> int | None:
    """The number of episodes of a call: the leading size of the inputs that
    have an episode axis (one dimension more than one episode's shape; the
    others are shared by every episode), or None when none has one (one
    episode, today's shapes). ``q_weight`` (the backward's ``[T]`` or
    ``[B, T]``) counts as an input."""
    sizes = {int(x.shape[0]) for x, n in zip(inputs, _NDIMS)
             if x.dim() == n + 1}
    if q_weight is not None and q_weight.dim() == 2:
        sizes.add(int(q_weight.shape[0]))
    if len(sizes) > 1:
        raise ValueError(f"the inputs' episode axes disagree: {sorted(sizes)}")
    return sizes.pop() if sizes else None


def _episode(x, shape, e: int):
    """Episode ``e``'s row of an input (the input itself when shared)."""
    return x[e] if x.dim() == len(shape) + 1 else x


def plain_episode(plan: EpisodePlan, action2d, schedule, mnext, mprev, rand,
                  inj_routes, emit_routes):
    """Plain PyTorch version of the forward in ``plan.mode``: ``(-qsum,
    queues[T], events[T, 8])`` on the inputs' device, differentiable by
    autograd in the soft modes. With an episode axis on any input (see
    :func:`episode_count`) it runs the episodes one after another and
    returns ``(reward[B], queues[B, T], events[B, T, 8])``."""
    from dhts_torch.apps.control.itscp import env as env_mod
    from dhts_torch.models import network

    inputs = (action2d, schedule, mnext, mprev, rand, inj_routes,
              emit_routes)
    B = episode_count(inputs)
    if B is not None:
        rows = _rows(plan)
        outs = [plain_episode(plan, *(_episode(x, shape, e) for x, (shape, _)
                                      in zip(inputs, rows)))
                for e in range(B)]
        return tuple(torch.stack(x) for x in zip(*outs))
    run = env_mod._make_episode_fn(plan.spec, plan.meta, plan.config,
                                   plan.mode != HARD).run
    state0 = network.empty_state(plan.spec, plan.V, plan.R, emit_routes)
    data = env_mod.EpisodeData(schedule=schedule, mroute_next=mnext,
                               mroute_prev=mprev, inj_routes=inj_routes)
    queues, events = run(action2d, data, state0, rand)
    return -torch.sum(queues), queues, events


def plain_episode_bwd(plan: EpisodePlan, q_weight, action2d, *inputs):
    """Plain PyTorch version of the backward: ``sum_t q_weight[t] *
    d(queues[t])/d(action2d)`` by autograd through :func:`plain_episode`;
    with an episode axis, each episode's ``sum_t q_weight[e, t] *
    d(queues[e, t])/d(action2d[e])``, ``[B, n_phases, n_inter]`` (a shared
    action gets each episode's gradient in its row)."""
    B = episode_count((action2d, *inputs), q_weight)
    if B is not None:
        rows = _rows(plan)
        return torch.stack([plain_episode_bwd(
            plan, q_weight[e] if q_weight.dim() == 2 else q_weight,
            *(_episode(x, shape, e) for x, (shape, _) in
              zip((action2d, *inputs), rows))) for e in range(B)])
    with torch.enable_grad():
        a = action2d.detach().requires_grad_(True)
        _, queues, _ = plain_episode(plan, a, *inputs)
        (grad,) = torch.autograd.grad(torch.sum(queues * q_weight), a)
    return grad


_PTRS_FWD, _PTRS_BWD = 14, 13  # pointer arguments of the two launchers
# the episode count and the eight episode strides, the sizes, gate mode and
# lane threads, the constants, the stream; lanes a thread, placement and
# workspace
_TAIL = ([ctypes.c_int] + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 14 +
         [ctypes.c_float] * 13 + [ctypes.c_void_p] +
         [ctypes.c_int] * 2 + [ctypes.c_void_p])
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
    lib.itscp_hybrid_episode_smem_at.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_size_t)]
    lib.itscp_hybrid_episode_smem_at.restype = ctypes.c_size_t
    lib.itscp_hybrid_episode_placement.argtypes = [ctypes.c_int] * 7
    lib.itscp_hybrid_episode_placement.restype = ctypes.c_int
    lib.itscp_hybrid_episode_blocks_per_sm.argtypes = [ctypes.c_int] * 6
    lib.itscp_hybrid_episode_blocks_per_sm.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    from dhts_torch.ops.cuda import _build

    lib = _build.load("itscp_hybrid_episode")
    if lib.launch_itscp_hybrid_episode_fwd.argtypes is None:
        bind(lib)
    return lib


class _Buffer:
    """A tensor passed to a C launcher as its address (``ctypes`` takes
    ``_as_parameter_``): the argument tuple keeps the tensor alive for the
    call. None passes a null pointer."""

    def __init__(self, x):
        self.tensor = x
        self._as_parameter_ = ctypes.c_void_p(
            None if x is None else x.data_ptr())


def kernel_args(plan: EpisodePlan, inputs, outputs, stream, B: int = 1,
                strides=(0,) * 8, lib=None) -> tuple:
    """A C launcher's arguments: the seven inputs of the episode, the plan's
    tables (``lane_perm`` last) and the outputs as pointers, then the
    episode count ``B`` and each input's stride between episodes in
    elements (:func:`episode_rows`; 0: shared, the backward's ``q_weight``
    last), the plan's sizes, gate mode and lane threads, constants and
    ``stream``, then its lanes a thread, the direction's placement (0
    shared, 1 global) and the workspace: ``B`` (times ``n_phases *
    n_inter`` backward) blocks of the bytes that ``lib`` (default: the
    card's build) reckons a block (``itscp_hybrid_episode_smem_at``),
    allocated here on the inputs' device (None in shared memory). The
    forward's outputs are ``(reward[B], queues[B, T], events[B, T, 8])``,
    the backward's ``(q_weight, grad[B, n_phases, n_inter])``."""
    tangent = len(outputs) == 2
    where = check_layout(plan, tangent)
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in
            (*inputs, plan.prog, plan.lane_i, plan.lane_f, plan.lane_perm,
             *outputs)]
    lpt = plan.lanes_per_thread
    ints = (plan.T, plan.L, plan.C, plan.V, plan.R, plan.P, plan.P2, plan.K,
            plan.W, plan.nsf, plan.n_phases, plan.n_inter, plan.mode,
            plan.lane_perm.numel() // lpt)
    workspace = None
    if where == "global":
        blocks = int(B) * (plan.n_phases * plan.n_inter if tangent else 1)
        nbytes = ctypes.c_size_t()
        (lib or _library()).itscp_hybrid_episode_smem_at(
            plan.L, plan.C, plan.V, plan.K, int(tangent),
            PLACEMENTS.index(where), ctypes.byref(nbytes))
        workspace = torch.empty(blocks * nbytes.value, dtype=torch.uint8,
                                device=inputs[0].device)
    return (*ptrs, int(B), *(int(x) for x in strides), *ints, *plan.floats,
            ctypes.c_void_p(stream), lpt, PLACEMENTS.index(where),
            _Buffer(workspace))


def episode_rows(plan: EpisodePlan, inputs, B: int | None):
    """The tensors a launch of ``B`` episodes passes and their strides: an
    input with an episode axis goes as it is (stride: one episode's
    elements), unless it is a broadcast (``expand``, stride 0 on that axis:
    its first row goes, stride 0); a shared input goes as it is, stride 0.
    Every tensor is checked for shape, dtype, device and contiguity."""
    dev = inputs[0].device
    tensors, strides = [], []
    for x, name, (shape, dtype) in zip(inputs, EPISODE_INPUTS, _rows(plan)):
        batched = B is not None and x.dim() == len(shape) + 1
        if batched and x.stride(0) == 0:
            x, batched = x[0], False
        if batched:
            _check(name, x, (B, *shape), dtype, dev)
        else:
            _check(name, x, shape, dtype, dev)
        tensors.append(x)
        strides.append(int(np.prod(shape)) if batched else 0)
    for name in ("lane_i", "lane_f", "lane_perm", "prog"):
        if getattr(plan, name).device != dev:
            raise ValueError(f"plan.{name} is on "
                             f"{getattr(plan, name).device}, expected {dev}")
    return tensors, strides


def _launch_fwd(plan: EpisodePlan, inputs, B: int | None):
    tensors, strides = episode_rows(plan, inputs, B)
    dev = tensors[0].device
    lib = _library()
    lead = () if B is None else (B,)
    reward = torch.empty(lead, dtype=torch.float32, device=dev)
    queues = torch.empty((*lead, plan.T), dtype=torch.float32, device=dev)
    events = torch.empty((*lead, plan.T, 8), dtype=torch.float32, device=dev)
    _raise_on(lib.launch_itscp_hybrid_episode_fwd(*kernel_args(
        plan, tensors, (reward, queues, events), _stream(dev), B or 1,
        (*strides, 0))), "itscp_hybrid_episode forward")
    return reward, queues, events


def itscp_hybrid_episode_fwd(plan: EpisodePlan, action2d, schedule, mnext,
                             mprev, rand, inj_routes, emit_routes):
    """``(-qsum, queues[T], events[T, 8])`` of one episode in ``plan.mode``
    (hard, soft or straight-through), without a graph for autograd (that is
    :class:`FusedEpisodeFunction`). With an episode axis on any input
    (:func:`episode_count`), B episodes in one launch: ``(reward[B],
    queues[B, T], events[B, T, 8])``.

    CPU tensors go to :func:`plain_episode`; CUDA tensors launch the kernel
    (one launch per call whatever B is, counted in ``launches[plan.mode]``)
    or raise.
    """
    inputs = (action2d, schedule, mnext, mprev, rand, inj_routes,
              emit_routes)
    if _device_of(action2d).type == "cpu":
        return plain_episode(plan, *inputs)
    out = _launch_fwd(plan, inputs, episode_count(inputs))
    itscp_hybrid_episode_fwd.launches[plan.mode] += 1
    return out


itscp_hybrid_episode_fwd.launches = {HARD: 0, SOFT: 0, ST: 0}


def itscp_hybrid_episode_bwd(plan: EpisodePlan, q_weight, action2d,
                             schedule, mnext, mprev, rand, inj_routes,
                             emit_routes):
    """``grad[n_phases, n_inter] = sum_t q_weight[t] * d(queues[t]) /
    d(action2d)`` of the soft or straight-through episode; with an episode
    axis (on any input or ``q_weight[B, T]``), each episode's gradient with
    respect to its action, ``[B, n_phases, n_inter]``.

    CPU tensors go to :func:`plain_episode_bwd`; CUDA tensors launch the
    backward kernel (one launch, one block per episode and action entry)
    or raise.
    """
    if plan.mode == HARD:
        raise ValueError("the hard episode has no gradient; use a soft or "
                         "st plan")
    inputs = (action2d, schedule, mnext, mprev, rand, inj_routes,
              emit_routes)
    if _device_of(action2d).type == "cpu":
        return plain_episode_bwd(plan, q_weight, *inputs)
    B = episode_count(inputs, q_weight)
    tensors, strides = episode_rows(plan, inputs, B)
    dev = tensors[0].device
    qw_rows = q_weight.dim() == 2  # one row of loss weights per episode
    _check("q_weight", q_weight, (B, plan.T) if qw_rows else (plan.T,),
           torch.float32, dev)
    lib = _library()
    lead = () if B is None else (B,)
    grad = torch.empty((*lead, plan.n_phases, plan.n_inter),
                       dtype=torch.float32, device=dev)
    _raise_on(lib.launch_itscp_hybrid_episode_bwd(*kernel_args(
        plan, tensors, (q_weight, grad), _stream(dev), B or 1,
        (*strides, plan.T if qw_rows else 0))),
              "itscp_hybrid_episode backward")
    itscp_hybrid_episode_bwd.launches += 1
    return grad


itscp_hybrid_episode_bwd.launches = 0


class FusedEpisodeFunction(torch.autograd.Function):
    """The soft/``st`` episode on the card with its hand-written backward.

    ``apply(action2d, plan, schedule, mnext, mprev, rand, inj_routes,
    emit_routes) -> (reward, queues[T], events[T, 8])``; with an episode
    axis, ``(reward[B], queues[B, T], events[B, T, 8])`` from one forward
    launch and a ``[B, n_phases, n_inter]`` gradient from one backward
    launch. A caller whose episodes share one action passes it expanded to
    ``[B, n_phases, n_inter]`` (stride 0, sent once), so that autograd sums
    the episodes' gradients. Only ``action2d`` gets a gradient; events
    carry none (as in the JAX kernel's ``ep_bwd``).
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
        B = episode_count((action2d, *inputs))
        # loss cotangent per queue: reward = -sum(queues)
        lead = () if B is None else (B,)
        w = torch.zeros((*lead, plan.T), dtype=torch.float32,
                        device=action2d.device)
        if g_queues is not None:
            w = w + g_queues
        if g_reward is not None:
            w = w - g_reward.unsqueeze(-1)
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

    B episodes run in one launch (the JAX kernel's ``episodes=B`` and its
    vmapped configurations): an input with a leading episode axis
    (``action2d[B, n_phases, n_inter]``, ``rand[B, T, L]``, ``schedule[B,
    T, L]``, ...) gives each episode its row, an input without it is shared
    by every episode, and the outputs gain the leading B; a call without
    any episode axis is one episode with the shapes above.

    ``differentiable`` runs the gates of ``config["gate_mode"]`` (``soft``
    or ``st``, sharpened by ``soft_gate_scale``) and makes ``reward`` and
    ``queues`` differentiable in ``action2d``: on the card through
    :class:`FusedEpisodeFunction` (the kernel's forward and backward, one
    launch each for all B episodes), on the CPU through autograd of the
    plain version.
    """
    plan = make_plan(spec, meta, config, V, R, P, P_emit, window,
                     differentiable)
    if plan.lane_i.device.type != "cpu":  # no fallback: a scene K1 takes
        check_layout(plan, False)
        if differentiable:
            check_layout(plan, True)

    def fn(action2d, schedule, mnext, mprev, rand, inj_routes, emit_routes,
           with_events: bool = False):
        inputs = (schedule, mnext, mprev, rand, inj_routes, emit_routes)
        B = episode_count((action2d, *inputs))
        if B is not None and action2d.dim() == 2:
            # a shared action: autograd sums the episodes' gradients
            action2d = action2d.expand(B, *action2d.shape)
        if B is None or action2d.stride(0) != 0:  # not a broadcast
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
